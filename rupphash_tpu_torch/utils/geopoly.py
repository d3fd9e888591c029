"""Point-in-polygon admin-1 lookup (reference: exif_extract.rs:435-474).

The reference resolves Country/Subdivision through the
`country-boundaries` polygon database.  This image has zero egress and
ships no boundary dataset (no Natural Earth, no cartopy/geopandas), so
a worldwide polygon DB is unobtainable here; this module provides the
same *mechanism* — quantized polygon rings behind a coarse grid index,
consulted before the nearest-anchor tables (utils/geonames.py) — and
populates it with hand-authored polygons for subdivisions whose legal
borders are (mostly) straight lat/lon lines, where a few vertices are
EXACT along the contested border:

  * US interior states (WY/CO/UT/NM/AZ/KS/NE/ND/SD/MT/OK) plus Nevada
    and Idaho (round 4) — meridian/parallel borders and Nevada's 1861
    oblique line exact; river/divide segments approximated with a
    documented envelope; round 4c adds Minnesota (49N / NW-Angle
    meridian / Iowa 43.5N / SD meridian exact, the Red River and
    Rainy River polylines within ~1-2 km — shared verbatim with a
    river-accurate North Dakota east edge and the corrected South
    Dakota Traverse/Big Stone chain; the east side conservative);
    round 4b adds California / Oregon / Washington / Texas
    (42N, 49N, 46N, 36.5N, 32N, 120W, -117.026, -117.04, -103.042,
    -100.0, -94.043 and the CA/NV oblique and CA/Mexico straight
    lines exact; the Colorado River CA/AZ border is one polyline
    shared verbatim by both rings; the Rio Grande, lower-Columbia and
    Snake polylines track the channel within ~2 km so river twin
    towns split correctly — anchors provably misassign them; Red and
    Sabine approximated; the WA marine boundary threads Juan de
    Fuca / Haro Strait / Boundary Pass along the midline so
    Victoria/Sidney/Gulf Islands stay Canadian while Neah Bay, the
    San Juans and Point Roberts stay inside);
  * Australian states — all land borders exact save the NSW/QLD east
    tail and the Murray River (segment-approximated);
  * Canadian prairie provinces (AB/SK/MB) — 49/60 parallels and 110/120
    meridians exact, staircase/divide approximated — and (round 4) the
    territories (YT/NT/NU): 60N south borders and 141W exact, the
    inter-territory divide lines conservative on BOTH sides (each ring
    stays inside the believed line, a dead strip falls to anchors);
  * round-4 COUNTRY-level rings (subdivision None) along the great
    meridian/parallel treaty borders: Egypt/Libya/Sudan (25E, 22N),
    Namibia/Botswana (20E, 21E, 22S jog, the ~17.39S Angola straight),
    Indonesia/Papua New Guinea (141E), and Argentina's Chubut/Santa
    Cruz provinces (42S/46S/52S) as named admin-1 rings;
  * round 4d adds Pennsylvania (42N, Mason-Dixon 39.7222N, the
    Ellicott meridian -80.5194 and the NY west line -79.762 exact; the
    Delaware River within ~1-2 km splitting the PA/NJ/NY twin cities;
    the PA/DE Twelve-Mile-Circle arc approximated by inside chords)
    and Illinois (statutory 42.5N and the Indiana meridian -87.5246
    exact-class; Mississippi/Ohio/Wabash polylines within ~2 km
    splitting Rock Island/Davenport, East St. Louis/St. Louis,
    Quincy/Hannibal, Hamilton/Keokuk, Metropolis/Paducah and the
    Wabash bank towns), then Indiana and Ohio completing the block:
    the Michigan parallel 41.7597, the First Principal Meridian
    -84.8029 and the Harris (Toledo) line exact-class, the shared
    _WABASH edge verbatim with Illinois and the -80.5194 meridian
    with Pennsylvania; the Ohio River polyline splits the
    Louisville/Cincinnati/Wheeling/Huntington-area twin cities and
    the Lake Erie edge threads south of the Canadian islands
    (Middle/Pelee out, the US Bass islands and Kelleys in); round 4e
    adds Kentucky and Tennessee: Kentucky's whole north border is the
    three shared Ohio River lists verbatim, the KY/TN border is the
    shared _KY_TN list carrying the surveyed WALKER LINE (~36.62-36.64
    east of the Tennessee River — the 1779-80 survey error the 36.5
    charter never fixed — so Clarksville stays Tennessee and Guthrie
    stays Kentucky, something a naive 36.5 line gets wrong on both
    banks) with the Tennessee River jog to the true 36.4977 Jackson
    Purchase parallel; Tennessee adds the Bristol State Street line
    36.5951 (VA), the surveyed ~34.995 south line (East Ridge TN in,
    Rossville GA out) and the Mississippi channel at Memphis; the
    Appalachian VA/WV/NC sides are conservative chains inside the
    ring.  The corridor batch then adds Iowa and Missouri and makes
    every Missouri/Mississippi/Big Sioux river border a shared channel
    list — fixing pre-existing defects the densified overlap sweeps
    exposed: Nebraska's straight-chord east edge claimed Council
    Bluffs IA, the Kansas chord claimed Elwood/Wathena KS, South
    Dakota's conservative edge lost Yankton, the Tennessee flat-36.4977
    edge overlapped Missouri's New Madrid dip, Oklahoma's NE diagonal
    crossed into Missouri, and the CO/NE/KS/WY meridians disagreed by
    up to 0.008 deg (overlap slivers) — all now coincident
    (-102.0517, -104.0526, shared vertex runs; 30k-point CONUS sweep
    clean).  The Sullivan IA/MO line is the surveyed irregular
    ~40.588-40.576 polyline; the bootheel drops to 36.0 between the
    Mississippi and the St. Francis River.  Wisconsin and Michigan
    finish the Great Lakes: shared _WI_MI land border (Montreal/Brule/
    Menominee with the Niagara-Norway bend) and _GREEN_BAY water line
    (north of Washington Island), the WI west edge channel-accurate
    against Minnesota's conservative strip (La Crosse/Hudson/Superior
    vs La Crescent/Stillwater/Duluth, the Lake Pepin midline), and
    Michigan as ONE ring wrapping both peninsulas through the Straits
    of Mackinac (the connecting water is Michigan) — Detroit/
    St. Clair/St. Marys channels split the Ontario twins, the
    False Detour and Sugar/Neebish channels wrap Drummond Island, and
    offshore envelopes enclose the Keweenaw, Isle Royale (south of
    the Canada line), the Apostles and Beaver Island.  Round 4f adds
    Virginia and West Virginia: the Mason-Dixon 39.7222 / Ellicott
    -80.5194 / Fairfax Stone corners exact and coincident with
    Pennsylvania, the Ohio River OH/WV frontage a shared channel list
    (densifying the northern-panhandle hairpin — the old straight
    chord misassigned Chester/Newell WV and Mingo Junction/Brilliant
    OH), the Tug Fork/Big Sandy shared verbatim with Kentucky, the
    Potomac hugging the WV and VA banks (MD/DC own the river) so
    Harpers Ferry / Shepherdstown / Falling Waters / Paw Paw /
    Ridgeley / Keyser / Piedmont WV and Arlington / Alexandria /
    Leesburg VA all split from their north-bank twins, the VA/WV and
    VA/KY ridge borders as paired conservative chains (both Bluefields,
    Peterstown/Rich Creek, WSS/Covington, Rippon/Berryville, Pound
    under Pound Gap), and a conservative Chesapeake Bay line keeping
    Tangier VA in and Smith Island/Crisfield MD out; then Maryland
    and Delaware complete the block — Maryland's Potomac edge is the
    WV/VA bank chains verbatim (MD owns the river) with the DC square
    cut out, and Delaware reuses Pennsylvania's Twelve-Mile-Circle
    chords, the Transpeninsular 38.4510 (Delmar and Fenwick/Ocean
    City split) and the tangent line.  New Jersey and New York close
    the Northeast seaboard: the Delaware River is two shared channel
    lists (_DELAWARE_NY_PA, _DELAWARE_PA_NJ) spliced verbatim into
    the PA/NJ/NY rings, the NJ/NY boundary is the 1774 straight line
    plus the shared _NY_NJ_WATER harbor/Hudson channel (Staten Island,
    Manhattan and Yonkers split from Perth Amboy, Jersey City and
    Alpine across 300 m - 2 km of water), New York's Canada frontage
    rides the Niagara west channel, the Great Lakes midlines, the
    St. Lawrence channel (south of Wolfe Island) and the surveyed
    ~45.005 parallel, Lake Champlain and the CT Oblong/panhandle
    carry the east side, and Long Island Sound rides the NY/CT marine
    midline (Orient/Plum/Fishers Islands NY, the CT shore and Block
    Island RI out).  Southern New England then lands as pure shared
    lists: _NY_CT reversed is Connecticut's whole west+south frontier,
    _CT_MA carries the surveyed straight line with the Southwick Jog,
    _CT_RI the Pawcatuck and the -71.7972 line, _RI_MA_EAST the
    Attleboro line / East Bay / Mount Hope Bay / Westport meridian,
    and _MA_NH the Province line + three-miles-north-of-the-Merrimack
    arc awaiting a New Hampshire ring; Rhode Island's Atlantic
    envelope encloses Block Island by reusing the New York edge
    vertices that deliberately excluded it.  Northern New England
    finishes the seaboard: Vermont reuses the _NY_VT Champlain/land
    chain, the VT/NH border is the _CT_RIVER_VT_NH west-bank chain
    (the river itself is New Hampshire), NH/ME is the _NH_ME
    line/Salmon Falls/Piscataqua chain, and Maine's Canada frontage
    runs the highlands divide, the St. Francis/St. John channels, the
    exact -67.7837 due-south line, the St. Croix and Passamaquoddy
    Bay (Eastport/Lubec in, Deer Island/Campobello/Grand Manan out).
    Alaska and Hawaii complete all 50 states: Alaska's 141W meridian
    shares Yukon's vertices, its panhandle edge reuses British
    Columbia's Portland Canal / interior chain verbatim (Hyder/
    Stewart split), the 1867 treaty meridian -168.98 splits the
    Diomedes, and the ring clips at -179.9 (far western Aleutians
    fall outside — the one documented antimeridian concession);
    Hawaii is a generous envelope around the eight main islands.
    Round 4g widens the worldwide layer: island-nation envelopes
    (IS/NZ/TW/LK/MG/CU/JM and JP/KR, threading the Palk, Taiwan,
    La Perouse, Nemuro and Korea straits and a conservative Korean
    DMZ chain), the Sahara (Chad and Niger; Libya's south edge fixed
    to the 1955 Toummo line so the ICJ-awarded Aouzou strip resolves
    to Chad) and the Middle East desert treaty lines (JO/IQ/SA/KW
    shared zigzags incl. Winston's hiccup; Egypt's Gulf-of-Aqaba
    edge tightened to the midline so the four-way gulf head splits
    Taba/Eilat/Aqaba/Haql).  Every ring is validated SIMPLE (no
    self-intersection) by tests, and a worldwide sweep asserts no
    two rings claim the same point.

Coastal rings are deliberately GENEROUS (they extend offshore): no
sibling subdivision competes over water, so over-extension cannot
misassign, while clipping at an approximate coastline would lose
coastal points to the anchor fallback for no benefit.

Accuracy envelope: along the meridian/parallel borders listed above the
assignment is exact (this is what nearest-anchor could never do); along
approximated river/divide segments it can be off within ~10-30 km of
the segment; everywhere not covered by a ring the caller falls back to
nearest-anchor semantics (utils/geonames.py documents that envelope).
"""
from __future__ import annotations

# Colorado River CA/AZ border polyline, north (the NV tripoint at the
# end of Nevada's 1861 oblique line) to south (the point where the
# CA/Mexico straight line meets the river).  Shared VERBATIM as
# Arizona's west edge and California's east edge (coincident edges =
# no overlap and no dead strip), tracking the channel within ~2 km so
# the river twin towns split correctly: Needles/Earp/Big River/
# Blythe/Bard/Winterhaven stay California; Lake Havasu City/Parker/
# Ehrenberg/Cibola/Martinez Lake/Yuma stay Arizona.
_COLORADO_RIVER: list[tuple[float, float]] = [
    (35.0, -114.63),                     # NV/CA/AZ tripoint
    (34.86, -114.59),                    # Needles east
    (34.72, -114.50),                    # Topock
    (34.57, -114.385), (34.44, -114.36),  # Lake Havasu
    (34.295, -114.14),                   # Parker Dam
    (34.15, -114.296),                   # Parker/Earp split
    (33.99, -114.41), (33.70, -114.53),
    (33.60, -114.55),                    # Blythe/Ehrenberg split
    (33.40, -114.725),                   # Palo Verde bend
    (33.08, -114.68), (32.97, -114.51),  # Imperial reach
    (32.84, -114.47), (32.76, -114.53),
    (32.73, -114.615),                   # Winterhaven/Yuma split
    (32.718, -114.719),                  # CA/Mexico corner
]

# Red River of the North ND/MN border polyline, north (the 49N corner
# shared with Manitoba at Pembina/Emerson) to south (the Bois de Sioux
# at the ND/SD/MN corner).  Shared VERBATIM as North Dakota's east
# edge and Minnesota's west edge, tracking the channel within ~1-2 km
# so the river twin cities split correctly: Pembina/Drayton/
# Grand Forks/Fargo/Wahpeton stay North Dakota; St. Vincent/Oslo/
# East Grand Forks/Moorhead/Breckenridge stay Minnesota (the anchors
# provably send Fargo to Minnesota and BOTH Grand Forks cities to
# Manitoba).
_RED_RIVER: list[tuple[float, float]] = [
    (49.0, -97.23),                      # Pembina/Emerson at 49N
    (48.57, -97.16),                     # Drayton
    (48.20, -97.14),                     # Oslo reach
    (47.93, -97.03),                     # Grand Forks/East Grand Forks
    (47.35, -96.845),                    # Halstad reach
    (46.87, -96.78),                     # Fargo/Moorhead
    (46.45, -96.71),                     # Abercrombie reach
    (46.27, -96.598),                    # Wahpeton/Breckenridge
    (45.935, -96.56),                    # Bois de Sioux at the SD line
]

# Wabash River IL/IN border polyline, north (where the Vincennes
# meridian -87.5246 meets the river) to south (the Ohio confluence).
# Shared VERBATIM as Illinois's southeast edge and Indiana's west edge
# (coincident edges = no overlap, no dead strip), tracking the channel
# within ~1-2 km so the bank towns split correctly: St. Francisville/
# Mt. Carmel/Grayville stay Illinois; Vincennes/New Harmony stay
# Indiana.
_WABASH: list[tuple[float, float]] = [
    (38.74, -87.5246),                    # meridian meets the Wabash
    (38.677, -87.535),                    # Vincennes
    (38.59, -87.636),                     # St. Francisville
    (38.40, -87.75),                      # Mt. Carmel
    (38.26, -87.98),                      # Grayville
    (38.13, -87.95),                      # New Harmony reach
    (37.80, -88.03),                      # Wabash -> Ohio confluence
]

# Ohio River border polylines, each shared VERBATIM by the state on
# the north bank and Kentucky on the south (coincident edges = no
# overlap, no dead strip), downstream order, channel within ~2 km.
# _OHIO_RIVER_OH runs from the Big Sandy area to the IN tripoint
# (Ohio's KY-facing section); _OHIO_RIVER_IN from the tripoint to the
# Wabash mouth; _OHIO_RIVER_IL from the Wabash mouth to the
# Mississippi confluence at Fort Defiance.
_OHIO_RIVER_OH: list[tuple[float, float]] = [
    (38.515, -82.665),                    # Coal Grove reach
    (38.527, -82.695),                    # Ironton / Russell
    (38.578, -82.83),                     # Greenup reach
    (38.72, -82.87),                      # Sciotoville bend
    (38.7265, -82.99),                    # Portsmouth / South Shore
    (38.68, -83.30),                      # Friendship reach
    (38.68, -83.61),                      # Manchester
    (38.65, -83.75),                      # Aberdeen / Maysville
    (38.775, -84.0),                      # Augusta reach
    (38.93, -84.28),                      # New Richmond reach
    (39.065, -84.43),                     # California bend
    (39.097, -84.497),                    # Cincinnati / Newport
    (39.094, -84.525),                    # Cincinnati / Covington
    (39.09, -84.60),                      # Delhi reach
    (39.13, -84.71),                      # Addyston bend
]
_OHIO_RIVER_IN: list[tuple[float, float]] = [
    (39.06, -84.90),                      # Aurora reach
    (38.955, -84.855),                    # Rising Sun
    (38.79, -84.91),                      # Warsaw bend
    (38.74, -85.07),                      # Vevay
    (38.72, -85.395),                     # Madison
    (38.54, -85.42),                      # Bethlehem reach
    (38.50, -85.47),                      # Westport bend
    (38.35, -85.625),                     # Utica / Prospect
    (38.267, -85.745),                    # Louisville / Jeffersonville
    (38.272, -85.83),                     # New Albany reach
    (38.15, -85.93),                      # Kosmosdale
    (38.005, -85.95),                     # West Point
    (38.005, -86.17),                     # Brandenburg
    (38.05, -86.32),                      # Mauckport loop
    (38.19, -86.35),                      # Leavenworth horseshoe
    (38.05, -86.50),                      # Alton reach
    (37.95, -86.62),                      # Derby bend
    (37.92, -86.765),                     # Tell City / Hawesville
    (37.885, -86.98),                     # Grandview reach
    (37.87, -87.05),                      # Rockport
    (37.783, -87.115),                    # Owensboro bend
    (37.83, -87.26),                      # Yankeetown reach
    (37.93, -87.40),                      # Newburgh
    (37.96, -87.55),                      # Evansville
    (37.90, -87.60),                      # Henderson bend north
    (37.87, -87.67),                      # Henderson bend west
    (37.92, -87.90),                      # Mt. Vernon
    (37.785, -87.93),                     # Uniontown bend
]
_OHIO_RIVER_IL: list[tuple[float, float]] = [
    (37.685, -88.13),                     # Old Shawneetown
    (37.46, -88.15),                      # Cave-in-Rock
    (37.36, -88.48),                      # Golconda
    (37.15, -88.42),                      # Smithland bend
    (37.105, -88.615),                    # Brookport / Paducah
    (37.14, -88.73),                      # Metropolis reach
]

# Big Sioux River SD/IA border polyline, north (the MN tripoint on the
# shared -96.45 meridian) to south (the Missouri confluence at Sioux
# City).  Shared VERBATIM by South Dakota and Iowa: Canton/Hudson/
# Elk Point/North Sioux City stay South Dakota; Hawarden/Akron/
# Sioux City stay Iowa.
_BIG_SIOUX: list[tuple[float, float]] = [
    (43.50, -96.45),                      # IA/SD/MN corner
    (43.30, -96.555),                     # Canton reach
    (43.13, -96.448),                     # Hudson reach
    (43.005, -96.488),                    # Hawarden
    (42.83, -96.567),                     # Akron
    (42.58, -96.50),                      # Richland bend
    (42.49, -96.435),                     # Missouri confluence
]

# Missouri River polylines, downstream, channel within ~2 km, each
# shared VERBATIM by the facing rings.  _MISSOURI_RIVER_SD_NE: the
# SD/NE section from the 43N corner to the Big Sioux mouth (Yankton/
# Springfield/Vermillion stay South Dakota; Niobrara/Crofton/Ponca
# stay Nebraska).  _MISSOURI_RIVER_IA_NE: the NE/IA then NE/MO section
# from the Big Sioux mouth to the 40N Kansas corner (South Sioux City/
# Omaha/Bellevue/Plattsmouth/Nebraska City/Brownville/Rulo stay
# Nebraska; Sioux City/Council Bluffs stay Iowa — the old straight-
# chord east edge provably claimed Council Bluffs for Nebraska).
_MISSOURI_RIVER_SD_NE: list[tuple[float, float]] = [
    (43.0, -98.47),                       # 43N corner (exact)
    (42.88, -98.30),                      # Fort Randall reach
    (42.77, -98.02),                      # Niobrara mouth
    (42.86, -97.70),                      # Lewis & Clark Lake
    (42.86, -97.395),                     # Yankton
    (42.80, -97.16),                      # Gayville reach
    (42.76, -96.93),                      # Vermillion
    (42.58, -96.70),                      # Ponca bend
    (42.49, -96.435),                     # Big Sioux mouth
]
_MISSOURI_RIVER_IA_NE: list[tuple[float, float]] = [
    (42.49, -96.435),                     # Big Sioux mouth
    (42.48, -96.405),                     # Sioux City / South Sioux City
    (42.40, -96.40),                      # Dakota City reach
    (42.00, -96.22),                      # Decatur / Onawa
    (41.75, -96.09),                      # Little Sioux reach
    (41.54, -96.08),                      # Blair east
    (41.40, -95.93),                      # Fort Calhoun reach
    (41.26, -95.92),                      # Omaha / Council Bluffs
    (41.15, -95.905),                     # Bellevue
    (41.01, -95.865),                     # Plattsmouth
    (40.68, -95.84),                      # Nebraska City
    (40.5757, -95.765),                   # IA/MO corner (= Sullivan
                                          #   line west end, one point)
    (40.40, -95.645),                     # Brownville
    (40.05, -95.42),                      # Rulo
    (40.0, -95.31),                       # 40N Kansas corner
]

# Missouri River KS/MO section, downstream (the 40N corner to Kaw
# Point at Kansas City), shared VERBATIM by Kansas and Missouri: the
# old straight chord claimed Elwood/Wathena KS for the east bank.
# St. Joseph/Weston/Parkville stay Missouri; Elwood/Wathena/Atchison/
# Leavenworth/Lansing stay Kansas.
_MISSOURI_RIVER_KS: list[tuple[float, float]] = [
    (40.0, -95.31),                       # 40N corner
    (39.87, -95.15),                      # Iowa Point reach
    (39.76, -94.88),                      # St. Joseph north
    (39.747, -94.858),                    # St. Joseph / Elwood
    (39.70, -94.875),                     # Rushville bend
    (39.56, -95.10),                      # Atchison
    (39.40, -95.03),                      # Oak Mills reach
    (39.31, -94.905),                     # Leavenworth
    (39.25, -94.88),                      # Lansing reach
    (39.18, -94.79),                      # Farley bend
    (39.155, -94.70),                     # Riverside reach
    (39.117, -94.608),                    # Kaw Point (State Line Rd)
]

# Mississippi River sections factored from the Illinois ring so the
# west-bank rings share them VERBATIM: _MISSISSIPPI_IL_MO faces
# Missouri (Fort Defiance north to Quincy), _MISSISSIPPI_IL_IA faces
# Iowa (Keokuk north to the Dubuque tripoint).  Both in Illinois's
# northbound traversal order.
_MISSISSIPPI_IL_MO: list[tuple[float, float]] = [
    (36.984, -89.14),                     # Fort Defiance (confluence)
    (37.01, -89.20),                      # Cairo west bank
    (37.07, -89.26),                      # Future City reach
    (37.18, -89.44),                      # Gale bend
    (37.22, -89.465),                     # Thebes
    (37.30, -89.505),                     # Cape Girardeau reach
    (37.91, -89.83),                      # Chester
    (37.98, -90.035),                     # Ste. Genevieve reach
    (38.63, -90.178),                     # St. Louis / East St. Louis
    (38.87, -90.18),                      # Alton reach
    (38.955, -90.435),                    # Grafton
    (39.45, -91.045),                     # Louisiana reach
    (39.71, -91.347),                     # Hannibal
    (39.93, -91.425),                     # Quincy
]
_MISSISSIPPI_IL_IA: list[tuple[float, float]] = [
    (40.397, -91.36),                     # Keokuk / Hamilton
    (40.47, -91.41),                      # Galland bend
    (40.55, -91.405),                     # Montrose / Nauvoo
    (40.61, -91.335),                     # Nauvoo bend east
    (40.62, -91.29),                      # Fort Madison reach
    (40.81, -91.08),                      # Burlington
    (40.93, -90.965),                     # Oquawka
    (41.10, -90.955),                     # Keithsburg
    (41.42, -91.03),                      # Muscatine
    (41.45, -90.72),                      # Buffalo reach
    (41.517, -90.576),                    # Rock Island / Davenport
    (41.52, -90.44),                      # East Moline / Bettendorf
    (41.60, -90.341),                     # LeClaire / Port Byron
    (41.68, -90.32),                      # Cordova
    (41.845, -90.182),                    # Clinton / Fulton
    (42.08, -90.166),                     # Savanna / Sabula
    (42.26, -90.41),                      # Bellevue reach
    (42.497, -90.655),                    # Dubuque / East Dubuque
]

# Mississippi River WI/IA section, north (the 43.5N Minnesota corner)
# to south (the Dubuque tripoint), shared VERBATIM by Wisconsin and
# Iowa: Lansing/Marquette/McGregor/Guttenberg stay Iowa; Prairie du
# Chien/Cassville stay Wisconsin.
_MISSISSIPPI_WI_IA: list[tuple[float, float]] = [
    (43.5, -91.217),                      # 43.5N meets the Mississippi
    (43.36, -91.205),                     # Lansing
    (43.048, -91.163),                    # Marquette / Prairie du Chien
    (42.786, -91.09),                     # Guttenberg
    (42.70, -91.005),                     # Cassville reach
    (42.58, -90.68),                      # Potosi reach
    (42.497, -90.655),                    # Dubuque tripoint
]

# Wisconsin/Michigan land border, northwest (the Montreal River mouth
# on Lake Superior) to southeast (the Menominee River mouth on Green
# Bay), shared VERBATIM by both rings: Hurley/Niagara/Marinette stay
# Wisconsin; Ironwood/Iron Mountain/Menominee stay Michigan.  Montreal
# and Menominee reaches track the channel; the Lac Vieux Desert /
# Brule highland section is the surveyed line within ~3 km.
_WI_MI: list[tuple[float, float]] = [
    (46.565, -90.415),                    # Montreal mouth (Superior)
    (46.45, -90.18),                      # Ironwood / Hurley
    (46.33, -89.75),                      # Montreal headwaters line
    (46.12, -89.12),                      # Lac Vieux Desert
    (46.0, -88.90),                       # Brule River
    (45.95, -88.50),                      # Brule lower reach
    (45.79, -88.03),                      # Iron Mountain / Niagara
    (45.783, -88.002),                    # Niagara north bend
    (45.72, -87.93),                      # Norway reach
    (45.67, -87.80),                      # Faithorn bend
    (45.42, -87.76),                      # Wallace reach
    (45.20, -87.75),                      # Menominee River
    (45.12, -87.66),                      # Menominee bend
    (45.103, -87.625),                    # Menominee / Marinette
    (45.093, -87.588),                    # Menominee mouth (Green Bay)
]

# Green Bay / Lake Michigan water boundary between Wisconsin and
# Michigan, from the Menominee mouth northeast past Washington Island
# (WI) into Lake Michigan, shared VERBATIM by both rings.
_GREEN_BAY: list[tuple[float, float]] = [
    (45.093, -87.588),                    # Menominee mouth
    (45.35, -87.10),                      # mid-bay line
    (45.47, -86.78),                      # Rock Island Passage
]

# Mississippi River sections below Tennessee, downstream, channel
# within ~2 km, shared VERBATIM by the facing rings: _MISSISSIPPI_AR_MS
# (the 34.995 Tennessee corner to the 33N Louisiana corner — Helena/
# Lake Village stay Arkansas, Friars Point/Rosedale/Greenville stay
# Mississippi) and _MISSISSIPPI_LA_MS (33N down to the 31N crossing —
# Vicksburg/Natchez stay Mississippi, Delta/Vidalia stay Louisiana).
_MISSISSIPPI_AR_MS: list[tuple[float, float]] = [
    (34.995, -90.30),                     # TN corner (34.995 exact)
    (34.53, -90.575),                     # Helena
    (34.37, -90.645),                     # Friars Point
    (33.85, -91.05),                      # Rosedale reach
    (33.61, -91.18),                      # Arkansas City
    (33.41, -91.09),                      # Greenville / Lake Village
    (33.10, -91.15),                      # Eudora reach
    (33.0, -91.166),                      # 33N Louisiana corner
]
_MISSISSIPPI_LA_MS: list[tuple[float, float]] = [
    (33.0, -91.166),                      # 33N corner
    (32.8, -91.16),                       # Transylvania reach
    (32.34, -90.905),                     # Vicksburg / Delta
    (32.0, -91.08),                       # Big Black reach
    (31.76, -91.29),                      # St. Joseph bend
    (31.563, -91.414),                    # Natchez / Vidalia
    (31.30, -91.54),                      # Artonish reach
    (31.0, -91.64),                       # the 31N crossing
]

# Pearl River LA/MS border, north (the 31N corner) to the Gulf,
# shared VERBATIM: Bogalusa/Slidell stay Louisiana, Picayune stays
# Mississippi.
_PEARL: list[tuple[float, float]] = [
    (31.0, -89.728),                      # 31N meets the Pearl
    (30.79, -89.82),                      # Bogalusa
    (30.53, -89.73),                      # Picayune reach
    (30.18, -89.65),                      # Pearl mouth
]

# Chattahoochee River AL/GA border, north (the West Point corner of
# the straight AL/GA line) to south (the 31N Florida corner), shared
# VERBATIM: Phenix City/Eufaula stay Alabama, Columbus GA stays
# Georgia.  The section below 31N faces Florida instead
# (_CHATTAHOOCHEE_FL, down to the Flint confluence tri-corner).
_CHATTAHOOCHEE: list[tuple[float, float]] = [
    (32.87, -85.18),                      # West Point corner
    (32.61, -85.07),                      # Goat Rock reach
    (32.466, -84.995),                    # Columbus / Phenix City
    (32.0, -85.07),                       # Fort Benning reach
    (31.89, -85.13),                      # Eufaula
    (31.62, -85.06),                      # Fort Gaines reach
    (31.28, -85.10),                      # Columbia reach
    (31.0, -85.09),                       # 31N Florida corner
]
_CHATTAHOOCHEE_FL: list[tuple[float, float]] = [
    (31.0, -85.09),                       # 31N corner
    (30.90, -85.01),                      # Sneads reach
    (30.71, -84.86),                      # Flint confluence tri-corner
]

# Perdido River AL/FL border, north (the 31N west end) to Perdido Bay,
# shared VERBATIM: Orange Beach stays Alabama, Pensacola stays Florida.
_PERDIDO: list[tuple[float, float]] = [
    (31.0, -87.601),                      # 31N meets the Perdido
    (30.85, -87.58),                      # Barrineau reach
    (30.55, -87.44),                      # Muscogee reach
    (30.38, -87.41),                      # Perdido Bay head
    (30.297, -87.42),                     # bay midline to the Gulf
]

# Georgia/Florida border, west (the Flint confluence) to the Atlantic:
# the surveyed Orr-Whitner line rising 30.59 -> 30.71 westward, then
# the winding St. Marys River.  Shared VERBATIM (Valdosta GA in,
# Madison FL out; Folkston GA in, Hilliard FL out).
_GA_FL: list[tuple[float, float]] = [
    (30.71, -84.86),                      # Flint confluence tri-corner
    (30.66, -83.50),                      # Orr-Whitner line
    (30.5226, -82.2291),                  # Ellicott's Mound (line end)
    (30.51, -82.18),                      # Moniac reach
    (30.52, -82.04),                      # St. George
    (30.58, -81.965),                     # river turns north
    (30.79, -81.965),                     # Folkston GA / Boulogne FL
    (30.75, -81.70),                      # Kings Ferry reach
    (30.72, -81.55),                      # St. Marys city reach
    (30.71, -81.44),                      # Cumberland Sound mouth
]

# Kentucky/Tennessee border, east (Cumberland Gap tripoint) to west
# (the Jackson Purchase), shared VERBATIM by both rings.  East of the
# Tennessee River the line is the surveyed WALKER LINE at ~36.62-36.64
# — NOT the chartered 36.5 parallel (the 1779-80 survey error) — so
# Clarksville/Portland TN stay Tennessee while Guthrie/Oak Grove/
# Franklin KY stay Kentucky; at the Tennessee River the border jogs
# south to the true 36.4977 parallel, which runs to the Mississippi.
# Ohio River OH/WV frontage, north (the OH/PA/WV river tripoint) to
# south (Chesapeake/Huntington, where the shared OH/KY list takes
# over).  Shared VERBATIM as Ohio's upper east edge and West
# Virginia's west edge, tracking the channel within ~2 km so the twin
# cities split: East Liverpool/Wellsville/Toronto/Mingo Junction/
# Brilliant/Steubenville stay Ohio; Chester/Newell/New Cumberland/
# Weirton/Follansbee/Wellsburg stay West Virginia.  The northern-
# panhandle hairpin is densified — the previous straight chord claimed
# Chester and Newell WV for Ohio and lost Mingo Junction and Brilliant
# OH to the east bank.
_OHIO_RIVER_WV: list[tuple[float, float]] = [
    (40.615, -80.572),                    # East Liverpool / Chester
    (40.624, -80.607),                    # Newell reach
    (40.597, -80.643),                    # Wellsville bend
    (40.52, -80.625),                     # Stratton reach
    (40.50, -80.615),                     # Empire / New Cumberland
    (40.455, -80.595),                    # Toronto reach
    (40.42, -80.605),                     # Weirton west
    (40.37, -80.615),                     # Steubenville
    (40.322, -80.601),                    # Mingo Junction / Follansbee
    (40.28, -80.614),                     # Wellsburg west
    (40.26, -80.618),                     # Brilliant reach
    (40.21, -80.66),                      # Wellsburg reach
    (40.064, -80.730),                    # Wheeling / Bridgeport
    (39.92, -80.752),                     # Moundsville reach
    (39.665, -80.865),                    # New Martinsville
    (39.56, -81.005),                     # Sistersville
    (39.395, -81.21),                     # St. Marys reach
    (39.409, -81.452),                    # Marietta / Williamstown
    (39.32, -81.559),                     # Vienna reach
    (39.270, -81.567),                    # Belpre / Parkersburg
    (38.955, -81.78),                     # Ravenswood reach
    (39.022, -82.028),                    # Pomeroy bend
    (38.83, -82.17),                      # Gallipolis / Point Pleasant
    (38.58, -82.27),                      # Crown City reach
    (38.425, -82.448),                    # Chesapeake / Huntington
]

# Tug Fork / Big Sandy channel (KY/WV border), south (the VA tripoint
# headwater) to north (the Big Sandy reach below Louisa/Fort Gay).
# Shared VERBATIM by the Kentucky and West Virginia rings so the
# Williamson/South Williamson and Louisa/Fort Gay twins split
# identically from both sides.
_TUG_BIG_SANDY: list[tuple[float, float]] = [
    (37.45, -82.30),                      # Tug headwater (cons.)
    (37.62, -82.17),                      # Matewan reach
    (37.671, -82.282),                    # Williamson / S. Williamson
    (37.84, -82.415),                     # Kermit reach
    (38.115, -82.595),                    # Louisa / Fort Gay
    (38.25, -82.60),                      # Big Sandy reach
    (38.40, -82.596),                     # Catlettsburg reach
]

# Delaware River, NY/PA reach: from where the 42N line meets the river
# down to the Port Jervis elbow just above the NY/NJ/PA tri-state.
# Shared VERBATIM by Pennsylvania (east edge, this order) and New York
# (west edge, reversed): Hancock/Callicoon/Narrowsburg/Port Jervis NY
# stay east of the channel, Equinunk/Lackawaxen/Matamoras PA west.
_DELAWARE_NY_PA: list[tuple[float, float]] = [
    (41.95, -75.28),                      # Hancock
    (41.87, -75.21),                      # Lordville
    (41.77, -75.06),                      # Callicoon
    (41.60, -75.06),                      # Narrowsburg
    (41.48, -74.91),                      # Barryville
    (41.44, -74.82),                      # Pond Eddy
    (41.405, -74.72),                     # Sparrowbush reach
    (41.371, -74.690),                    # Port Jervis elbow
]

# Delaware River, PA/NJ reach: tri-state corner down to the Marcus Hook
# arc start where the Twelve-Mile-Circle chords take over.  Shared
# VERBATIM by Pennsylvania (this order) and New Jersey (reversed):
# Easton/Trenton-side/Camden splits within ~1-2 km of the channel.
_DELAWARE_PA_NJ: list[tuple[float, float]] = [
    (41.32, -74.80),                      # Milford
    (41.22, -74.86),                      # Dingmans Ferry
    (41.09, -75.00),                      # Bushkill
    (40.97, -75.13),                      # Delaware Water Gap
    (40.92, -75.09),                      # Portland / Columbia
    (40.83, -75.08),                      # Belvidere reach
    (40.69, -75.195),                     # Easton / Phillipsburg
    (40.59, -75.19),                      # Riegelsville
    (40.53, -75.06),                      # Frenchtown reach
    (40.37, -74.95),                      # New Hope / Lambertville
    (40.30, -74.87),                      # Washington Crossing
    (40.22, -74.77),                      # Trenton / Morrisville
    (40.14, -74.74),                      # Bordentown bend
    (40.08, -74.865),                     # Bristol / Burlington
    (40.01, -75.04),                      # Tacony reach
    (39.95, -75.135),                     # Philadelphia / Camden
    (39.89, -75.18),                      # south Philadelphia
    (39.85, -75.31),                      # Eddystone
    (39.83, -75.36),                      # Chester
    (39.80, -75.43),                      # Marcus Hook / arc start
]

# NY/VT frontier, north (where the surveyed ~45.005 Canada line meets
# Lake Champlain) down the lake midline (Plattsburgh/Port Kent/Essex/
# Port Henry/Ticonderoga NY west, Grand Isle/Burlington/Vergennes/
# Chimney Point VT east), through the narrow south lake and East Bay
# (Whitehall NY in) to the Poultney corner, then the near-straight
# surveyed land line to the MA tripoint (Hoosick Falls/Cambridge/
# Salem NY west, Pownal/Bennington/Rupert VT east).  Shared VERBATIM
# by New York (this order) and Vermont (reversed).
_NY_VT: list[tuple[float, float]] = [
    (45.005, -73.345),                    # 45N at Lake Champlain
    (44.72, -73.365),                     # Champlain midline
    (44.50, -73.30),                      # midline (Burlington out)
    (44.20, -73.33),                      # midline (Vergennes out)
    (43.95, -73.40),                      # midline (Port Henry in)
    (43.62, -73.42),                      # narrow lake south
    (43.56, -73.37),                      # East Bay (Whitehall in)
    (43.525, -73.25),                     # Poultney corner
    (42.7449, -73.2764),                  # MA/VT/NY tripoint
]

# NY/CT frontier, north (the MA/CT/NY tripoint) through the land
# border (the Oblong line, the panhandle north edge, the Byram corner)
# then east along the Long Island Sound marine midline to the Fishers
# Island Sound corner.  Shared VERBATIM by New York (this order) and
# Connecticut (reversed): Greenwich/Stamford/Ridgefield/Danbury CT
# east/south of the land line, Rye/White Plains/Armonk/Bedford/
# Brewster NY west/north; the Sound midline keeps the CT shore and
# islands north while Eatons Neck, Orient, Plum and Fishers Islands
# stay New York.
_NY_CT: list[tuple[float, float]] = [
    (42.0497, -73.4875),                  # MA/CT/NY tripoint
    (41.155, -73.52),                     # Oblong south corner
    (41.100, -73.715),                    # panhandle NW corner
    (41.067, -73.700),                    # Westchester airport reach
    (41.005, -73.662),                    # Byram River (Port Chester)
    (40.985, -73.655),                    # Sound at the Byram mouth
    (40.94, -73.62),                      # western Sound midline
    (40.99, -73.45),                      # Sound midline (Eatons Neck)
    (41.03, -73.10),                      # midline (Bridgeport out)
    (41.09, -72.70),                      # midline (New Haven out)
    (41.21, -72.30),                      # Orient / Plum Island in
    (41.32, -71.95),                      # Fishers Island Sound corner
]

# NY/NJ water boundary, south (the harbor entrance off Sandy Hook) to
# north (where the 1774 straight line meets the Hudson midline).
# Shared VERBATIM by the New Jersey and New York rings: Raritan Bay
# midline (Staten Island's south shore NY, Keansburg/Sandy Hook NJ),
# Arthur Kill channel (Tottenville/Howland Hook NY east bank 300-600 m
# from Perth Amboy/Carteret/Linden/Elizabethport NJ west bank), the
# Kill Van Kull (Shooters Island NY under the Bayonne shore, Port
# Richmond/St. George NY south), Upper Bay and the Hudson midline
# (Hoboken/Jersey City/Edgewater/Fort Lee/Alpine NJ west bank,
# Manhattan/Riverdale/Yonkers NY east bank).
_NY_NJ_WATER: list[tuple[float, float]] = [
    (40.50, -73.95),                      # harbor entrance (Sandy Hook)
    (40.47, -74.10),                      # Raritan Bay midline
    (40.475, -74.20),                     # Raritan Bay west (Keansburg S)
    (40.493, -74.26),                     # Ward Point (Kill mouth)
    (40.525, -74.253),                    # Outerbridge midspan
    (40.555, -74.235),                    # Arthur Kill (Tottenville reach)
    (40.59, -74.21),                      # Arthur Kill (Carteret reach)
    (40.625, -74.202),                    # Tremley reach (Linden out)
    (40.645, -74.1915),                   # Kill north end (Howland Hook E)
    (40.6475, -74.159),                   # north of Shooters Island
    (40.6435, -74.13),                    # Kill Van Kull (Port Richmond)
    (40.6465, -74.075),                   # Kill Van Kull east (St. George S)
    (40.66, -74.058),                     # Upper Bay midline
    (40.69, -74.045),                     # Upper Bay north (Jersey City W)
    (40.75, -74.012),                     # Hudson midline (Hoboken)
    (40.85, -73.952),                     # Hudson midline (GW Bridge)
    (40.92, -73.915),                     # Hudson midline (Alpine/Riverdale)
    (40.996, -73.907),                    # 1774 line at the Hudson
]

# CT/RI border: the Pawcatuck River from the Sound up to the Ashaway
# corner (Pawcatuck CT west bank, Westerly RI east bank), then the
# straight ~-71.7972 north line to the CT/RI/MA tripoint.  Shared
# VERBATIM by the Connecticut and Rhode Island rings (this order:
# south/mouth to north/tripoint).
_CT_RI: list[tuple[float, float]] = [
    (41.328, -71.860),                    # Pawcatuck mouth (Little
                                          #   Narragansett Bay)
    (41.350, -71.845),                    # lower river
    (41.3776, -71.8310),                  # Westerly / Pawcatuck reach
    (41.405, -71.810),                    # Potter Hill reach
    (41.4417, -71.7972),                  # Ashaway corner (line starts)
    (42.0157, -71.7972),                  # CT/RI/MA tripoint
]

# RI/MA east border, north (the RI northeast corner on the 42.0157
# line) to south (the Atlantic end of the ~-71.128 Westport meridian).
# Shared VERBATIM by Rhode Island (east edge, this order) and
# Massachusetts (west edge, reversed): the Attleboro line trends SSW
# (Pawtucket/Central Falls RI west, Attleboro/South Attleboro MA
# east), the Seekonk/Palmer reach keeps East Providence/Riverside/
# Barrington/Warren/Bristol RI and Seekonk/Rehoboth/Swansea/Somerset
# MA apart, Mount Hope Bay splits Bristol RI from Fall River MA, the
# Fall River/Tiverton coastal corner runs east overland, and the
# Westport meridian keeps Little Compton/Adamsville RI west of
# Westport MA.
_RI_MA_EAST: list[tuple[float, float]] = [
    (42.0157, -71.3817),                  # RI northeast corner
    (41.83, -71.345),                     # Attleboro line south end
    (41.775, -71.330),                    # Seekonk reach
    (41.73, -71.255),                     # Palmer River reach
    (41.68, -71.245),                     # Mount Hope Bay (Bristol E)
    (41.6604, -71.185),                   # Fall River / Tiverton corner
    (41.6550, -71.128),                   # overland jog east
    (41.50, -71.128),                     # Westport meridian at the sea
]

# CT/MA border: a straight surveyed line from the NY tripoint to the
# RI tripoint (the real line wobbles <~1 km about it) with the
# Southwick Jog — the MA notch dipping south to ~41.9983 between
# -72.7737 and -72.7554 (Congamond Lakes stay Massachusetts).  Shared
# VERBATIM by Connecticut (north edge, this order: west to east) and
# Massachusetts (south edge, reversed).
_CT_MA: list[tuple[float, float]] = [
    (42.0497, -73.4875),                  # NY/MA/CT tripoint
    (42.0301, -72.7737),                  # jog northwest corner
    (41.9983, -72.7737),                  # jog southwest corner
    (41.9983, -72.7554),                  # jog southeast corner
    (42.0299, -72.7554),                  # jog northeast corner
    (42.0157, -71.7972),                  # CT/RI/MA tripoint
]

# MA north border, west (the Connecticut River corner where the
# MA/VT line ends and New Hampshire's bank begins) to east (the
# Atlantic off Salisbury Beach).  Shared VERBATIM by Massachusetts
# (this order) and, later, New Hampshire (reversed): the Province
# line runs ~42.70-42.71 west of the Merrimack bend, then climbs the
# surveyed three-miles-north-of-the-Merrimack arc (Pelham/Windham/
# Salem/Atkinson/Plaistow/Newton/South Hampton/Seabrook NH north,
# Dracut/Methuen/Haverhill/Merrimac/Amesbury/Salisbury MA south).
_MA_NH: list[tuple[float, float]] = [
    (42.7269, -72.4583),                  # Connecticut River corner
    (42.713, -72.28),                     # Province line (Winchester S)
    (42.710, -71.90),                     # Province line (Rindge S)
    (42.700, -71.46),                     # Nashua / Tyngsborough
    (42.705, -71.36),                     # Pelham SW corner reach
    (42.712, -71.295),                    # Dracut / Pelham corner
    (42.7525, -71.22),                    # Methuen / Salem line
    (42.805, -71.13),                     # Haverhill / Atkinson arc
    (42.852, -71.02),                     # Merrimac / Newton arc
    (42.8724, -70.9150),                  # Amesbury / South Hampton
    (42.8718, -70.8170),                  # coast (Salisbury/Seabrook)
    (42.865, -70.70),                     # seaward extension
]

# VT/NH border: the west bank of the Connecticut River (New Hampshire
# owns the river to Vermont's low-water mark), north (where the river
# crosses the surveyed ~45.005 Canada line) to south (the VT/NH/MA
# tripoint on the bank at the Massachusetts line, = _MA_NH[0]).
# Shared VERBATIM by Vermont (east edge, this order) and New
# Hampshire (west edge, reversed).  Norwich/White River Junction/
# Brattleboro VT split from Hanover/West Lebanon/Hinsdale NH; the
# Bellows Falls hairpin is carried within a ~300 m envelope (the
# villages there sit closer to the bank than hand-authoring resolves,
# so neither side is asserted).
_CT_RIVER_VT_NH: list[tuple[float, float]] = [
    (45.005, -71.52),                     # 45N crossing (Beecher Falls)
    (44.90, -71.505),                     # Canaan / West Stewartstown
    (44.78, -71.62),                      # North Stratford reach
    (44.65, -71.565),                     # Stratford reach
    (44.565, -71.553),                    # Guildhall / Northumberland
    (44.49, -71.61),                      # Lancaster bend (NH east)
    (44.41, -71.705),                     # Gilman reach
    (44.33, -71.92),                      # Fifteen-Mile Falls pools
    (44.30, -72.048),                     # Barnet
    (44.152, -72.040),                    # Wells River / Woodsville
    (43.99, -72.125),                     # Bradford / Piermont
    (43.91, -72.15),                      # Fairlee / Orford
    (43.81, -72.188),                     # East Thetford / Lyme
    (43.715, -72.300),                    # Norwich / Hanover
    (43.649, -72.313),                    # White River Jct / W Lebanon
    (43.55, -72.39),                      # North Hartland reach
    (43.478, -72.39),                     # Windsor / Cornish
    (43.37, -72.41),                      # Ascutney (Claremont NH east)
    (43.298, -72.437),                    # Springfield / Charlestown
    (43.14, -72.4455),                    # Bellows Falls hairpin (~300 m
    (43.11, -72.4455),                    #   envelope, unasserted)
    (42.99, -72.46),                      # Westminster / Walpole
    (42.8509, -72.552),                   # Brattleboro / Chesterfield
    (42.77, -72.505),                     # Vernon pool (Hinsdale east)
]

# NH/ME border, north (the QC tripoint on the highlands) to the sea:
# the straight surveyed line east of the Androscoggin towns, the
# Salmon Falls River (Berwick ME / Somersworth NH within a ~300 m
# envelope) and the Piscataqua channel (Kittery ME / Portsmouth NH).
# Shared VERBATIM by New Hampshire (this order) and Maine (reversed).
_NH_ME: list[tuple[float, float]] = [
    (45.3055, -71.0840),                  # NH/ME/QC corner
    (44.80, -71.035),                     # straight line (Errol NH west)
    (44.40, -71.045),                     # Shelburne NH / Gilead ME
    (44.00, -71.025),                     # Conway NH / Fryeburg ME
    (43.79, -70.990),                     # line end (East Conway)
    (43.55, -70.970),                     # Salmon Falls headwaters
    (43.40, -70.955),                     # Milton pond reach
    (43.30, -70.885),                     # Rochester NH / Lebanon ME
    (43.22, -70.855),                     # Berwick / Somersworth reach
    (43.19, -70.830),                     # Salmon Falls joins Cochecho
    (43.12, -70.790),                     # Piscataqua (Dover / Eliot)
    (43.08, -70.755),                     # Portsmouth / Kittery
    (43.055, -70.705),                    # river mouth (New Castle NH)
    (43.03, -70.60),                      # seaward extension
]

_KY_TN: list[tuple[float, float]] = [
    (36.60, -83.675),                     # Cumberland Gap (VA tripoint)
    (36.61, -84.80),                      # Walker line
    (36.62, -85.60),                      # Walker line
    (36.63, -86.40),                      # Walker line (Portland north)
    (36.641, -87.11),                     # Walker line (Guthrie south)
    (36.641, -87.90),                     # Walker line meets the river
    (36.50, -88.05),                      # Tennessee River jog south
    (36.4977, -88.20),                    # true parallel resumes
]

# --- Iberia (round 4i) ----------------------------------------------
# The Spain/Portugal border ("La Raya", ~1,200 km) is ONE shared chain:
# riverine stretches (Minho, Douro canyon, Tagus/Sever, Chanza, lower
# Guadiana) within ~1-3 km; the mountain stretches (Peneda-Geres,
# Tras-os-Montes, the Sierra de Gata) carry a documented ~3-8 km
# envelope and the tests assert nothing inside that band.  Twin
# borders threaded: Tui ES / Valenca PT (Minho), Rihonor ES / Rio de
# Onor PT (the split village's banks are too tight to assert),
# Fuentes de Onoro ES / Vilar Formoso PT, Badajoz ES / Elvas PT (the
# Caia line), Olivenza (Spanish-administered, east of the Guadiana
# stretch), Ayamonte ES / the VRSA bank (mouth midline; VRSA itself is
# inside the ~1 km envelope and stays unasserted).
_ES_PT: list[tuple[float, float]] = [
    (41.868, -8.878),                     # Minho mouth midline
    (41.90, -8.79),                       # (A Guarda ES / Caminha PT)
    (41.95, -8.70),
    (42.02, -8.665),
    (42.045, -8.645),                     # Tui ES / Valenca PT
    (42.065, -8.555),
    (42.08, -8.45),                       # Salvaterra ES / Moncao PT
    (42.09, -8.36),
    (42.105, -8.27),                      # Melgaco reach
    (42.115, -8.19),                      # border leaves the Minho
    (42.05, -8.11),                       # Laboreiro plateau
    (41.95, -8.16),                       # Peneda rim (envelope)
    (41.87, -8.08),                       # Portela do Homem area
    (41.88, -7.92),                       # Geres east (envelope)
    (41.90, -7.80),                       # Montalegre north (envelope)
    (41.92, -7.65),
    (41.86, -7.45),                       # Feces / Vila Verde da Raia
                                          # (Verin ES N, Chaves PT S)
    (41.875, -7.30),
    (41.87, -7.10),
    (41.92, -6.95),                       # Tras-os-Montes rim
    (41.99, -6.78),                       # north bulge (Braganca PT S,
                                          #   Puebla de Sanabria ES N)
    (41.945, -6.62),                      # Rio de Onor / Rihonor
    (41.97, -6.55),                       # NE corner (envelope)
    (41.94, -6.52),
    (41.80, -6.52),                       # east edge turns south
    (41.68, -6.45),
    (41.60, -6.32),
    (41.57, -6.20),                       # Douro canyon north end
    (41.52, -6.21),
    (41.49, -6.258),                      # Miranda do Douro PT rim
    (41.45, -6.32),
    (41.38, -6.38),                       # Douro canyon (shared midline)
    (41.30, -6.48),                       # Bemposta reach
    (41.22, -6.62),
    (41.13, -6.78),
    (41.06, -6.90),
    (41.02, -6.93),                       # Barca d'Alva (Douro exit)
    (40.95, -6.92),                       # Agueda river south
    (40.85, -6.87),
    (40.75, -6.82),
    (40.605, -6.821),                     # Vilar Formoso PT / Fuentes
                                          #   de Onoro ES (border post)
    (40.45, -6.80),                       # Sierra de Gata (envelope)
    (40.33, -6.84),
    (40.25, -6.92),
    (40.12, -6.95),
    (40.00, -6.92),
    (39.88, -6.95),                       # Zarza la Mayor ES east
    (39.78, -7.00),
    (39.70, -7.02),                       # Erges river
    (39.66, -7.05),                       # Tagus confluence
    (39.655, -7.18),                      # Tagus border stretch
    (39.66, -7.30),
    (39.64, -7.52),                       # Cedillo / Sever confluence
    (39.55, -7.45),                       # Sever river south
    (39.45, -7.37),
    (39.40, -7.31),                       # Marvao PT W, Valencia de
                                          #   Alcantara ES E
    (39.30, -7.25),
    (39.20, -7.22),                       # La Codosera ES east
    (39.05, -7.10),
    (38.95, -7.05),
    (38.89, -7.04),                       # Caia river (Badajoz ES E,
                                          #   Elvas PT W)
    (38.855, -7.01),                      # Guadiana at Badajoz
    (38.80, -7.13),                       # Olivenza stretch: the
    (38.74, -7.245),                      #   de-facto border follows
    (38.65, -7.28),                       #   the Guadiana (Juromenha
    (38.56, -7.29),                       #   PT west bank; Olivenza
    (38.45, -7.26),                       #   and Cheles ES east)
    (38.40, -7.24),                       # leaves the river (V. del
    (38.33, -7.12),                       #   Fresno ES S)
    (38.25, -7.05),
    (38.18, -6.93),                       # Barrancos PT salient wrap
    (38.10, -6.90),                       # (Encinasola ES east)
    (38.05, -6.95),
    (37.99, -7.05),
    (37.97, -7.26),                       # Rosal de la Frontera ES E
    (37.85, -7.25),                       # Chanza river
    (37.75, -7.32),
    (37.67, -7.42),
    (37.60, -7.48),
    (37.55, -7.52),                       # Pomarao (Guadiana again)
    (37.45, -7.49),
    (37.38, -7.44),
    (37.30, -7.445),
    (37.24, -7.42),
    (37.168, -7.412),                     # Guadiana mouth midline
]                                         # (Ayamonte ES / VRSA PT)

# France/Spain: the Pyrenees treaty crest in two chains split at
# Andorra, which neither ring claims (the pocket between the chains
# falls to the anchors — Europe/Andorra resolves it).  Exact-class
# points: the Bidasoa midline (Hondarribia ES / Hendaye FR), La Rhune,
# Dantxarinea, Somport, Pourtalet, the Pont de Rei Garonne crossing
# (Les ES / Fos FR), the Puigcerda wrap (Bourg-Madame FR 1.6 km east),
# Le Perthus FR / La Jonquera ES and the Cerbere/Portbou coast.  The
# knotty Navarre section (the Aldudes FR valley wedge, the Valcarlos
# ES salient) is wrapped within ~2-4 km and left unasserted.
_PYRENEES_W: list[tuple[float, float]] = [
    (43.385, -1.779),                     # Bidasoa mouth midline
    (43.355, -1.779),                     # estuary (Irun ES west bank)
    (43.338, -1.760),                     # Behobie bend
    (43.315, -1.705),                     # Endarlatsa (leaves the river)
    (43.310, -1.628),                     # La Rhune summit
    (43.292, -1.560),                     # Sare reach (Sare FR north)
    (43.268, -1.482),                     # Dantxarinea (Urdax ES south)
    (43.293, -1.420),                     # Baztan north rim
    (43.262, -1.385),                     # Izpegi pass
    (43.10, -1.445),                      # Aldudes west flank (FR wedge)
    (43.035, -1.405),                     # Aldudes south tip
    (43.09, -1.34),                       # Aldudes east flank
    (43.102, -1.296),                     # Valcarlos corridor (Arneguy
    (43.065, -1.27),                      #   FR / Valcarlos ES, tight)
    (43.035, -1.255),                     # Ibaneta rim (Roncesvalles S)
    (43.03, -1.17),
    (42.98, -1.08),
    (42.96, -0.88),                       # Belagua rim
    (42.97, -0.77),                       # Pierre St Martin
    (42.88, -0.62),                       # Anie ridge
    (42.795, -0.527),                     # Somport (Candanchu ES south)
    (42.80, -0.42),                       # Pourtalet
    (42.82, -0.31),                       # Balaitous ridge
    (42.74, -0.13),                       # Vignemale
    (42.69, -0.03),                       # Gavarnie / Monte Perdido
    (42.70, 0.05),
    (42.685, 0.145),                      # Bielsa tunnel
    (42.70, 0.26),
    (42.715, 0.40),
    (42.69, 0.52),
    (42.685, 0.60),                       # Port de Venasque (Luchon N)
    (42.755, 0.645),                      # Aran west rim (Garonne)
    (42.82, 0.665),
    (42.860, 0.695),                      # Pont de Rei (Les ES /
    (42.855, 0.78),                       #   Fos FR)
    (42.835, 0.86),
    (42.79, 0.93),                        # Aran northeast corner
    (42.70, 0.98),
    (42.66, 1.08),
    (42.64, 1.17),
    (42.63, 1.30),
    (42.61, 1.44),                        # Pic de Medecourbe (west
]                                         #   FR/ES/AD tripoint)

_AD_SOUTH: list[tuple[float, float]] = [  # ES-side Andorra skirt
    (42.555, 1.448),
    (42.47, 1.47),
    (42.428, 1.495),                      # Runer bridge (Sant Julia AD
    (42.425, 1.56),                       #   north of the skirt)
    (42.45, 1.66),
    (42.478, 1.71),
    (42.503, 1.727),                      # east FR/ES/AD tripoint
]

_AD_NORTH: list[tuple[float, float]] = [  # FR-side Andorra skirt (4i:
    (42.61, 1.44),                        #   used by the FR ring)
    (42.635, 1.47),
    (42.655, 1.55),
    (42.645, 1.64),
    (42.60, 1.72),
    (42.565, 1.745),                      # Pas de la Casa AD west of
    (42.54, 1.745),                       #   the skirt (in the pocket)
    (42.503, 1.727),
]

_PYRENEES_E: list[tuple[float, float]] = [
    (42.503, 1.727),                      # east AD tripoint
    (42.455, 1.86),
    (42.445, 1.925),                      # Cerdanya wrap: Puigcerda ES
    (42.434, 1.944),                      #   in, Bourg-Madame FR out
    (42.415, 1.947),
    (42.40, 1.98),                        # (Llivia ES enclave is north,
    (42.39, 2.02),                        #   inside FR — see the
    (42.375, 2.09),                       #   ("ES","Catalonia") square)
    (42.385, 2.16),
    (42.40, 2.26),
    (42.415, 2.38),
    (42.385, 2.46),                       # Col d'Ares
    (42.35, 2.55),                        # Vallespir dip (FR south
    (42.335, 2.65),                       #   bulge; Coustouges FR N)
    (42.37, 2.74),
    (42.42, 2.81),
    (42.458, 2.867),                      # Le Perthus FR / La Jonquera
    (42.468, 2.95),                       #   ES
    (42.47, 3.04),                        # Alberes crest
    (42.44, 3.12),
    (42.433, 3.172),                      # coast (Cerbere FR /
]                                         #   Portbou ES)

# --- France / Italy / Switzerland (round 4i, the Alpine arc) --------
# Shared chains, W->E / N->S in their natural direction.  Crest
# stretches carry a ~3-8 km documented envelope (assertions avoid
# them); river and lake midlines are within ~1-2 km; famous twin
# crossings are threaded exactly.  Micro-states each host a zone1970
# anchor, so the anchor cross-validation test enforces their
# exclusion: Monaco (FR coast notch), San Marino + the Vatican
# (IT keyhole loops), Busingen (CH keyhole), Liechtenstein (dead
# strip between the CH and AT chains), Andorra (pocket, round 4i).

_FR_BE: list[tuple[float, float]] = [
    (51.09, 2.546),                       # coast (Bray-Dunes FR /
    (51.01, 2.60),                        #   De Panne BE)
    (50.80, 2.63),                        # Poperinge BE north
    (50.72, 2.87),                        # the Lys reach (Armentieres
    (50.76, 3.01),                        #   FR; Comines split town
    (50.79, 3.12),                        #   unasserted) / Halluin-
    (50.735, 3.19),                       #   Menen; Tourcoing FR /
    (50.64, 3.26),                        #   Mouscron BE
    (50.57, 3.30),                        # Tournai BE west rim
    (50.50, 3.38),
    (50.47, 3.55),                        # Valenciennes FR south
    (50.46, 3.61),                        # Conde reach (unasserted)
    (50.40, 3.675),                       # Quievrain BE / Quievrechain
    (50.34, 3.97),                        # Mons BE N, Maubeuge FR S
    (50.30, 4.10),                        # Jeumont FR / Erquelinnes BE
    (50.18, 4.16),
    (50.07, 4.16),                        # Chimay boot west
    (49.985, 4.31),                       # boot south (Hirson FR S)
    (49.97, 4.45),                        # boot east
    (50.01, 4.56),
    (50.06, 4.50),                        # Givet salient west
    (50.10, 4.58),
    (50.17, 4.72),
    (50.188, 4.825),                      # Givet FR north tip
    (50.13, 4.90),                        # salient east
    (50.06, 4.86),
    (49.99, 4.90),                        # Meuse rim
    (49.88, 5.00),                        # Semois (conservative)
    (49.77, 5.06),                        # Bouillon BE north
    (49.73, 5.18),
    (49.70, 5.30),                        # Florenville BE north
    (49.63, 5.40),
    (49.54, 5.50),                        # Virton BE north
    (49.50, 5.66),                        # Longuyon FR south
    (49.51, 5.76),
    (49.546, 5.818),                      # FR/BE/LU tripoint
]

_FR_LU: list[tuple[float, float]] = [
    (49.546, 5.818),
    (49.50, 5.89),
    (49.47, 5.98),                        # Esch LU N / Villerupt FR S
    (49.46, 6.08),                        # Dudelange LU north
    (49.47, 6.17),                        # Thionville FR south
    (49.470, 6.367),                      # Schengen (FR/LU/DE, Moselle)
]

_FR_DE: list[tuple[float, float]] = [     # Schengen -> Basel
    (49.470, 6.367),
    (49.44, 6.54),
    (49.36, 6.55),
    (49.30, 6.72),                        # Saarlouis DE north
    (49.27, 6.70),
    (49.21, 6.84),
    (49.205, 6.96),                       # Saarbruecken DE / Forbach FR
    (49.13, 7.05),                        # Sarreguemines FR north bank
    (49.12, 7.37),
    (49.12, 7.55),                        # Bitche FR S, Pirmasens DE N
    (49.05, 7.80),
    (49.046, 7.95),                       # Wissembourg FR (the Lauter)
    (48.995, 8.09),
    (48.975, 8.14),
    (48.966, 8.225),                      # Lauterbourg (Rhine bend)
    (48.90, 8.12),                        # the Rhine midline south
    (48.81, 8.05),
    (48.72, 7.99),
    (48.64, 7.85),
    (48.57, 7.80),                        # Strasbourg FR / Kehl DE
    (48.45, 7.76),
    (48.32, 7.70),
    (48.16, 7.62),
    (48.03, 7.565),                       # Neuf-Brisach FR / Breisach DE
    (47.92, 7.55),
    (47.82, 7.555),                       # Chalampe FR / Neuenburg DE
    (47.70, 7.52),
    (47.5896, 7.589),                     # Basel Dreilaendereck
]

_FR_CH: list[tuple[float, float]] = [     # Basel -> Mont Dolent
    (47.5896, 7.589),
    (47.58, 7.555),                       # Saint-Louis FR west
    (47.55, 7.50),
    (47.50, 7.44),
    (47.45, 7.20),                        # Ajoie wrap (Porrentruy CH
    (47.49, 7.04),                        #   inside the salient)
    (47.50, 7.00),                        # Delle FR / Boncourt CH
    (47.45, 6.94),
    (47.37, 6.88),                        # Montbeliard FR northwest
    (47.30, 6.84),
    (47.24, 6.75),                        # the Doubs (envelope)
    (47.17, 6.70),
    (47.10, 6.68),                        # La Chaux-de-Fonds CH east
    (47.03, 6.67),                        # Morteau FR west
    (46.97, 6.52),
    (46.90, 6.46),                        # Pontarlier FR west
    (46.82, 6.43),
    (46.76, 6.36),
    (46.72, 6.30),                        # Vallorbe CH east
    (46.64, 6.18),
    (46.55, 6.12),                        # Joux rim
    (46.47, 6.10),                        # Les Rousses FR west
    (46.41, 6.07),                        # La Cure
    (46.35, 6.09),                        # Gex FR west
    (46.29, 6.105),
    (46.248, 6.108),                      # Ferney FR / Geneva airport
    (46.22, 6.04),                        # Geneva canton west wrap
    (46.18, 5.96),                        # Chancy reach
    (46.13, 5.97),
    (46.145, 6.14),                       # St-Julien FR south rim
    (46.19, 6.21),                        # Annemasse FR east rim
    (46.25, 6.245),
    (46.30, 6.245),                       # Hermance (lake entry)
    (46.33, 6.33),                        # Lake Geneva midline
    (46.39, 6.47),                        # (Lausanne CH north shore,
    (46.46, 6.60),                        #   Evian FR south shore)
    (46.44, 6.73),
    (46.40, 6.79),
    (46.392, 6.803),                      # St-Gingolph (border ashore)
    (46.34, 6.80),                        # Chablais crest
    (46.26, 6.86),
    (46.20, 6.80),                        # Morzine FR west
    (46.13, 6.82),
    (46.06, 6.95),                        # Vallorcine FR west
    (45.99, 7.02),
    (45.922, 7.044),                      # Mont Dolent (FR/CH/IT)
]

_FR_IT: list[tuple[float, float]] = [     # Mont Dolent -> the Med
    (45.922, 7.044),
    (45.833, 6.865),                      # Mont Blanc summit ridge
    (45.75, 6.81),                        # Col de la Seigne
    (45.65, 6.90),
    (45.48, 7.05),                        # Val d'Isere FR west
    (45.35, 7.02),
    (45.22, 6.93),                        # Mont Cenis (1947 line)
    (45.10, 6.63),                        # Bardonecchia IT east
    (45.02, 6.66),
    (44.935, 6.735),                      # Montgenevre FR / Claviere IT
    (44.85, 6.85),
    (44.70, 6.98),
    (44.55, 6.95),
    (44.42, 6.89),                        # Col de Larche
    (44.23, 6.92),
    (44.15, 7.05),
    (44.05, 7.28),
    (44.155, 7.565),                      # Col de Tende (Tende FR
    (44.10, 7.72),                        #   south since 1947)
    (44.02, 7.66),
    (43.95, 7.57),
    (43.88, 7.53),
    (43.782, 7.532),                      # Menton FR / Ventimiglia IT
]

_CH_IT: list[tuple[float, float]] = [     # Mont Dolent -> Piz Lad
    (45.922, 7.044),
    (45.87, 7.17),                        # Grand St Bernard (Aosta S)
    (45.93, 7.40),
    (45.976, 7.658),                      # Matterhorn (Zermatt CH N)
    (45.94, 7.87),                        # Monte Rosa
    (46.05, 7.98),
    (46.14, 8.05),
    (46.21, 8.15),                        # Simplon south salient
    (46.25, 8.32),                        # (Domodossola IT south)
    (46.20, 8.42),
    (46.10, 8.48),
    (46.09, 8.64),                        # Maggiore west shore
    (46.00, 8.78),                        # crosses Lake Maggiore
    (45.95, 8.80),                        # (Cannobio IT north of the
    (45.84, 8.91),                        #   crossing stays unasserted)
    (45.825, 9.00),
    (45.832, 9.06),                       # Chiasso CH / Como IT
    (45.90, 9.05),                        # Ticino wedge east rim
    (45.97, 9.10),
    (46.05, 9.15),
    (46.12, 9.24),
    (46.20, 9.33),
    (46.30, 9.33),                        # Valchiavenna wrap west
    (46.40, 9.38),
    (46.47, 9.46),                        # Valchiavenna north tip
    (46.40, 9.55),
    (46.34, 9.62),                        # Bregaglia (envelope)
    (46.34, 9.97),                        # Poschiavo wrap west
    (46.22, 10.04),                       # (Poschiavo CH inside,
    (46.225, 10.14),                      #   Tirano IT south)
    (46.34, 10.17),                       # Poschiavo wrap east
    (46.40, 10.30),
    (46.45, 10.04),                       # Livigno wrap west (Livigno
    (46.57, 10.07),                       #   IT inside the salient)
    (46.62, 10.20),
    (46.55, 10.30),                       # Val Muestair south rim
    (46.62, 10.48),                       # (Muestair CH north)
    (46.845, 10.47),                      # Piz Lad (CH/AT/IT area)
]

_AT_IT: list[tuple[float, float]] = [     # Piz Lad -> AT/IT/SI corner
    (46.845, 10.47),
    (46.80, 10.75),                       # Oetztal crest
    (46.77, 10.99),
    (46.97, 11.10),
    (47.005, 11.505),                     # Brenner pass
    (46.95, 11.95),
    (46.80, 12.25),                       # San Candido IT south
    (46.72, 12.35),
    (46.67, 12.48),
    (46.62, 12.70),                       # Carnic crest
    (46.60, 12.95),
    (46.58, 13.30),
    (46.55, 13.60),
    (46.52, 13.70),                       # AT/IT/SI tripoint
]

# CH/AT south of Liechtenstein (Piz Lad side -> the FL SE corner)
_CH_AT: list[tuple[float, float]] = [
    (46.93, 10.44),                       # Samnaun reach
    (46.95, 10.31),
    (46.96, 10.14),
    (46.91, 10.02),                       # Silvretta crest
    (46.93, 9.88),
    (46.98, 9.75),                        # Raetikon
    (47.049, 9.62),                       # FL southeast corner
]

_LI_WEST: list[tuple[float, float]] = [   # the FL south + west skirt
    (47.049, 9.62),                       #   (shared VERBATIM by the
    (47.049, 9.51),                       #   CH and LI rings: the
    (47.055, 9.475),                      #   Rhine midline, Balzers/
    (47.12, 9.495),                       #   Vaduz east, Sevelen/
    (47.17, 9.505),                       #   Buchs west)
    (47.22, 9.505),
    (47.270, 9.530),
]

_CH_AT_RHINE: list[tuple[float, float]] = [  # FL north corner -> the
    (47.270, 9.530),                      #   Lake Constance mouth
    (47.33, 9.60),                        # Alpenrhein midline
    (47.40, 9.65),
    (47.46, 9.655),                       # St. Margrethen CH /
    (47.505, 9.62),                       #   Lustenau AT; the mouth
]

# CH/DE: the Lake Constance + High Rhine midline, E -> W (the mouth
# corner to the Rheinfelden reach; Basel closes via _FR_CH[0])
_CH_DE: list[tuple[float, float]] = [
    (47.505, 9.62),
    (47.54, 9.58),                        # Lake Constance midline
    (47.59, 9.45),
    (47.61, 9.33),
    (47.6535, 9.165),                     # Konstanz DE / Kreuzlingen CH
    (47.66, 9.05),
    (47.67, 8.95),                        # Untersee midline
    (47.664, 8.87),                       # Stein am Rhein in
    (47.668, 8.82),
    (47.678, 8.76),
    (47.6875, 8.71),                      # Rhine midline (Buesingen
    (47.6895, 8.675),                     #   + Gailingen DE north;
    (47.70, 8.655),                       #   see the DE square)
    (47.725, 8.64),                       # Schaffhausen lobe top
    (47.705, 8.600),                      # city west wall
    (47.66, 8.598),                       # (Jestetten DE west out,
    (47.585, 8.555),                      #   Neuhausen/Rheinau in)
    (47.575, 8.52),                       # Eglisau reach
    (47.58, 8.41),
    (47.605, 8.30),
    (47.615, 8.22),                       # Waldshut DE / Koblenz CH
    (47.56, 8.06),                        # Laufenburg twins
    (47.55, 7.95),                        # Bad Saeckingen DE /
    (47.558, 7.79),                       #   Stein CH; Rheinfelden
]

# --- Central Europe (round 4j): Germany / Austria / Czechia /
# Poland / Denmark.  Shared chains W->E / S->N in natural direction.
_DE_AT: list[tuple[float, float]] = [     # Lake Constance -> the
    (47.505, 9.62),                       #   DE/AT/CZ tripoint
    (47.53, 9.68),                        # lake midline
    (47.553, 9.727),                      # Lindau DE / Hoerbranz AT
    (47.58, 9.85),
    (47.56, 10.05),
    (47.45, 10.17),                       # Oberstdorf wrap west
    (47.27, 10.17),                       # Einoedsbach south tip
    (47.33, 10.33),                       # wrap east
    (47.40, 10.45),
    (47.53, 10.70),                       # Fuessen DE / Reutte AT
    (47.58, 10.95),
    (47.421, 10.985),                     # Zugspitze (on the border)
    (47.43, 11.08),                       # Garmisch south
    (47.39, 11.30),                       # Mittenwald south
    (47.48, 11.45),
    (47.52, 11.63),
    (47.58, 11.85),
    (47.63, 12.05),
    (47.595, 12.18),                      # Kiefersfelden DE / Kufstein
    (47.65, 12.35),                       #   AT (the Inn valley)
    (47.64, 12.48),                       # Reit im Winkl south
    (47.62, 12.70),
    (47.65, 12.78),                       # the Saalach (Lofer AT S)
    (47.63, 12.83),                       # Berchtesgaden wrap west
    (47.55, 12.90),
    (47.465, 12.98),                      # Koenigssee south tip
    (47.55, 13.09),                       # wrap east
    (47.62, 13.05),
    (47.72, 12.93),                       # Bad Reichenhall east
    (47.83, 13.00),                       # Freilassing DE / Salzburg AT
    (47.92, 12.93),                       # the Salzach midline
    (48.00, 12.85),
    (48.16, 12.83),                       # Burghausen DE east bank
    (48.22, 12.87),                       # Salzach/Inn confluence
    (48.265, 13.03),                      # Simbach DE / Braunau AT
    (48.35, 13.20),                       # the Inn midline
    (48.44, 13.43),                       # Neuhaus DE / Schaerding AT
    (48.52, 13.44),
    (48.575, 13.51),                      # Passau (the Inn mouth)
    (48.60, 13.62),
    (48.70, 13.77),
    (48.77, 13.83),                       # DE/AT/CZ tripoint
]

_DE_CZ: list[tuple[float, float]] = [     # tripoint -> DE/CZ/PL
    (48.77, 13.83),
    (48.88, 13.62),                       # Sumava crest
    (48.97, 13.50),
    (49.05, 13.40),
    (49.14, 13.225),                      # Zelezna Ruda CZ / Bayerisch
    (49.20, 13.05),                       #   Eisenstein DE
    (49.33, 12.88),                       # Furth im Wald DE west
    (49.50, 12.63),
    (49.62, 12.52),
    (49.75, 12.45),                       # Rozvadov reach
    (49.84, 12.47),
    (49.93, 12.55),
    (49.97, 12.42),                       # Cheb bulge south rim
    (50.00, 12.26),
    (50.05, 12.10),                       # Cheb bulge west
    (50.10, 12.08),                       # As hook west
    (50.22, 12.06),
    (50.26, 12.13),                       # As hook north
    (50.23, 12.26),
    (50.30, 12.35),                       # Ore Mountains crest
    (50.40, 12.50),
    (50.42, 12.80),
    (50.50, 13.05),
    (50.60, 13.25),
    (50.71, 13.53),
    (50.80, 13.90),
    (50.81, 14.05),
    (50.86, 14.30),                       # Elbe sandstone
    (50.93, 14.275),                      # Sluknov hook west wall
    (50.9755, 14.2805),                   # (Sebnitz DE south of the
    (51.02, 14.30),                       #   jog, Dolni Poustevna CZ
    (51.055, 14.40),                      #   north — contiguous twins)
    (51.055, 14.42),                      # hook north
    (51.03, 14.52),
    (50.97, 14.58),
    (50.89, 14.66),                       # hook east
    (50.90, 14.77),
    (50.87, 14.82),                       # DE/CZ/PL tripoint (Zittau)
]

_DE_PL: list[tuple[float, float]] = [     # tripoint -> the Baltic
    (50.87, 14.82),                       #   (the Neisse/Oder midline)
    (50.95, 14.93),
    (51.05, 14.96),
    (51.15, 14.997),                      # Goerlitz DE / Zgorzelec PL
    (51.35, 15.02),
    (51.55, 14.90),
    (51.74, 14.65),                       # Forst DE
    (51.95, 14.725),                      # Guben DE / Gubin PL
    (52.03, 14.72),                       # Neisse -> Oder confluence
    (52.10, 14.70),
    (52.345, 14.555),                     # Frankfurt DE / Slubice PL
    (52.50, 14.63),
    (52.585, 14.64),                      # Kostrzyn PL east bank
    (52.72, 14.43),
    (52.82, 14.22),
    (52.90, 14.14),
    (53.05, 14.16),
    (53.20, 14.38),                       # leaves the Oder (Gartz)
    (53.32, 14.33),                       # west of Szczecin PL
    (53.45, 14.29),
    (53.60, 14.30),
    (53.75, 14.27),
    (53.925, 14.22),                      # Usedom coast (Ahlbeck DE /
    (54.10, 14.21),                       #   Swinoujscie PL)
    (54.35, 14.22),                       # Pomeranian Bight sea end
]

_DE_DK: list[tuple[float, float]] = [     # North Sea -> the Baltic
    (55.09, 8.20),                        #   (the 1920 line)
    (55.072, 8.35),                       # Lister Dyb midline (Sylt DE
    (55.066, 8.45),                       #   south, Roemoe DK north —
    (55.03, 8.55),                        #   a ~2 km gap, threaded)
    (54.96, 8.60),
    (54.894, 8.656),                      # coast (the Wiedau)
    (54.90, 8.80),
    (54.89, 9.00),                        # Tonder DK north
    (54.84, 9.22),
    (54.85, 9.40),
    (54.83, 9.42),                        # Flensburg DE south
    (54.81, 9.55),                        # Flensburg Fjord midline
    (54.80, 9.75),
    (54.79, 9.95),                        # fjord mouth (Sonderborg N)
    (54.70, 10.35),                       # western Baltic midline
    (54.58, 11.10),                       # (Aeroe/Langeland/Lolland N)
    (54.42, 11.75),                       # Fehmarn Belt (Fehmarn DE in)
    (54.40, 12.10),                       # (Gedser DK north)
    (54.48, 12.90),
    (54.78, 13.85),                       # east end (Ruegen offshore)
]

_CZ_PL: list[tuple[float, float]] = [     # DE/CZ/PL -> CZ/SK/PL
    (50.87, 14.82),
    (50.83, 14.99),
    (50.86, 15.17),                       # Jizera crest
    (50.80, 15.43),                       # Harrachov CZ south
    (50.736, 15.74),                      # Sniezka (on the border)
    (50.68, 15.95),
    (50.655, 16.05),
    (50.68, 16.20),                       # Broumov CZ salient north
    (50.64, 16.33),
    (50.57, 16.40),
    (50.50, 16.30),                       # Klodzko PL salient: west
    (50.40, 16.22),                       #   wall (Nachod CZ west)
    (50.31, 16.28),
    (50.21, 16.42),
    (50.14, 16.58),                       # salient south tip
    (50.21, 16.70),                       # east wall (Kraliky CZ S)
    (50.32, 16.88),
    (50.32, 17.00),
    (50.32, 17.18),                       # Jesenik CZ south
    (50.27, 17.45),
    (50.32, 17.60),                       # Glubczyce PL north
    (50.26, 17.72),
    (50.12, 17.75),                       # Krnov CZ southwest
    (50.00, 17.92),                       # Opava CZ south
    (49.99, 18.00),
    (49.94, 18.20),
    (49.92, 18.32),                       # Bohumin CZ / Chalupki PL
    (49.87, 18.47),                       #   (the Oder)
    (49.80, 18.55),                       # the Olza
    (49.746, 18.626),                     # Cesky Tesin CZ / Cieszyn PL
    (49.63, 18.70),                       #   (the split town threaded)
    (49.518, 18.846),                     # CZ/SK/PL tripoint (Hrcava)
]

# DE/NL, DE/BE and DE/LU (round 4k: extracted so the Benelux rings
# splice them verbatim), each N->S in the DE ring's direction.
_DE_NL: list[tuple[float, float]] = [
    (53.40, 6.98),                        # Ems estuary midline
    (53.30, 7.10),                        #   (Delfzijl NL west,
    (53.24, 7.19),                        #   Emden DE east)
    (53.00, 7.21),
    (52.85, 7.09),
    (52.65, 7.05),
    (52.40, 7.03),
    (52.22, 7.065),                       # Gronau DE / Enschede NL
    (52.08, 7.02),
    (52.03, 6.83),                        # Winterswijk NL salient
    (51.98, 6.85),                        #   wrap
    (51.90, 6.77),
    (51.87, 6.70),
    (51.865, 6.62),                       # Bocholt DE north
    (51.88, 6.40),
    (51.87, 6.16),                        # the Rhine crossing
    (51.84, 6.09),                        #   (Emmerich DE east)
    (51.77, 6.04),
    (51.71, 6.03),
    (51.60, 6.09),
    (51.50, 6.20),
    (51.40, 6.225),                       # Venlo NL east wrap
    (51.30, 6.16),
    (51.22, 6.08),                        # Roermond NL east
    (51.16, 6.08),
    (51.10, 5.99),
    (51.05, 5.875),                       # Selfkant DE west tip
    (50.98, 5.89),                        #   (Sittard NL west)
    (50.95, 5.99),
    (50.91, 6.02),                        # Heerlen NL west
    (50.83, 6.01),
    (50.754, 6.021),                      # Vaals (DE/NL/BE tripoint)
]

_DE_BE: list[tuple[float, float]] = [
    (50.754, 6.021),
    (50.71, 6.09),                        # Aachen DE north,
    (50.63, 6.17),                        #   Eupen BE west
    (50.55, 6.19),                        # Monschau DE east
    (50.50, 6.32),
    (50.42, 6.37),                        # Hohes Venn
    (50.32, 6.405),
    (50.23, 6.40),                        # St. Vith BE west
    (50.17, 6.25),
    (50.154, 6.137),                      # DE/BE/LU tripoint (Ouren)
]

_DE_LU: list[tuple[float, float]] = [
    (50.154, 6.137),
    (50.05, 6.13),                        # the Our midline
    (49.935, 6.21),                       # Vianden LU west
    (49.84, 6.33),
    (49.81, 6.44),                        # Echternach LU west
    (49.75, 6.505),                       #   (the Sauer midline)
    (49.715, 6.498),                      # Wasserbillig (Moselle)
    (49.66, 6.44),                        # the Moselle midline
    (49.56, 6.37),                        #   (Trier DE east)
    (49.470, 6.367),                      # Schengen
]

# NL/BE (the coast -> Vaals) and BE/LU (Ouren -> the FR tripoint).
# Baarle-Hertog's BE enclaves inside NL are a documented concession
# (they resolve NL); Martelange is split by the road and unasserted.
_NL_BE: list[tuple[float, float]] = [
    (51.375, 3.38),                       # coast (Cadzand NL /
    (51.275, 3.45),                       #   Knokke BE)
    (51.24, 3.52),                        # Zeeuws-Vlaanderen south
    (51.27, 3.75),
    (51.21, 3.805),                       # Sas van Gent NL /
    (51.245, 3.89),                       #   Zelzate BE
    (51.27, 4.08),                        # Hulst NL north
    (51.35, 4.26),                        # the Scheldt crossing
    (51.405, 4.39),                       #   (Antwerp BE south)
    (51.445, 4.40),                       # Essen BE salient wrap
    (51.475, 4.45),
    (51.46, 4.55),
    (51.42, 4.78),
    (51.42, 4.93),                        # Baarle (enclaves concede)
    (51.41, 5.08),
    (51.28, 5.24),
    (51.26, 5.33),                        # Lommel BE north
    (51.30, 5.55),
    (51.22, 5.70),                        # Weert NL north
    (51.16, 5.83),                        # the Maas reach
    (51.10, 5.80),                        #   (Maaseik BE west bank)
    (51.05, 5.77),
    (50.95, 5.73),
    (50.87, 5.64),                        # Maastricht NL east... west
    (50.80, 5.68),
    (50.755, 5.79),                       # Eijsden NL south
    (50.75, 5.89),
    (50.754, 6.021),                      # Vaals (DE/NL/BE tripoint)
]

_BE_LU: list[tuple[float, float]] = [
    (50.154, 6.137),                      # Ouren (DE/BE/LU)
    (50.10, 6.02),
    (50.03, 5.94),
    (49.95, 5.89),
    (49.85, 5.74),                        # Martelange (split,
    (49.73, 5.74),                        #   unasserted)
    (49.68, 5.86),                        # Arlon BE west
    (49.64, 5.89),
    (49.546, 5.818),                      # FR/BE/LU tripoint
]

# --- The Nordics (round 4k).  The Scandinavian crest (NO/SE), the
# Koenkaemae/Muonio/Torne rivers (SE/FI, Haparanda/Tornio threaded),
# the Teno (FI/NO), the 1944 FI/RU line (conservative), and the
# shared Bothnia/Aland sea midline.  Crest stretches cross wilderness
# and carry a wide documented envelope; assertions stay at the towns.
_NO_SE: list[tuple[float, float]] = [     # Svinesund -> Treriksroset
    (58.92, 10.85),                       # Oslofjord mouth midline
    (59.05, 11.15),                       # (Stroemstad SE southeast)
    (59.093, 11.255),                     # Svinesund bridge
    (59.01, 11.39),                       # the Iddefjord (Halden NO
    (58.93, 11.52),                       #   northwest)
    (58.92, 11.66),                       # Kornsjoe reach
    (59.10, 11.72),
    (59.33, 11.64),
    (59.50, 11.80),
    (59.85, 11.93),
    (60.20, 12.20),
    (60.60, 12.50),
    (61.00, 12.60),
    (61.30, 12.30),                       # Trysil NO west... east
    (61.60, 12.40),
    (61.99, 12.15),
    (62.20, 12.10),
    (62.60, 12.10),
    (63.00, 12.00),
    (63.30, 11.98),
    (63.47, 12.15),
    (63.60, 12.60),                       # Are SE east of the crest
    (63.85, 12.80),
    (64.10, 13.30),
    (64.45, 13.90),
    (64.50, 14.10),
    (65.10, 14.30),
    (65.60, 14.50),
    (66.15, 15.40),
    (66.60, 15.50),
    (67.00, 16.10),
    (67.45, 16.10),
    (67.93, 16.50),
    (68.15, 17.90),                       # Narvik NO northwest
    (68.40, 18.10),
    (68.55, 18.80),                       # Abisko SE southeast
    (68.91, 20.25),
    (69.06, 20.55),                       # Treriksroset (NO/SE/FI)
]

_SE_FI: list[tuple[float, float]] = [     # Treriksroset -> the Torne
    (69.06, 20.55),                       #   mouth (the river chain)
    (68.90, 20.90),
    (68.70, 21.40),
    (68.55, 22.05),
    (68.45, 22.50),
    (68.30, 22.80),
    (68.15, 23.30),
    (67.95, 23.65),                       # Muonio FI east
    (67.70, 23.60),
    (67.45, 23.45),
    (67.25, 23.60),                       # Kolari FI / Pajala SE
    (67.00, 23.70),
    (66.80, 23.90),
    (66.60, 23.70),
    (66.40, 23.65),
    (66.20, 23.70),
    (66.00, 23.90),
    (65.88, 24.125),                      # the Torne at the twin towns
    (65.842, 24.133),                     # Haparanda SE / Tornio FI
    (65.78, 24.16),                       #   (threaded ~700 m each)
]

_SE_FI_SEA: list[tuple[float, float]] = [ # the Torne mouth -> the
    (65.78, 24.16),                       #   Baltic (Bothnia midline;
    (65.25, 23.85),                       #   Aland stays Finnish,
    (64.70, 23.00),                       #   Maerket unasserted)
    (64.20, 22.00),
    (63.70, 21.05),                       # the Kvarken midline
    (63.00, 20.30),
    (62.00, 19.80),
    (61.00, 19.80),
    (60.45, 19.35),
    (60.30, 19.25),                       # west of Eckeroe (Aland)
    (59.95, 19.45),
    (59.55, 19.95),                       # south corner (open Baltic)
]

_FI_NO: list[tuple[float, float]] = [     # the RU tripoint area ->
    (69.00, 28.80),                       #   Treriksroset (the Teno)
    (69.30, 28.80),
    (69.65, 28.60),
    (69.90, 27.95),
    (70.07, 27.90),
    (70.09, 27.31),                       # Nuorgam (FI north tip)
    (69.91, 27.03),                       # Utsjoki reach
    (69.75, 26.50),
    (69.90, 26.00),
    (69.85, 25.80),
    (69.70, 25.75),
    (69.30, 25.45),                       # Karigasniemi reach
    (69.10, 25.10),
    (68.90, 24.20),
    (68.75, 23.80),
    (68.83, 22.90),
    (68.75, 22.20),
    (68.90, 21.70),
    (69.03, 21.30),
    (69.10, 20.80),
    (69.06, 20.55),                       # Treriksroset
]

_AT_HU: list[tuple[float, float]] = [     # AT/SI/HU tripoint ->
    (46.87, 16.11),                       #   AT/HU/SK tripoint
    (46.94, 16.28),                       # AT/HU line
    (47.01, 16.44),
    (47.10, 16.47),
    (47.26, 16.45),
    (47.40, 16.50),                       # Koszeg HU west
    (47.47, 16.58),
    (47.51, 16.46),                       # Sopron HU salient wrap
    (47.62, 16.43),                       #   (the salient pokes
    (47.71, 16.47),                       #   west into Austria)
    (47.75, 16.57),
    (47.73, 16.72),
    (47.68, 16.78),
    (47.77, 16.85),                       # Neusiedl southeast
    (47.87, 17.05),
    (47.95, 17.05),
    (48.01, 17.16),                       # AT/HU/SK tripoint
]

_AT_SK: list[tuple[float, float]] = [     # AT/HU/SK -> AT/CZ/SK
    (48.01, 17.16),
    (48.10, 17.08),                       # Bratislava SK east
    (48.14, 16.98),                       # the March mouth
    (48.20, 16.97),                       # the March/Morava midline
    (48.35, 16.90),
    (48.50, 16.90),
    (48.62, 16.94),                       # AT/CZ/SK tripoint
]

_CZ_SK: list[tuple[float, float]] = [     # AT/CZ/SK -> CZ/SK/PL
    (48.62, 16.94),                       #   (the White Carpathians,
    (48.70, 17.05),                       #   conservative crest)
    (48.72, 17.20),
    (48.80, 17.45),
    (48.85, 17.55),
    (48.90, 17.70),
    (49.07, 17.95),
    (49.30, 18.15),
    (49.42, 18.40),
    (49.50, 18.57),
    (49.518, 18.846),                     # Hrcava (CZ/SK/PL)
]

_PL_SK: list[tuple[float, float]] = [     # CZ/SK/PL -> PL/SK/UA
    (49.518, 18.846),                     #   (the Tatra/Carpathian
    (49.40, 19.20),                       #   crest, conservative)
    (49.52, 19.50),
    (49.40, 19.78),
    (49.23, 19.93),                       # Zakopane PL north
    (49.40, 20.32),
    (49.30, 20.60),
    (49.40, 20.70),
    (49.30, 21.00),
    (49.42, 21.60),
    (49.30, 22.00),
    (49.089, 22.558),                     # PL/SK/UA tripoint
]

# --- Southeastern Europe (round 4l) ---------------------------------
_SI_HU: list[tuple[float, float]] = [     # AT/SI/HU -> SI/HU/HR
    (46.87, 16.11),
    (46.83, 16.30),
    (46.75, 16.38),
    (46.60, 16.48),                       # Lendava SI west
    (46.47, 16.60),                       # SI/HU/HR tripoint
]

_HR_HU: list[tuple[float, float]] = [     # SI/HU/HR -> HU/HR/RS
    (46.47, 16.60),                       #   (the Mura/Drava midline)
    (46.40, 16.62),
    (46.30, 16.70),
    (46.23, 16.75),
    (46.12, 16.85),
    (46.05, 16.95),
    (45.95, 17.20),
    (45.85, 17.35),
    (45.80, 17.60),
    (45.85, 17.90),
    (45.90, 18.10),
    (45.93, 18.40),
    (45.95, 18.65),                       # Mohacs HU north
    (45.91, 18.82),                       # HU/HR/RS tripoint
]

_HU_SK: list[tuple[float, float]] = [     # AT/HU/SK -> HU/SK/UA
    (48.01, 17.16),                       #   (the Danube + Ipoly,
    (47.95, 17.30),                       #   then the crest)
    (47.87, 17.70),
    (47.75, 18.125),                      # Komarom HU / Komarno SK
    (47.795, 18.73),                      # Esztergom HU / Sturovo SK
    (47.90, 18.80),                       # the Ipoly north
    (48.06, 19.00),
    (48.09, 19.30),                       # Balassagyarmat HU south
    (48.15, 19.52),
    (48.28, 19.90),
    (48.30, 20.30),
    (48.42, 20.80),
    (48.50, 21.20),                       # Kosice SK north
    (48.45, 21.60),
    (48.40, 22.00),
    (48.41, 22.155),                      # HU/SK/UA tripoint
]

_SI_HR: list[tuple[float, float]] = [     # the Dragonja mouth ->
    (45.475, 13.589),                     #   SI/HU/HR (Piran SI north,
    (45.48, 13.63),                       #   Umag HR south)
    (45.475, 13.75),
    (45.46, 13.90),
    (45.48, 13.95),
    (45.47, 14.10),
    (45.48, 14.30),                       # Ilirska Bistrica SI north,
    (45.45, 14.55),                       #   Rijeka HR south
    (45.48, 14.70),
    (45.42, 14.90),
    (45.45, 15.05),                       # the Kolpa reach
    (45.48, 15.15),
    (45.55, 15.25),
    (45.65, 15.35),                       # Metlika SI west
    (45.70, 15.50),
    (45.80, 15.68),                       # (Zagreb HR southeast)
    (45.85, 15.70),                       # the Sotla midline
    (45.95, 15.68),
    (46.08, 15.70),
    (46.17, 15.80),
    (46.24, 16.05),
    (46.30, 16.20),                       # the Mura (Cakovec HR east)
    (46.36, 16.30),
    (46.42, 16.42),
    (46.47, 16.60),                       # SI/HU/HR tripoint
]

_HU_RS: list[tuple[float, float]] = [     # HU/HR/RS -> HU/RS/RO
    (45.91, 18.82),                       #   (conservative; Subotica
    (45.95, 19.10),                       #   RS south; Serbia stays
    (46.10, 19.30),                       #   anchor-resolved)
    (46.17, 19.66),
    (46.13, 19.98),
    (46.18, 20.28),                       # HU/RS/RO tripoint
]

_HU_RO: list[tuple[float, float]] = [     # HU/RS/RO -> HU/UA/RO
    (46.18, 20.28),
    (46.15, 20.80),
    (46.25, 21.18),
    (46.40, 21.28),
    (46.70, 21.45),
    (47.05, 21.65),                       # (Oradea RO east)
    (47.30, 22.05),
    (47.60, 22.45),
    (47.95, 22.90),                       # HU/UA/RO tripoint
]

_HR_BA: list[tuple[float, float]] = [     # the Sava corner -> the
    (44.95, 18.75),                       #   Dubrovnik reach (the
    (45.05, 18.55),                       #   Sava midline west,
    (45.10, 18.30),                       #   Slavonski Brod HR north)
    (45.16, 18.00),
    (45.12, 17.75),
    (45.08, 17.45),
    (45.10, 17.25),
    (45.08, 17.00),
    (45.12, 16.80),
    (45.05, 16.40),                       # the Una reach
    (45.10, 16.30),
    (45.22, 16.00),
    (45.10, 15.78),                       # (Slunj HR west)
    (45.05, 15.77),
    (44.95, 15.75),
    (44.75, 15.78),                       # (Bihac BA east)
    (44.60, 15.85),
    (44.40, 16.00),
    (44.20, 16.10),
    (44.00, 16.30),                       # (Knin HR southwest)
    (43.85, 16.40),
    (43.70, 16.60),
    (43.55, 16.85),
    (43.45, 17.28),                       # (Imotski HR south)
    (43.30, 17.25),
    (43.15, 17.25),
    (43.05, 17.40),
    (43.02, 17.55),
    (42.95, 17.50),                       # the Neum corridor cut:
    (42.91, 17.63),                       #   BA's coast at Neum
    (42.88, 17.76),                       #   (the bay midline;
    (42.80, 17.95),                       #   Pelješac stays HR)
    (42.75, 18.10),
    (42.65, 18.25),                       # (Dubrovnik HR west)
]

_AL_MK: list[tuple[float, float]] = [     # GR tripoint -> AL/MK/XK
    (40.55, 21.05),                       #   (the Prespa/Ohrid lakes)
    (40.85, 20.98),
    (40.90, 20.88),                       # Pogradec AL southwest
    (41.05, 20.72),                       # Ohrid lake midline
    (41.20, 20.60),                       #   (Struga/Ohrid MK east)
    (41.32, 20.52),
    (41.52, 20.49),                       # Debar MK east
    (41.70, 20.55),
    (41.85, 20.60),
    (41.94, 20.62),                       # AL/MK/XK tripoint
]

_AL_ME: list[tuple[float, float]] = [     # AL/ME/XK -> the Adriatic
    (42.55, 20.07),                       #   (Lake Shkodra midline,
    (42.52, 19.80),                       #   the Bojana mouth)
    (42.47, 19.58),
    (42.37, 19.40),                       # (Podgorica ME northwest)
    (42.25, 19.28),
    (42.08, 19.18),                       # (Shkoder AL east)
    (41.95, 19.31),
    (41.865, 19.375),                     # the Bojana mouth (Ulcinj
]                                         #   ME northwest)

_ME_BA: list[tuple[float, float]] = [     # the HR reach -> RS/BA/ME
    (42.65, 18.55),                       #   (conservative on both
    (42.80, 18.70),                       #   rings' behalf — the
    (42.95, 18.85),                       #   shared believed line)
    (43.10, 19.00),
    (43.25, 19.10),
    (43.40, 19.20),
    (43.50, 19.22),                       # RS/BA/ME area corner
]

# --- The Baltics (round 4m).  Shared EE/LV land + Gulf-of-Riga
# chains (Ruhnu EE inside the gulf, Kolka LV below the split; the
# conjoined Valga/Valka pair is documented unasserted), the Narva
# river (Narva EE / Ivangorod RU twins threaded), Lake Peipus
# midline, and conservative RU/BY edges.
_EE_LV: list[tuple[float, float]] = [     # the Ainazi coast -> the
    (57.875, 24.37),                      #   EE/LV/RU tripoint
    (57.90, 24.40),
    (57.85, 24.80),
    (57.85, 25.40),
    (57.77, 26.04),                       # Valga EE / Valka LV (the
    (57.60, 26.00),                       #   conjoined pair concedes)
    (57.55, 26.50),
    (57.60, 27.00),
    (57.55, 27.35),                       # EE/LV/RU tripoint area
]

_EE_LV_GULF: list[tuple[float, float]] = [  # the Gulf of Riga split
    (57.875, 24.37),                      #   (EE north: Ruhnu in;
    (57.78, 23.85),                       #   LV south: Kolka out)
    (57.73, 23.25),
    (57.76, 22.70),
    (57.79, 22.30),
    (57.72, 21.80),                       # the Irbe strait midline
]

_LV_LT: list[tuple[float, float]] = [     # the Butinge coast -> the
    (56.06, 21.04),                       #   LV/LT/BY tripoint
    (56.35, 21.50),                       #   (conservative-as-shared)
    (56.20, 22.20),
    (56.30, 22.90),
    (56.35, 23.70),
    (56.20, 24.50),
    (56.00, 25.00),
    (55.70, 26.00),
    (55.67, 26.60),                       # LV/LT/BY tripoint area
]

_RO_BG: list[tuple[float, float]] = [     # the Timok mouth -> the
    (44.21, 22.68),                       #   Black Sea (the Danube
    (44.10, 22.75),                       #   midline + the Dobruja
    (44.00, 22.90),                       #   land line)
    (43.85, 23.20),
    (43.78, 23.90),
    (43.72, 24.40),
    (43.75, 24.90),
    (43.70, 25.40),
    (43.875, 25.97),                      # Giurgiu RO / Ruse BG
    (44.10, 26.60),
    (44.00, 27.40),                       # the Dobruja line
    (43.85, 28.00),
    (43.74, 28.58),                       # Vama Veche (the coast)
]

_DK_SE: list[tuple[float, float]] = [     # the Oeresund + Kattegat
    (55.35, 12.62),                       #   midline, S -> N (shared
    (55.50, 12.70),                       #   VERBATIM by DK and SE):
    (55.60, 12.85),                       #   Falsterbo SE east, east
    (55.75, 12.75),                       #   of Saltholm DK, west of
    (55.86, 12.64),                       #   Ven SE, Helsingoer DK /
    (55.96, 12.66),                       #   Helsingborg SE split
    (56.035, 12.655),
    (56.25, 12.20),
    (56.60, 12.00),
    (56.75, 12.05),                       # Anholt DK west
    (57.10, 11.90),
    (57.40, 11.50),                       # Laesoe DK west
    (57.75, 11.20),
]

_IT_SI: list[tuple[float, float]] = [     # tripoint -> the Adriatic
    (46.52, 13.70),
    (46.50, 13.67),                       # Tarvisio IT west
    (46.44, 13.60),
    (46.34, 13.48),                       # Bovec SI east
    (46.25, 13.50),
    (46.18, 13.50),
    (46.08, 13.52),                       # Cividale IT west
    (45.99, 13.57),
    (45.963, 13.640),                     # Gorizia IT / Nova Gorica SI
    (45.945, 13.640),                     #   (the Transalpina border
    (45.92, 13.61),                       #   square splits the town)
    (45.88, 13.58),
    (45.82, 13.58),                       # Monfalcone IT west
    (45.75, 13.64),
    (45.68, 13.86),                       # Karst rim (Trieste IT west)
    (45.62, 13.90),
    (45.59, 13.715),                      # coast (Muggia IT /
]                                         #   Koper SI)

# --- Southeast Asia (round 4n).  tzdata 2024 merged Asia/Phnom_Penh
# and Asia/Vientiane into Asia/Bangkok, so Cambodia and Laos have NO
# anchors at all: Phnom Penh resolved to Vietnam and Siem Reap /
# Vientiane / Luang Prabang to Thailand before these rings.  The
# TH/LA border is the Mekong where the river IS the border (twin
# cities split at the midline: Vientiane/Si Chiang Mai, Nong Khai,
# Bueng Kan/Pakxan, Nakhon Phanom/Thakhek, Mukdahan/Savannakhet) and
# a conservative range chain where Laos' Xaignabouli province lies
# WEST of the river; the TH/KH border follows the Dangrek escarpment
# (Preah Vihear on the Cambodian side per ICJ 1962/2013); the TH/MY
# chain threads the Betong and Sadao salients and the
# Tarutao(TH)/Langkawi(MY) 10 km strait; Myanmar keeps no ring
# (it has its own tz anchor) so the TH/MM edge dips conservatively
# at the uncertain range segments.

_MEKONG_GT: list[tuple[float, float]] = [  # Golden Triangle -> the
    (20.355, 100.092),                     #   river's exit into Laos
    (20.31, 100.26),                       #   (TH/LA, NW -> SE)
    (20.27, 100.41),                       # Chiang Khong / Huay Xai
    (20.18, 100.50),                       # departure (Xaignabouli
]                                          #   is west of the river)

_TH_LA_RANGE: list[tuple[float, float]] = [  # the overland chain
    (19.95, 100.52),                       #   west of Xaignabouli,
    (19.60, 100.58),                       #   N -> S (Phu Chi Fa TH
    (19.35, 100.80),                       #   on the cliff edge)
    (19.20, 101.15),                       # the Nan bulge east
    (18.80, 101.25),
    (18.30, 101.15),
    (17.95, 101.17),                       # the Nam Heuang bend:
    (17.70, 101.32),                       #   Tha Li TH south,
    (17.655, 101.42),                      #   Kenethao LA north
    (17.80, 101.52),
    (17.907, 101.64),                      # Mekong rejoin (Chiang
]                                          #   Khan TH on the S bank)

_MEKONG_LOWER: list[tuple[float, float]] = [  # Chiang Khan -> the
    (17.93, 101.85),                       #   lower departure,
    (18.055, 102.30),                      #   midline (TH S/W bank,
    (17.952, 102.60),                      #   LA N/E bank):
    (17.893, 102.74),                      # Vientiane / Si Chiang Mai
    (18.10, 103.10),                       #   then Nong Khai TH
    (18.375, 103.64),                      # Bueng Kan / Pakxan
    (18.33, 103.95),
    (18.15, 104.35),
    (17.80, 104.63),
    (17.40, 104.79),                       # Nakhon Phanom / Thakhek
    (17.00, 104.74),                       # That Phanom TH
    (16.55, 104.737),                      # Mukdahan / Savannakhet
    (16.04, 105.24),                       # Khemmarat TH
    (15.75, 105.40),
    (15.42, 105.615),                      # Pha Taem TH cliffs west
    (15.23, 105.53),                       # departure below the Mun
]

_TH_LA_S: list[tuple[float, float]] = [    # overland to the Emerald
    (15.117, 105.497),                     #   Triangle (Chong Mek /
    (14.80, 105.51),                       #   Vang Tao crossing),
    (14.55, 105.42),                       #   N -> S
    (14.41, 105.22),                       # TH/LA/KH tripoint
]

_TH_KH: list[tuple[float, float]] = [      # the Dangrek escarpment
    (14.41, 105.22),                       #   + the SE plain, E -> W
    (14.38, 104.95),                       #   (TH north, KH south)
    (14.405, 104.68),                      # Preah Vihear KH (ICJ)
    (14.36, 104.45),
    (14.35, 104.05),                       # Anlong Veng KH south
    (14.36, 103.70),
    (14.36, 103.25),                       # Ta Muen temples ridge
    (14.42, 102.80),
    (14.40, 102.90),                       # the escarpment west end
    (14.05, 102.92),                       # Ta Phraya TH west
    (13.75, 102.58),
    (13.66, 102.55),                       # Aranyaprathet / Poipet
    (13.55, 102.53),
    (13.30, 102.50),
    (13.00, 102.45),
    (12.84, 102.47),                       # Pong Nam Ron / Pailin
    (12.45, 102.62),
    (12.20, 102.75),
    (12.00, 102.82),
    (11.78, 102.925),                      # the Khlong Yai strip
    (11.645, 102.918),                     # coast (Hat Lek TH /
]                                          #   Cham Yeam KH)

_TH_MY: list[tuple[float, float]] = [      # TH/MY, E -> W: the Golok
    (6.275, 102.095),                      #   mouth (Tak Bai TH /
    (6.03, 101.972),                       #   Pengkalan Kubor MY),
    (5.87, 101.92),                        #   the Golok river
    (5.79, 101.70),                        #   (Sungai Kolok conjoined
    (5.76, 101.48),                        #   unasserted), the range
    (5.80, 101.30),
    (5.90, 101.25),                        # the Betong salient wrap:
    (5.72, 101.15),                        #   Betong TH inside,
    (5.61, 101.08),                        #   Pengkalan Hulu MY west
    (5.70, 101.02),
    (5.92, 101.00),
    (6.25, 100.85),
    (6.52, 100.60),
    (6.53, 100.424),                       # Sadao TH / Bukit Kayu
    (6.61, 100.36),                        #   Hitam MY
    (6.68, 100.32),                        # Padang Besar MY south
    (6.66, 100.22),                        #   (conjoined unasserted)
    (6.52, 100.145),                       # west coast (Satun TH /
    (6.50, 99.90),                         #   Kuala Perlis MY); the
    (6.48, 99.70),                         #   Tarutao TH / Langkawi
    (6.48, 99.45),                         #   MY strait thread
]

_UG_RW: list[tuple[float, float]] = [      # the UG/RW border, W -> E
    (-1.386, 29.595),                      #   (shared VERBATIM):
    (-1.38, 29.68),                        #   Mount Sabyinyo's
    (-1.30, 29.90),                        #   three-country summit,
    (-1.22, 30.10),                        #   Kisoro/Kabale UG north
    (-1.05, 30.35),                        #   vs Musanze RW south,
    (-1.00, 30.47),                        #   to the Kagera tripoint
]

_ZM_ZW: list[tuple[float, float]] = [      # the ZM/ZW border, W -> E
    (-17.80, 25.30),                       #   (shared VERBATIM): the
    (-17.921, 25.857),                     #   Kazungula quadripoint,
    (-17.98, 26.20),                       #   Victoria Falls midline
    (-17.93, 26.80),                       #   (Livingstone ZM north,
    (-17.55, 27.30),                       #   Vic Falls town ZW
    (-17.10, 27.85),                       #   south), the Kariba
    (-16.80, 28.30),                       #   lake axis (Siavonga ZM
    (-16.62, 28.60),                       #   / Kariba ZW at the
    (-16.53, 28.765),                      #   dam), Chirundu, Mana
    (-16.028, 28.850),                     #   Pools ZW south bank,
    (-15.88, 29.10),                       #   to the MZ tripoint at
    (-15.73, 29.42),                       #   the Luangwa confluence
    (-15.62, 30.10),
    (-15.615, 30.415),
]

_LA_KH: list[tuple[float, float]] = [      # LA/KH border, E -> W
    (14.69, 107.50),                       # LA/VN/KH tripoint region
    (14.45, 107.10),                       #   (conservative)
    (14.35, 106.50),
    (14.10, 106.20),
    (13.94, 105.95),                       # the Mekong crossing south
    (14.05, 105.75),                       #   of Khone Falls (Don Det
    (14.25, 105.50),                       #   LA north, Stung Treng
    (14.41, 105.22),                       #   KH south); the Emerald
]                                          #   Triangle tripoint

_JOHOR_STRAIT: list[tuple[float, float]] = [  # MY/SG midline, W -> E
    (1.335, 103.615),                      # Tuas second link west
    (1.36, 103.64),
    (1.425, 103.672),
    (1.448, 103.755),                      # the Causeway (JB north,
    (1.432, 103.85),                       #   Woodlands south)
    (1.435, 103.96),
    (1.441, 104.05),                       # north of Pulau Tekong
    (1.41, 104.115),                       # Tekong east / Pengerang
    (1.36, 104.12),                        #   MY west
    (1.30, 104.18),                        # the east exit
]

_TR_IQ: list[tuple[float, float]] = [     # the TR/IQ border, W -> E
    (37.08, 42.36),                       # TR/SY/IQ Tigris tripoint
    (37.20, 42.60),                       # Silopi TR N / Zakho IQ S
    (37.15, 42.95),                       # the Habur crossing dip
    (37.25, 43.30),
    (37.20, 43.62),                       # Cukurca TR / Amadiya IQ
    (37.30, 44.00),
    (37.25, 44.40),                       # Semdinli TR north
    (37.15, 44.78),                       # TR/IQ/IR tripoint
]

# --- Central America + Hispaniola shared chains (round 4p).  The
# MX-facing runs reuse the MX ring's Guatemala/Belize vertices
# VERBATIM (coincident edges, no dead strip); everything else is
# authored once here and spliced into both neighbours.
_MX_GT: list[tuple[float, float]] = [     # the Peten parallel +
    (17.8167, -89.15),                    #   Usumacinta/Chiapas chain
    (17.8167, -90.99),                    #   (MX ring verbatim,
    (17.25, -91.43),                      #   tripoint -> Suchiate
    (16.4, -90.4),                        #   mouth)
    (16.07, -90.43),
    (16.08, -91.74),
    (15.5, -92.12),
    (15.0, -92.17),
    (14.68, -92.147),                     # Cd. Hidalgo / Tecun Uman
    (14.54, -92.23),                      # Suchiate mouth
]
_MX_BZ: list[tuple[float, float]] = [     # Boca Bacalar Chico -> the
    (18.19, -87.83),                      #   Rio Hondo -> tripoint
    (18.4, -88.05),                       #   (MX ring verbatim)
    (18.49, -88.30),                      # Hondo mouth (Corozal BZ)
    (18.2, -88.6),
    (17.95, -88.9),
    (17.8167, -89.15),                    # MX/BZ/GT tripoint (exact)
]
_GT_BZ: list[tuple[float, float]] = [     # the 1859 adjacency line +
    (15.885, -88.93),                     #   the Sarstoon, S -> N
    (15.89, -89.15),                      # Sarstoon upriver
    (15.90, -89.227),                     # Gracias a Dios falls
    (16.50, -89.20),
    (17.07, -89.146),                     # Melchor GT / Benque BZ
    (17.8167, -89.15),                    # Aguas Turbias tripoint
]
_GT_HN: list[tuple[float, float]] = [     # Motagua mouth -> the
    (15.70, -88.22),                      #   Merendon -> tripoint
    (15.40, -88.68),
    (15.00, -88.84),
    (14.837, -89.24),                     # El Florido (Copan HN east)
    (14.56, -89.24),                      # Esquipulas GT west
    (14.42, -89.355),                     # GT/HN/SV tripoint
]
_GT_SV: list[tuple[float, float]] = [     # tripoint -> Lago Guija ->
    (14.42, -89.355),                     #   the Paz mouth
    (14.39, -89.50),
    (14.22, -89.58),
    (13.94, -90.05),
    (13.74, -90.13),                      # Paz River mouth
]
_SV_HN: list[tuple[float, float]] = [     # tripoint -> Goascoran, W->E
    (14.42, -89.355),
    (14.405, -89.21),                     # Citala SV / N. Ocotepeque
    (14.32, -89.03),
    (14.23, -88.72),
    (14.04, -88.48),
    (14.02, -88.23),
    (13.99, -88.07),                      # north of Perquin (the
    (13.80, -87.85),                      #   Nahuaterique concession)
    (13.57, -87.77),                      # El Amatillo crossing
    (13.41, -87.79),                      # Goascoran mouth (Fonseca)
]
_SV_HN_FONSECA: list[tuple[float, float]] = [   # the 1992 ICJ award:
    (13.41, -87.79),                      #   Meanguera SV in,
    (13.28, -87.74),                      #   El Tigre HN out
    (13.13, -87.66),
]
_HN_NI: list[tuple[float, float]] = [     # Fonseca -> the Coco ->
    (12.98, -87.34),                      #   Cabo Gracias a Dios
    (13.02, -87.00),
    (13.30, -86.92),
    (13.42, -86.77),
    (13.48, -86.70),                      # the El Espino dip
    (13.77, -86.60),                      # Las Manos (Dipilto NI S)
    (13.85, -86.40),
    (14.05, -86.20),
    (14.02, -85.93),                      # Trojes HN N / Jalapa NI S
    (13.95, -85.75),
    (14.05, -85.38),
    (14.30, -84.90),
    (14.55, -84.40),
    (14.76, -83.97),                      # Waspam NI (south bank)
    (14.85, -83.40),
    (14.99, -83.15),                      # Cabo Gracias a Dios
]
_NI_CR: list[tuple[float, float]] = [     # Salinas Bay -> the lake ->
    (11.07, -85.74),                      #   the San Juan (NI's
    (11.21, -85.60),                      #   river, CR's right bank)
    (11.15, -85.05),
    (11.08, -84.75),                      # San Carlos lake exit
    (10.98, -84.40),                      # El Castillo reach
    (10.83, -84.05),
    (10.92, -83.72),                      # San Juan del Norte mouth
]
_CR_PA: list[tuple[float, float]] = [     # Sixaola mouth -> the
    (9.58, -82.563),                      #   cordillera -> Burica
    (9.52, -82.615),                      # Sixaola CR / Guabito PA
    (9.48, -82.80),
    (9.40, -82.94),
    (9.05, -82.90),
    (8.82, -82.92),                       # San Vito CR / Rio Sereno
    (8.53, -82.845),                      # Paso Canoas (border town)
    (8.40, -82.91),
    (8.03, -82.884),                      # Punta Burica tip
]
_DO_HT: list[tuple[float, float]] = [     # Massacre mouth -> the
    (19.715, -71.782),                    #   lakes -> Pedernales
    (19.63, -71.745),
    (19.55, -71.716),                     # Dajabon DO / Ouanaminthe
    (19.30, -71.735),
    (19.08, -71.715),                     # Banica DO (the Artibonite)
    (18.90, -71.72),
    (18.86, -71.74),                      # Comendador DO / Belladere
    (18.70, -71.76),
    (18.60, -71.90),                      # between Azuei (HT) and
    (18.50, -71.90),                      #   Enriquillo (DO); Jimani
    (18.42, -71.88),                      #   DO / Malpasse HT
    (18.30, -71.85),
    (18.10, -71.77),
    (18.033, -71.748),                    # Pedernales / Anse-a-Pitres
]

# --- Levant shared chains (round 4q).
_IL_LB: list[tuple[float, float]] = [     # the Blue Line, W -> E;
    (33.09, 35.105),                      #   Rosh HaNikra coast
    (33.095, 35.35),
    (33.105, 35.50),
    (33.245, 35.555),                     # the Metula finger wrap
    (33.290, 35.565),                     #   (Metula IL inside,
    (33.290, 35.60),                      #   Kfar Kila / Marjayoun
    (33.265, 35.625),                     #   LB north; Ghajar village
]                                         #   resolves IL — the whole
                                          #   village is Israeli-
                                          #   administered de facto
_LB_GOLAN: list[tuple[float, float]] = [  # LB vs the Golan dead strip
    (33.265, 35.625),                     #   up to the Hermon crest
    (33.32, 35.72),
    (33.40, 35.87),
]
_LB_SY: list[tuple[float, float]] = [     # Hermon -> the coast, S->N
    (33.40, 35.87),                       # Mount Hermon crest
    (33.55, 36.02),
    (33.70, 36.00),                       # Zabadani SY stays east
    (33.78, 36.10),
    (33.90, 36.30),                       # Baalbek LB west
    (34.20, 36.60),
    (34.42, 36.60),                       # Qaa LB / Qusayr SY
    (34.52, 36.48),
    (34.60, 36.32),                       # Talkalakh SY north
    (34.63, 35.98),                       # Arida coast crossing
]
_IL_WB: list[tuple[float, float]] = [     # the 1949 Green Line,
    (32.40, 35.50),                       #   river NW -> Dead Sea;
    (32.52, 35.43),                       #   twins threaded: Umm
    (32.555, 35.28),                      #   al-Fahm / Baqa / Tayibe
    (32.50, 35.17),                       #   IL vs Jenin / Tulkarm /
    (32.46, 35.065),                      #   Qalqilya PS
    (32.33, 35.005),
    (32.26, 35.025),
    (32.23, 34.95),
    (32.14, 34.96),
    (32.00, 35.01),
    (31.86, 35.02),
    (31.82, 34.98),                       # the Latrun approach
    (31.80, 35.08),                       # the Jerusalem corridor
    (31.83, 35.16),
    (31.85, 35.25),                       # Ramallah stays north
    (31.83, 35.31),
    (31.75, 35.29),
    (31.72, 35.21),                       # Bethlehem stays south
    (31.71, 35.15),
    (31.66, 35.09),
    (31.40, 34.98),                       # south Hebron hills
    (31.36, 35.22),
    (31.53, 35.46),                       # Dead Sea NW shore
]
_GAZA_FENCE: list[tuple[float, float]] = [    # Gaza perimeter, coast
    (31.59, 34.49),                       #   N corner -> Kerem Shalom
    (31.56, 34.56),                       # Erez (Sderot IL east)
    (31.32, 34.40),
    (31.22, 34.28),                       # Kerem Shalom corner
]

# (country_code, subdivision|None) -> ring of (lat, lon) vertices.
# subdivision None marks a COUNTRY-level ring (exact country
# assignment; admin-1 still resolves through the anchor tables,
# constrained to this country).  Vertices on meridian/parallel legal
# borders are exact; others are documented approximations (see module
# docstring).
POLYGONS: dict[tuple[str, str | None], list[tuple[float, float]]] = {
    # --- United States: rectilinear interior states ---
    ("US", "Wyoming"): [
        (41.0, -111.046), (45.0, -111.046), (45.0, -104.052),
        (43.0, -104.0526), (41.0, -104.0526)],
    ("US", "Colorado"): [
        (37.0, -109.045), (41.0, -109.045), (41.0, -102.0517),
        (37.0, -102.0517)],
    ("US", "Utah"): [
        (37.0, -114.041), (42.0, -114.041), (42.0, -111.046),
        (41.0, -111.046), (41.0, -109.045), (37.0, -109.045)],
    ("US", "New Mexico"): [
        (37.0, -109.045), (37.0, -103.042), (32.0, -103.042),
        (32.0, -106.62), (31.78, -106.53), (31.78, -108.21),
        (31.33, -108.21), (31.33, -109.045)],
    # Arizona's west edge is the Colorado River polyline shared
    # verbatim with Nevada (Lake Mohave reach) and California
    # (_COLORADO_RIVER below): coincident edges, no overlap, no dead
    # strip, and the river twin towns split correctly on both banks.
    ("US", "Arizona"): [
        (31.33, -109.045), (37.0, -109.045), (37.0, -114.05),
        (36.1, -114.05), (36.12, -114.4),
        (35.168, -114.5715),                   # Laughlin/Bullhead split
        (35.1, -114.60),
        *_COLORADO_RIVER,
        (32.49, -114.81), (31.33, -111.07)],
    ("US", "Kansas"): [
        (37.0, -102.0517), (40.0, -102.0517),
        *_MISSOURI_RIVER_KS,
        (37.0, -94.617)],
    # Nebraska's river borders are the shared channel polylines: the
    # old straight-chord east edge provably claimed Council Bluffs IA.
    ("US", "Nebraska"): [
        (40.0, -102.0517), (41.0, -102.0517), (41.0, -104.0526),
        (43.0, -104.0526), (43.0, -98.47),
        *_MISSOURI_RIVER_SD_NE,
        *_MISSOURI_RIVER_IA_NE[1:]],
    ("US", "North Dakota"): [
        (45.935, -104.045), (49.0, -104.045),
        *_RED_RIVER],
    # South Dakota's NE corner follows the Bois de Sioux / Lake
    # Traverse / Browns Valley gap / Big Stone Lake chain (vertices
    # shared verbatim with Minnesota): Browns Valley and Ortonville
    # stay Minnesota, Big Stone City stays South Dakota.
    ("US", "South Dakota"): [
        # west edge: -104.045 (shared with Montana) north of the 45N
        # survey jog, -104.05 (east of Wyoming's -104.053) south of it
        (45.0, -104.05), (45.0, -104.045),
        (45.935, -104.045), (45.935, -96.56),
        (45.86, -96.58), (45.59, -96.85),                   # Traverse
        (45.3, -96.45),                                     # Big Stone
        (44.0, -96.45),
        *_BIG_SIOUX,
        *[(la, lo) for la, lo in reversed(_MISSOURI_RIVER_SD_NE)][1:],
        (43.0, -104.05)],
    # Minnesota: the west side is exact/river-accurate (the shared
    # -96.45 meridian, the Big Stone/Traverse lake chain, the Red
    # River polyline) and the 49N, NW-Angle -95.153 meridian and Iowa
    # 43.5N borders are exact; the east side (Rainy River reach aside)
    # is CONSERVATIVE — pulled inside the believed border so the ring
    # never claims Ontario/Wisconsin/Iowa ground, with the strip
    # falling back to anchors.  The Rainy River vertices split the
    # border twin towns (Baudette vs Rainy River ON, International
    # Falls vs Fort Frances ON).
    ("US", "Minnesota"): [
        (43.5, -96.45),                   # IA/SD/MN corner (exact)
        (45.3, -96.45),                   # Big Stone outlet/Ortonville
        (45.59, -96.85),                  # Browns Valley gap
        (45.86, -96.58),                  # Lake Traverse head
        *_RED_RIVER[::-1],                # up the Red to 49N
        (49.0, -95.153),                  # 49N exact to the NW point
        (49.389, -95.153),                # NW Angle meridian (exact)
        (49.355, -95.05),                 # Angle Inlet shore
        (49.32, -94.84),                  # Angle waters (Oak Island)
        (48.95, -94.70),                  # MN lake waters
        (48.86, -94.687),                 # Rainy River mouth
        (48.715, -94.60),                 # Baudette/Rainy River ON
        (48.61, -93.40),                  # Intl Falls/Fort Frances
        (48.38, -92.85),                  # Rainy Lake conservative
        (48.2, -92.3),                    # Crane Lake conservative
        (47.95, -91.5),                   # boundary waters conservative
        (47.90, -90.8),                   # Gunflint conservative
        (47.99, -90.1),                   # Pigeon reach conservative
        (47.985, -89.70),                 # Grand Portage
        (47.96, -89.57),                  # tip, S of the Pigeon mouth
        (47.70, -90.25),                  # off Grand Marais
        (47.00, -91.55),                  # off Two Harbors
        (46.80, -91.97),                  # off the Lester River
        (46.75, -92.05),                  # Minnesota Point (outer spit
                                          # left to anchors)
        (46.74, -92.10),                  # St. Louis bay midline
        (46.67, -92.19),                  # Oliver reach midline
        (46.60, -92.32),                  # conservative W of the due-S
        (46.2, -92.32),                   # WI line (-92.29)
        (45.95, -92.85),                  # upper St. Croix conservative
        (45.40, -92.78),
        (45.05, -92.88),
        (44.75, -92.95),                  # below Hastings
        (43.5, -91.7)],                   # inland of the Mississippi
                                          # valley; closes along 43.5N
    ("US", "Montana"): [
        (45.0, -111.05), (45.0, -104.045), (49.0, -104.045),
        (49.0, -116.05), (48.0, -116.05), (46.6, -114.6),   # divide
        (45.6, -114.5), (45.56, -113.45), (44.95, -112.8),
        (44.5, -112.3), (44.56, -111.3),
        (44.62, -111.052)],                  # West Yellowstone salient
    ("US", "Oklahoma"): [
        (37.0, -103.002), (37.0, -94.617),
        (36.498, -94.617),                    # MO/AR corner (shared)
        (35.5, -94.43),
        (33.87, -94.48), (33.8, -95.5), (33.9, -96.9),       # Red R.
        (34.1, -98.1), (34.15, -98.6), (34.4, -99.4),
        (34.56, -99.99), (36.5, -100.00), (36.5, -103.002)],
    # --- Canada: prairie provinces ---
    ("CA", "Alberta"): [
        (49.0, -110.005), (49.0, -114.06), (50.5, -115.3),  # divide
        (51.5, -116.8), (52.4, -117.8), (53.0, -119.0),
        (53.8, -119.9), (54.0, -120.0), (60.0, -120.0),
        (60.0, -110.005)],
    ("CA", "Saskatchewan"): [
        (49.0, -110.005), (60.0, -110.005), (60.0, -102.0),
        (55.0, -101.8), (49.0, -101.36)],
    ("CA", "Manitoba"): [
        (49.0, -101.36), (55.0, -101.8), (60.0, -102.0),
        (60.0, -94.8),                                       # coast
        (56.9, -88.9), (54.5, -92.5), (52.0, -95.0),
        # exact NW-Angle meridian tail: coincident with Minnesota's
        # west edge (no sliver overlap over Buffalo/Muskeg Bay)
        (49.389, -95.153), (49.0, -95.153)],
    # --- Australia: state borders are meridians/parallels ---
    ("AU", "Western Australia"): [
        (-36.0, 110.0), (-12.0, 110.0), (-12.0, 129.0),
        (-36.0, 129.0)],
    ("AU", "Northern Territory"): [
        (-26.0, 129.0), (-10.5, 129.0), (-10.5, 138.0),
        (-26.0, 138.0)],
    ("AU", "South Australia"): [
        (-39.0, 129.0), (-26.0, 129.0), (-26.0, 141.0),
        (-39.0, 141.0)],
    # QLD's sea edge stays south of PNG's coast (Port Moresby -9.44,
    # the Milne Bay peninsula to -10.7/150.7, Louisiades -11.3/153):
    # the -10.5 cap keeps Cape York (-10.69) and Thursday Island
    # (-10.58) while leaving the far Torres Strait islands to the
    # anchor fallback
    ("AU", "Queensland"): [
        (-26.0, 138.0), (-10.5, 138.0), (-10.5, 143.5),
        (-12.5, 147.0), (-13.5, 152.0), (-14.0, 155.0),
        (-28.16, 155.0), (-28.16, 153.55), (-28.25, 152.0),
        (-28.7, 150.0), (-29.0, 148.95), (-29.0, 141.0),
        (-26.0, 141.0)],
    # New South Wales carries a keyhole cut for the Australian Capital
    # Territory enclave (attached at the Murray vertex; even-odd
    # parity makes the pentagon interior fall OUT of NSW, so Canberra
    # resolves ACT through the anchors — round-4g anchor
    # cross-validation caught it resolving New South Wales); the
    # pentagon's east edge stays west of Queanbeyan NSW.
    ("AU", "New South Wales"): [
        (-29.0, 141.0), (-29.0, 148.95), (-28.7, 150.0),
        (-28.25, 152.0), (-28.16, 153.55), (-28.16, 155.0),
        (-37.6, 151.0),                                      # ocean
        (-37.51, 149.98), (-36.8, 148.2),                    # Murray
        (-35.93, 148.76),                                    # ACT cut
        (-35.12, 148.76), (-35.12, 149.15),                  # ACT cut
        (-35.33, 149.23), (-35.93, 149.10),                  # ACT cut
        (-35.93, 148.76),                                    # cut closes
        (-36.1, 147.0), (-36.0, 146.0), (-36.12, 144.75),
        (-35.33, 143.55), (-34.58, 142.77), (-34.19, 142.16),
        (-34.0, 141.0)],
    ("AU", "Victoria"): [
        (-34.0, 141.0), (-34.19, 142.16), (-34.58, 142.77),
        (-35.33, 143.55), (-36.12, 144.75), (-36.0, 146.0),
        (-36.1, 147.0), (-36.8, 148.2), (-37.51, 149.98),
        (-39.2, 147.0), (-39.2, 141.0)],                     # ocean
    ("AU", "Tasmania"): [
        (-44.5, 143.5), (-39.5, 143.5), (-39.5, 149.0),
        (-44.5, 149.0)],
    # British Columbia: 49N south (exact), 120W and 60N exact, the
    # Alberta divide and the Washington marine chain shared verbatim
    # (coincident edges); the Alaska-panhandle border is conservative
    # on the BC side (~10-30 km inside the true line, a dead strip to
    # anchors) EXCEPT Portland Canal, threaded so Stewart stays BC and
    # Hyder AK stays out; Dixon Entrance stays south of the A-B line,
    # the ocean edge generous around Vancouver Island and Haida Gwaii.
    ("CA", "British Columbia"): [
        (60.0, -120.0),
        (54.0, -120.0), (53.8, -119.9), (53.0, -119.0),     # Alberta
        (52.4, -117.8), (51.5, -116.8), (50.5, -115.3),     # divide
        (49.0, -114.06),
        (49.0, -123.15),                                    # 49N exact
        (48.78, -123.05), (48.6, -123.2), (48.45, -123.25), # Haro/
        (48.27, -123.54), (48.28, -124.0), (48.38, -124.45),# Juan de F.
        (48.48, -124.75), (48.50, -124.95),                 # (WA shared)
        (48.45, -125.4), (49.5, -127.3), (50.8, -129.3),    # ocean
        (51.8, -131.5), (54.0, -133.8),                     # Haida Gwaii
        (54.49, -132.5), (54.5, -131.0),                    # Dixon Entr.
        (54.55, -130.7),                                    # Portland In.
        (55.3, -129.95), (55.90, -130.0),
        (55.936, -129.99),                                  # Stewart
        (56.2, -130.0), (56.6, -131.0), (57.3, -131.8),     # panhandle
        (58.1, -132.9), (58.7, -133.7), (59.1, -134.2),     # (conserv.)
        (59.45, -134.6), (59.7, -135.2),                    # White Pass
        (59.75, -136.2), (59.3, -137.3),                    # Fairweather
        (59.7, -138.3), (60.0, -139.0)],                    # YT corner
    # --- Canada: territories (round 4).  The 60N parallel south
    # borders and the 141W Yukon/Alaska meridian are EXACT; the
    # Yukon/NWT divide line and the NWT/Nunavut line are conservative
    # on BOTH sides (each ring stays ~1-2 deg inside the believed
    # boundary, leaving a dead strip to the anchor fallback rather
    # than risking a wrong exact claim).
    # --- Ontario (round 4h): almost every border already exists as a
    # US-side chain — the Minnesota Rainy/boundary-waters run, the
    # Manitoba east chain, the New York St. Lawrence/Ontario/Niagara/
    # Erie run, the Pennsylvania/Ohio lake edges and the whole
    # Michigan Detroit/St. Clair/Huron/St. Marys/Superior chain are
    # reused VERBATIM (coincident edges; the US-conservative lake
    # vertices mean Ontario claims the open-water strip up to them,
    # which misassigns nothing).  New geometry: the Hudson/James Bay
    # offshore edge (Fort Severn/Peawanuck/Attawapiskat/Moosonee in),
    # the exact -79.518 Quebec meridian, the Timiskaming/Ottawa River
    # midline (Ottawa in, Gatineau out; Pembroke in; Temiscaming QC
    # out), the Hawkesbury/Grenville split and the Pointe-Fortune
    # land line, leaving the Dundee/Akwesasne strip south of the
    # St. Lawrence to Quebec.
    ("CA", "Ontario"): [
        (49.389, -95.153),                    # NW Angle tripoint — the
                                              #   meridian below 49.389
                                              #   is MB/MN (the Angle),
                                              #   not Ontario; the ring
                                              #   closes along MN's
                                              #   Angle water chain
        (52.0, -95.0),                        # MB chain (shared)
        (54.5, -92.5),                        # MB chain (shared)
        (56.9, -88.9),                        # MB coast corner (shared)
        (57.0, -88.0),                        # Hudson Bay offshore
        (55.6, -85.2),                        # bay coast (Peawanuck in)
        (55.35, -82.6),                       # Cape Henrietta Maria
        (53.0, -81.9),                        # James Bay (Attawapiskat)
        (51.5, -80.2),                        # Moosonee in
        (51.4, -79.518),                      # QC corner (meridian exact)
        (47.5, -79.518),                      # Timiskaming head (exact)
        (47.2, -79.43),                       # lake midline
        (46.7, -79.12),                       # Temiscaming QC out
        (46.32, -78.70),                      # Mattawa reach
        (46.2, -77.7),                        # Ottawa River midline
        (45.86, -77.11),                      # Pembroke in
        (45.58, -76.25),                      # river midline
        (45.45, -75.95),                      # river midline
        (45.43, -75.70),                      # Ottawa / Gatineau split
        (45.53, -75.25),                      # river midline east
        (45.62, -74.60),                      # Hawkesbury / Grenville
        (45.57, -74.38),                      # Pointe-Fortune (land line)
        (45.18, -74.33),                      # land line at the river
        (45.005, -74.66),                     # St. Regis (NY/QC shared)
        (44.98, -74.85),                      # NY river chain (shared,
        (44.82, -75.25),                      #   reversed from here on)
        (44.703, -75.505),
        (44.595, -75.665),
        (44.50, -75.75),
        (44.36, -75.90),
        (44.27, -76.05),
        (44.20, -76.20),
        (44.145, -76.33),
        (44.10, -76.42),
        (43.90, -76.60),
        (43.55, -76.95),
        (43.50, -77.40),
        (43.40, -78.40),
        (43.32, -79.00),
        (43.27, -79.063),
        (43.16, -79.047),
        (43.12, -79.063),
        (43.078, -79.07),
        (43.06, -79.045),
        (43.03, -79.03),
        (42.99, -79.00),
        (42.94, -78.94),
        (42.90, -78.908),
        (42.80, -78.95),
        (42.55, -79.25),
        (42.28, -79.762),                     # PA lake vertex (shared)
        (42.03, -80.5194),                    # PA/OH corner (shared)
        (42.0, -80.70),                       # OH lake edge (shared,
        (41.85, -81.0),                       #   reversed from here on)
        (41.70, -81.55),
        (41.60, -82.0),
        (41.63, -82.45),
        (41.65, -82.69),
        (41.735, -82.83),
        (41.74, -82.95),
        (41.73, -83.45),                      # OH/MI corner (shared)
        (41.90, -83.25),                      # MI chain (shared, same
        (42.05, -83.13),                      #   order northbound)
        (42.25, -83.10),
        (42.32, -83.07),                      # Detroit / Windsor
        (42.46, -82.755),
        (42.62, -82.51),
        (42.99, -82.415),                     # Port Huron / Sarnia
        (43.80, -82.45),
        (44.10, -82.85),
        (44.33, -83.10),
        (44.90, -83.20),
        (45.20, -83.25),
        (45.60, -83.70),
        (45.70, -84.40),
        (45.95, -84.30),
        (45.99, -83.90),
        (45.93, -83.70),
        (45.95, -83.45),
        (46.08, -83.42),
        (46.09, -83.50),
        (46.07, -83.87),
        (46.18, -84.07),
        (46.30, -84.12),
        (46.45, -84.22),
        (46.505, -84.335),                    # the twin Soos
        (46.77, -84.96),
        (46.70, -85.50),
        (46.68, -86.00),
        (46.55, -86.65),
        (46.65, -87.40),
        (47.30, -87.60),
        (47.55, -87.75),
        (47.85, -88.65),
        (48.20, -88.45),                      # north of Isle Royale
        (48.20, -89.00),                      # MI corridor (shared)
        (47.96, -89.57),                      # MN tip (shared, reversed
        (47.985, -89.70),                     #   from here on)
        (47.99, -90.1),
        (47.90, -90.8),
        (47.95, -91.5),
        (48.2, -92.3),
        (48.38, -92.85),
        (48.61, -93.40),                      # Fort Frances / Intl Falls
        (48.715, -94.60),                     # Rainy River ON / Baudette
        (48.86, -94.687),
        (48.95, -94.70),
        (49.32, -94.84),
        (49.355, -95.05)],                    # Angle Inlet (MN shared)
    # --- Quebec (round 4h): the US side is entirely shared chains
    # (the NY 45.005 line, the VT corner, the NH Halls Stream run,
    # Maine's highlands/Estcourt/St. Francis chain); the Ontario side
    # shares the -79.518 meridian, the Timiskaming/Ottawa midline and
    # the Pointe-Fortune diagonal (the Dundee/Akwesasne strip south
    # of the St. Lawrence stays Quebec); the Labrador border is the
    # shared NL chain (the 52N line exact, Fermont QC west of it,
    # Labrador City NL east); the Gulf edge wraps Anticosti and the
    # Magdalen Islands; Chaleur Bay splits Campbellton NB from
    # Pointe-a-la-Croix QC.
    ("CA", "Quebec"): [
        (51.4, -79.518),                      # ON corner (shared)
        (52.2, -79.2),                        # James Bay east
        (53.8, -79.2),                        # Chisasibi in
        (55.4, -77.9),                        # Kuujjuarapik in
        (58.2, -78.6),                        # Hudson coast
        (61.0, -78.3),                        # Puvirnituq in
        (62.7, -78.3),                        # Ivujivik (north tip)
        (62.8, -74.0),                        # Hudson Strait (Salluit)
        (61.8, -71.5),                        # strait (Kangiqsujuaq)
        (61.0, -69.3),                        # Quaqtaq in
        (60.0, -69.8),                        # Ungava Bay west
        (58.4, -68.0),                        # Kuujjuaq in
        (59.0, -65.6),                        # Ungava east (George R.)
        (60.35, -64.85),                      # Killiniq (NL shared)
        (58.9, -64.2),                        # NL divide (shared)
        (57.5, -64.3),                        # NL divide (shared)
        (56.2, -64.8),                        # NL divide (shared)
        (55.3, -66.2),                        # NL divide (shared)
        (54.7, -66.78),                       # Schefferville QC in
        (53.5, -66.9),                        # NL divide (shared)
        (52.8, -67.0),                        # Fermont in, Lab City out
        (52.0, -63.8),                        # 52N corner (NL shared)
        (52.0, -57.105),                      # 52N line exact (shared)
        (51.42, -57.105),                     # Blanc-Sablon coast corner
        (51.35, -57.3),                       # Gulf (Strait of Belle
        (51.0, -58.5),                        #   Isle midline side)
        (50.2, -61.0),                        # North Shore offshore
        (49.6, -61.3),                        # east of Anticosti
        (48.9, -61.3),                        # Magdalen lobe north
        (47.95, -61.0),                       # Magdalen lobe east
        (47.15, -61.7),                       # Magdalen lobe south
        (47.3, -62.4),                        # Magdalen lobe west
        (48.0, -63.6),                        # Gaspe approach
        (47.95, -64.1),                       # Chaleur mouth (Miscou S)
        (48.08, -64.7),                       # Chaleur midline (NB
        (47.95, -65.6),                       #   shared from here)
        (48.01, -66.68),                      # Campbellton / P-a-l-Croix
        (47.9, -67.5),                        # NB line (shared)
        (47.45, -68.4),                       # Degelis in, Edmundston out
        (47.28, -68.95),                      # ME/NB corner (shared)
        (47.32, -69.05),                      # ME chain (shared)
        (47.46, -69.22),                      # Estcourt (ME shared)
        (46.70, -69.87),                      # ME highlands (shared,
        (46.58, -69.99),                      #   reversed)
        (46.42, -70.06),
        (46.27, -70.20),
        (46.09, -70.29),
        (45.95, -70.31),
        (45.77, -70.39),
        (45.72, -70.28),
        (45.667, -70.40),
        (45.57, -70.47),
        (45.47, -70.66),
        (45.40, -70.73),
        (45.347, -70.80),
        (45.33, -70.92),
        (45.3055, -71.0840),                  # NH corner (shared)
        (45.26, -71.36),                      # Halls Stream (NH shared)
        (45.20, -71.43),
        (45.10, -71.49),
        (45.005, -71.52),                     # VT corner (shared)
        (45.005, -73.345),                    # 45.005 line (NY/VT shared)
        (45.005, -74.66),                     # St. Regis (NY/ON shared)
        (45.18, -74.33),                      # ON diagonal (shared) —
        (45.57, -74.38),                      #   Dundee strip stays QC
        (45.62, -74.60),                      # Ottawa chain (ON shared,
        (45.53, -75.25),                      #   reversed)
        (45.43, -75.70),
        (45.45, -75.95),
        (45.58, -76.25),
        (45.86, -77.11),
        (46.2, -77.7),
        (46.32, -78.70),
        (46.7, -79.12),
        (47.2, -79.43),
        (47.5, -79.518)],                     # meridian (ON shared)
    # --- Atlantic provinces (round 4h).  New Brunswick reuses Maine's
    # whole east chain (the -67.7837 line, the St. Croix and
    # Passamaquoddy — Campobello and Grand Manan now resolve NB) and
    # Quebec's Chaleur/ridge chain; the Bay of Fundy midline and the
    # Chignecto isthmus line (Sackville NB / Amherst NS split) are
    # shared with Nova Scotia; PEI sits behind Northumberland Strait
    # midlines (Borden PE in, Cape Tormentine NB out); Newfoundland
    # and Labrador is ONE ring (the Strait of Belle Isle is interior
    # NL water) sharing Quebec's 52N/divide chain, threading
    # Saint-Pierre-et-Miquelon (FR) out past the Burin towns and
    # keeping a Cabot Strait gap to Nova Scotia.
    ("CA", "New Brunswick"): [
        (47.28, -68.95),                      # QC/ME corner (shared)
        (47.26, -68.60),                      # ME St. John chain
        (47.36, -68.33),                      #   (shared verbatim)
        (47.30, -68.10),
        (47.16, -67.93),
        (47.066, -67.7837),                   # the exact line (shared)
        (45.94, -67.7837),                    # the Monument (shared)
        (45.79, -67.76),
        (45.60, -67.52),
        (45.568, -67.425),
        (45.35, -67.44),
        (45.19, -67.277),                     # St. Stephen in (vs Calais)
        (45.13, -67.17),
        (45.07, -67.10),                      # St. Andrews in
        (44.97, -67.02),                      # Deer Island in
        (44.90, -66.968),
        (44.87, -66.966),                     # Campobello in
        (44.82, -66.95),                      # ME chain end (shared)
        (44.55, -66.95),                      # Grand Manan west
        (44.45, -66.75),                      # Grand Manan south
        (44.60, -66.45),                      # Fundy midline (NS shared)
        (45.05, -65.5),                       # Fundy midline (shared)
        (45.55, -64.7),                       # Fundy midline (shared)
        (45.72, -64.45),                      # Chignecto approach
        (45.85, -64.37),                      # isthmus line (NS shared)
        (45.98, -64.05),                      # Baie Verte (NS shared)
        (46.10, -63.70),                      # Cape Tormentine in
        (46.45, -64.35),                      # strait (PE gap east)
        (46.80, -64.75),                      # Kouchibouguac offshore
        (47.05, -65.00),                      # Miramichi Bay offshore
        (47.75, -64.45),                      # Shippagan offshore
        (47.95, -64.1),                       # Chaleur mouth (QC shared)
        (48.08, -64.7),                       # Chaleur midline (shared)
        (47.95, -65.6),                       # Chaleur midline (shared)
        (48.01, -66.68),                      # Campbellton / P-a-l-Croix
        (47.9, -67.5),                        # QC ridge (shared)
        (47.45, -68.4)],                      # QC ridge (shared)
    ("CA", "Nova Scotia"): [
        (45.85, -64.37),                      # isthmus (NB shared)
        (45.72, -64.45),                      # Fundy midline (shared)
        (45.55, -64.7),
        (45.05, -65.5),
        (44.60, -66.45),                      # Fundy mouth (shared)
        (43.70, -66.60),                      # Yarmouth offshore
        (43.20, -65.90),                      # Cape Sable offshore
        (43.30, -64.00),                      # Atlantic offshore
        (44.30, -62.30),                      # Halifax offshore
        (45.30, -60.50),                      # Canso offshore
        (46.60, -59.20),                      # Cabot Strait (NL gap)
        (47.25, -60.30),                      # Cape Breton north
        (46.75, -61.15),                      # Cheticamp offshore
        (46.00, -61.85),                      # Margaree / Judique coast
        (45.90, -61.70),                      # St. Georges Bay
        (45.75, -62.20),                      # Northumberland (PE gap)
        (45.85, -63.30),                      # strait midline (PE gap)
        (45.98, -64.05)],                     # Baie Verte (NB shared)
    ("CA", "Prince Edward Island"): [
        (46.75, -64.45),                      # West Point offshore
        (47.10, -64.25),                      # North Cape offshore
        (47.10, -61.95),                      # East Point offshore
        (45.95, -61.95),                      # Georgetown offshore
        (45.88, -62.40),                      # Wood Islands reach
        (46.00, -63.30),                      # strait midline (NS gap)
        (46.19, -63.74),                      # Borden in, Tormentine out
        (46.35, -64.20)],                     # Summerside reach
    ("CA", "Newfoundland and Labrador"): [
        (60.35, -64.85),                      # Killiniq (QC shared)
        (60.50, -64.00),                      # Labrador Sea
        (58.50, -62.00),                      # Nain offshore
        (56.50, -60.50),                      # Hopedale offshore
        (54.50, -56.50),                      # Cartwright offshore
        (53.60, -55.50),                      # Labrador SE offshore
        (52.20, -55.20),                      # Belle Isle mouth (sea side)
        (51.65, -54.80),                      # island NE offshore
        (50.00, -54.60),                      # Notre Dame Bay offshore
        (49.50, -52.50),                      # Bonavista offshore
        (47.40, -52.40),                      # Cape Spear offshore
        (46.50, -52.90),                      # Avalon south offshore
        (46.55, -55.00),                      # Placentia Bay mouth
        (46.72, -55.75),                      # Burin tip reach
        (46.85, -56.00),                      # Fortune Bay approach —
        (47.05, -56.08),                      #   Saint-Pierre-et-
        (47.10, -56.45),                      #   Miquelon (FR) out
        (47.30, -57.60),                      # south coast offshore
        (47.42, -59.35),                      # Port aux Basques reach
        (48.00, -59.70),                      # west coast (NS gap)
        (49.50, -59.20),                      # Gulf offshore (QC gap)
        (50.60, -57.90),                      # strait SW crossing
        (51.42, -57.105),                     # Blanc-Sablon (QC shared)
        (52.0, -57.105),                      # QC meridian (shared)
        (52.0, -63.8),                        # 52N line exact (shared)
        (52.8, -67.0),                        # Labrador City in (shared)
        (53.5, -66.9),                        # QC divide (shared)
        (54.7, -66.78),                       # Schefferville QC out
        (55.3, -66.2),                        # QC divide (shared)
        (56.2, -64.8),                        # QC divide (shared)
        (57.5, -64.3),                        # QC divide (shared)
        (58.9, -64.2)],                       # QC divide (shared)
    ("CA", "Yukon"): [
        (60.0, -141.0), (69.7, -141.0), (69.3, -138.0),
        (67.0, -136.0), (65.0, -133.0), (63.0, -130.0),
        (61.0, -126.8), (60.0, -124.8)],
    ("CA", "Northwest Territories"): [
        (60.0, -123.3), (61.0, -124.3), (63.0, -127.0),
        (65.0, -130.5), (67.0, -133.0), (69.3, -134.8),
        (69.8, -130.0), (69.3, -120.0), (68.0, -116.5),
        (66.0, -114.0), (64.0, -110.5), (62.0, -106.0),
        (60.0, -102.0)],
    ("CA", "Nunavut"): [
        (60.0, -102.0), (62.0, -102.5), (64.0, -106.5),
        (66.0, -110.0), (67.8, -113.0), (68.3, -109.0),
        (68.5, -100.0), (66.0, -85.0), (62.0, -90.0),
        (60.0, -93.0), (60.0, -94.8)],
    # --- US: Nevada (round 4) — 42N, 120W, 114.041W/114.05W and the
    # 1861 oblique line (35.0,-114.63)->(39.0,-120.0) are exact; the
    # Colorado-river section reuses Arizona's vertices so the rings
    # share an edge instead of overlapping.
    ("US", "Nevada"): [
        (42.0, -120.0), (42.0, -114.041), (37.0, -114.041),
        (37.0, -114.05), (36.1, -114.05), (36.12, -114.4),
        (35.168, -114.5715),                   # Laughlin/Bullhead split
        (35.1, -114.60), (35.0, -114.63), (39.0, -120.0)],
    # --- US West/South (round 4b).  California: 42N, the 120W segment
    # and the 1861 oblique line are exact and SHARE the Nevada ring's
    # vertices (coincident edges, no overlap, no gap); the Colorado
    # river edge is _COLORADO_RIVER shared verbatim with Arizona; the
    # Mexico line runs (32.718,-114.719)->(32.534,-117.124) (the legal
    # straight line); the coast is generous but the ring stays north
    # of the border line's seaward extension (Islas Coronado remain
    # Mexican) while covering the US Channel Islands.
    ("US", "California"): [
        (42.0, -124.8), (42.0, -120.0), (39.0, -120.0),     # oblique
        *_COLORADO_RIVER,
        (32.534, -117.124),                                 # Mexico
        (32.7, -118.6), (33.3, -120.0), (36.0, -122.8),     # ocean
        (40.0, -125.0)],
    # Oregon: 42N south and the -117.026 Owyhee meridian segment are
    # exact; Snake river east and Columbia river north approximated
    # (gorge towns sit within ~1 km of the polyline — documented
    # envelope); the 46N segment east of Wallula is exact and shared
    # with Washington.
    ("US", "Oregon"): [
        (42.0, -124.8), (42.0, -117.026), (43.8, -117.03),
        (43.88, -116.98),                                   # Nyssa
        (44.03, -116.935),                                  # Ontario
        (44.08, -116.95), (44.25, -116.99),                 # Weiser
        (44.32, -117.22),                                   # Farewell B.
        (44.8, -116.9), (45.6, -116.75),                    # Snake
        (46.0, -116.96), (46.0, -118.98),                   # 46N
        (45.9, -119.45), (45.72, -120.5), (45.71, -121.55), # Columbia
        (45.685, -121.88), (45.65, -121.95), (45.63, -121.98),
        (45.6, -122.3), (45.61, -122.75),
        (45.865, -122.79),                                  # St Helens
        (46.0, -122.86), (46.09, -122.92),
        (46.10, -122.945),                                  # Rainier
        (46.15, -123.45), (46.23, -124.0), (46.2, -124.8)],
    # Washington: 49N north and the -117.04 Idaho meridian are exact;
    # Columbia/Snake approximated with Oregon's shared vertices; the
    # marine boundary threads Juan de Fuca / Haro Strait / Boundary
    # Pass so Victoria, Sidney and the Gulf Islands stay Canadian
    # while the San Juans and Point Roberts stay inside.
    ("US", "Washington"): [
        (46.23, -124.0), (46.15, -123.45),
        (46.10, -122.945),                                  # Rainier
        (46.09, -122.92), (46.0, -122.86),
        (45.865, -122.79),                                  # St Helens
        (45.61, -122.75), (45.6, -122.3), (45.63, -121.98),
        (45.65, -121.95), (45.685, -121.88), (45.71, -121.55),
        (45.72, -120.5), (45.9, -119.45), (46.0, -118.98),
        (46.0, -116.96), (46.2, -116.98), (46.42, -117.04), # Snake
        (49.0, -117.04),                                    # meridian
        (49.0, -123.15), (48.78, -123.05), (48.6, -123.2),  # Boundary
        (48.45, -123.25),
        (48.27, -123.54),                                   # Race Rocks
        (48.28, -124.0), (48.38, -124.45),                  # Juan de F.
        (48.48, -124.75),                                   # C.Flattery
        (48.50, -124.95), (46.3, -124.9)],
    # Idaho: 42N south, 49N north, the 111.046W Wyoming meridian and
    # the -116.05/-117.04 segments are exact; the Oregon (Snake) and
    # Washington edges share those rings' vertices verbatim
    # (coincident edges — Fruitland/Payette/Weiser/Lewiston resolve
    # exactly opposite Ontario/Nyssa/Clarkston); the Montana
    # continental-divide/Bitterroot border is conservative on the
    # Idaho side (the dead strip up to Montana's own approximation
    # falls to the anchors, the YT/NT convention).
    ("US", "Idaho"): [
        (42.0, -117.026), (42.0, -111.046),                 # 42N
        (44.45, -111.046),                                  # WY corner
        (44.55, -111.3), (44.5, -111.8),                    # Targhee
        (44.3, -112.3), (44.7, -112.9),                     # divide
        (45.4, -113.6), (45.4, -114.6), (46.5, -114.75),    # Bitterroot
        (47.2, -115.6), (47.9, -116.1),
        (48.0, -116.05), (49.0, -116.05),                   # meridian
        (49.0, -117.04),                                    # 49N
        (46.42, -117.04), (46.2, -116.98), (46.0, -116.96), # WA shared
        (45.6, -116.75), (44.8, -116.9), (44.32, -117.22),  # Snake
        (44.25, -116.99), (44.08, -116.95), (44.03, -116.935),
        (43.88, -116.98), (43.8, -117.03)],
    # Texas: the 103.042W / 32N New Mexico lines, the 36.5N / -100.0
    # panhandle lines and the -94.043 Sabine meridian segment are
    # exact (NM and OK vertices shared); the Red River reuses
    # Oklahoma's polyline; the Rio Grande polyline tracks the river
    # within ~2 km on BOTH sides (the anchor fallback assigns the US
    # twin cities to Mexican states, so a conservative setback would
    # misassign El Paso/Brownsville/Laredo — each twin-city pair below
    # is split explicitly and regression-tested); Gulf generous.
    ("US", "Texas"): [
        (36.5, -103.042), (36.5, -100.0), (34.56, -99.99),
        (34.4, -99.4), (34.15, -98.6), (34.1, -98.1),       # Red R.
        (33.9, -96.9), (33.8, -95.5), (33.87, -94.48),
        (33.55, -94.043), (32.0, -94.043),                  # meridian
        (31.8, -94.0), (31.2, -93.7), (30.3, -93.8),        # Sabine
        (29.75, -93.9), (29.4, -93.9),
        (28.5, -95.2), (27.3, -96.4), (26.0, -96.6),        # Gulf
        (25.955, -97.15), (25.888, -97.50),                 # Matamoros
        (26.063, -97.953),                                  # Progreso
        (26.09, -98.26),                                    # Reynosa
        (26.36, -98.82),
        (26.401, -99.021),                                  # Roma
        (26.398, -99.06),                                   # Fronton
        (26.55, -99.17), (26.9, -99.32),
        (27.5, -99.515),                                    # N. Laredo
        (28.05, -100.05), (28.7, -100.51),                  # P. Negras
        (29.0, -100.65), (29.33, -100.92),                  # Acuña
        (29.45, -101.05), (29.75, -101.4), (29.8, -102.1),
        (29.2, -102.7), (29.0, -103.15), (29.17, -103.6),   # Big Bend
        (29.555, -104.40),                                  # Ojinaga
        (30.1, -104.72), (30.68, -105.0), (31.1, -105.6),
        (31.5, -106.2), (31.75, -106.47),                   # Juárez
        (31.78, -106.53), (32.0, -106.62), (32.0, -103.042)],
    # --- Pennsylvania: 42N (NY), the Mason-Dixon line 39.7222N (MD/WV),
    # the Ellicott meridian -80.5194 (OH/WV) and the NY west line
    # -79.762 are exact; the Delaware River polyline (NY then NJ side)
    # tracks the channel within ~1-2 km so the river twin cities split
    # correctly (Matamoras/Easton/Morrisville/Philadelphia PA vs
    # Port Jervis/Phillipsburg/Trenton/Camden across the water); the
    # PA/DE Twelve-Mile-Circle arc is approximated by chords, which lie
    # INSIDE the circle (south of the true arc), so the ring never
    # claims Delaware soil and a thin PA sliver falls to anchors; the
    # Lake Erie edge stays a few km offshore, far south of the
    # mid-lake Canada boundary.
    ("US", "Pennsylvania"): [
        (42.03, -80.5194),                    # Lake Erie at the OH line
        (42.28, -79.762),                     # lake edge (US waters)
        (42.0, -79.762),                      # NY west line south end
        (42.0, -75.36),                       # 42N meets the Delaware
        *_DELAWARE_NY_PA,                     # shared NY/PA river edge
        (41.357, -74.695),                    # NY/NJ/PA tri-state
        *_DELAWARE_PA_NJ,                     # shared PA/NJ river edge
        (39.83, -75.56),                      # Twelve-Mile-Circle chord
        (39.78, -75.72),                      # Twelve-Mile-Circle chord
        (39.7222, -75.788),                   # MD/DE corner
        (39.7222, -80.5194)],                 # Mason-Dixon west end
    # --- Illinois: the statutory 42.5N Wisconsin parallel (surveyed
    # line wobbles within ~1 km) and the Indiana meridian -87.5246 are
    # exact-class; the Mississippi, Ohio and Wabash river polylines
    # track the channel within ~2 km so the river twin cities split
    # correctly (Rock Island/East St. Louis/Quincy/Hamilton/Metropolis
    # IL vs Davenport/St. Louis/Hannibal/Keokuk/Paducah across the
    # water); the Lake Michigan edge hugs the shore (Chicago in,
    # Hammond IN east of the meridian).
    ("US", "Illinois"): [
        (42.500, -90.642),                    # WI line at the Mississippi
        (42.500, -87.79),                     # WI line at Lake Michigan
        (42.36, -87.81),                      # Waukegan shore
        (42.05, -87.66),                      # Evanston shore
        (41.89, -87.60),                      # Chicago shore
        (41.73, -87.52),                      # Calumet shore
        (41.73, -87.5246),                    # IN meridian north end
        *_WABASH,                             # shared IL/IN river edge
        *_OHIO_RIVER_IL,                      # shared IL/KY river edge
        *_MISSISSIPPI_IL_MO,                  # shared IL/MO river edge
        *_MISSISSIPPI_IL_IA],                 # shared IL/IA river edge
    # --- Indiana: the Vincennes meridian -87.5246 (IL, continued by
    # the shared _WABASH polyline), the Michigan parallel 41.7597 and
    # the First Principal Meridian -84.8029 (OH) are exact-class; the
    # Ohio River polyline tracks the channel within ~2 km so the
    # Louisville-area and Evansville twin cities split correctly
    # (Jeffersonville/New Albany/Evansville IN vs Louisville/Henderson
    # KY); the Lake Michigan edge hugs the shore.
    ("US", "Indiana"): [
        (41.73, -87.5246),                    # lake at the IL meridian
        (41.62, -87.33),                      # Gary shore
        (41.67, -87.05),                      # Ogden Dunes reach
        (41.73, -86.90),                      # Michigan City shore
        (41.7597, -86.83),                    # MI line meets the lake
        (41.7597, -84.8029),                  # MI/OH corner (parallel)
        (39.103, -84.8029),                   # meridian meets the Ohio
        *_OHIO_RIVER_IN,                      # shared IN/KY river edge
        *[(la, lo) for la, lo in reversed(_WABASH)]],  # shared edge
    # --- Ohio: the First Principal Meridian -84.8029 (IN), the Harris
    # (Toledo) line and the Ellicott meridian -80.5194 (PA, shared with
    # the Pennsylvania ring) are exact-class; the Ohio River polyline
    # tracks the channel within ~2 km so the WV/KY twin cities split
    # correctly (Cincinnati/Ironton/Portsmouth/Marietta/Bridgeport OH
    # vs Newport/Covington/Russell/South Shore/Williamstown/Wheeling
    # across the water); the Lake Erie edge threads south of the
    # Canadian islands (Middle/Pelee out, the US Bass islands and
    # Kelleys in).
    ("US", "Ohio"): [
        (41.70, -84.8029),                    # MI corner (Harris line W)
        (41.73, -83.45),                      # Harris line at Maumee Bay
        (41.74, -82.95),                      # lake edge (US waters)
        (41.735, -82.83),                     # north of North Bass Is.
        (41.65, -82.69),                      # south of Middle Island
        (41.63, -82.45),                      # Sandusky Bay approach
        (41.60, -82.0),                       # Lorain offshore
        (41.70, -81.55),                      # Cleveland offshore
        (41.85, -81.0),                       # Fairport offshore
        (42.0, -80.70),                       # Conneaut offshore
        (42.03, -80.5194),                    # PA corner (lake)
        (40.637, -80.5194),                   # PA/WV tripoint (river)
        *_OHIO_RIVER_WV,                      # shared OH/WV river edge
        *_OHIO_RIVER_OH,                      # shared OH/KY river edge
        (39.103, -84.8029)],                  # IN tripoint (Great Miami)
    # --- Iowa: the 43.5N Minnesota line is exact (coincident with the
    # Minnesota ring); east = the Wisconsin-facing Mississippi channel
    # then the shared _MISSISSIPPI_IL_IA list verbatim (every Quad-
    # Cities/Keokuk/Burlington/Muscatine/Clinton/Dubuque split proven
    # from the Illinois side holds); south = the Des Moines River to
    # the surveyed Sullivan line (~40.588 east sloping to ~40.576 west
    # — an irregular 1816 survey, envelope ~1.5 km); west = the shared
    # _MISSOURI_RIVER_IA_NE and _BIG_SIOUX channel lists (Council
    # Bluffs and Sioux City are Iowa — nearest-anchor provably assigns
    # both to Nebraska).
    ("US", "Iowa"): [
        (43.5, -96.45),                       # IA/SD/MN corner (exact)
        *_MISSISSIPPI_WI_IA,                  # shared WI/IA river edge
        *[(la, lo) for la, lo in reversed(_MISSISSIPPI_IL_IA)][1:],
        (40.376, -91.402),                    # Des Moines mouth (Keokuk)
        (40.46, -91.52),                      # Des Moines River
        (40.54, -91.60),                      # Farmington reach
        (40.588, -91.719),                    # Sullivan line east end
        (40.577, -93.52),                     # Sullivan line (Lineville)
        (40.5757, -95.765),                   # Sullivan line west end
        *[(la, lo) for la, lo in
          reversed(_MISSOURI_RIVER_IA_NE[:12])],  # up to the Big Sioux
        *[(la, lo) for la, lo in reversed(_BIG_SIOUX)][1:]],
    # --- Missouri: east = its own Alexandria/Canton/La Grange channel
    # reach then the shared _MISSISSIPPI_IL_MO list verbatim (St.
    # Louis/Hannibal/West Quincy splits hold from the west bank), the
    # shared Kentucky channel vertices, and a channel route around the
    # New Madrid bend (New Madrid/Caruthersville in, the Kentucky Bend
    # exclave left to anchors); south = the ~36.498 Arkansas parallel
    # with the bootheel dropping to 36.0 between the Mississippi and
    # the St. Francis River; west = -94.617 and the Kansas ring's own
    # river vertices verbatim, then the shared _MISSOURI_RIVER_IA_NE
    # tail; north = the Sullivan line + Des Moines River shared with
    # Iowa.
    ("US", "Missouri"): [
        (40.376, -91.402),                    # Des Moines mouth
        (40.35, -91.43),                      # Alexandria reach
        (40.20, -91.45),                      # Gregory bend
        (40.125, -91.455),                    # Canton
        (40.04, -91.49),                      # La Grange
        *[(la, lo) for la, lo in reversed(_MISSISSIPPI_IL_MO)],
        (36.76, -89.13),                      # Columbus reach (KY shared)
        (36.57, -89.20),                      # Hickman (KY shared)
        (36.47, -89.26),                      # bend approach
        (36.42, -89.36),                      # Island 8 reach
        (36.52, -89.46),                      # bend east arm
        (36.575, -89.525),                    # New Madrid
        (36.48, -89.58),                      # bend west arm
        (36.30, -89.60),                      # Portageville reach
        (36.19, -89.64),                      # Caruthersville (TN shared)
        (36.0, -89.762),                      # AR corner (on the TN chord)
        (36.0, -90.30),                       # bootheel south line
        (36.06, -90.30),                      # Cardwell (St. Francis)
        (36.20, -90.23),                      # St. Francis River
        (36.45, -90.135),                     # St. Francis / Piggott
        (36.498, -90.125),                    # 36.498 resumes
        (36.498, -94.617),                    # AR/OK corner
        (37.0, -94.617),                      # KS corner (shared)
        *[(la, lo) for la, lo in reversed(_MISSOURI_RIVER_KS)],
        (40.05, -95.42),                      # Rulo (shared river)
        (40.40, -95.645),                     # Brownville (shared river)
        (40.5757, -95.765),                   # IA corner = Sullivan west
        (40.577, -93.52),                     # Sullivan line (shared)
        (40.588, -91.719),                    # Sullivan line east end
        (40.54, -91.60),                      # Des Moines River (shared)
        (40.46, -91.52)],                     # Des Moines River (shared)
    # --- Wisconsin: south = the 42.5N statutory line (coincident with
    # Illinois); west = the shared _MISSISSIPPI_WI_IA list, then the
    # channel-accurate Mississippi/St. Croix against Minnesota
    # (La Crosse/Hudson/St. Croix Falls/Superior stay Wisconsin;
    # La Crescent/Stillwater/Taylors Falls/Duluth stay Minnesota —
    # Minnesota's conservative east edge leaves the strip to these
    # vertices, no overlap); north = the Superior shore incl. the
    # Apostle Islands; east = the shared _WI_MI and _GREEN_BAY lists
    # and the Lake Michigan shore wrapping the Door Peninsula and
    # Washington Island.
    ("US", "Wisconsin"): [
        (42.500, -90.642),                    # IL line at the Mississippi
        (42.500, -87.79),                     # IL line at Lake Michigan
        (42.58, -87.78),                      # Kenosha shore
        (42.73, -87.76),                      # Racine shore
        (43.04, -87.85),                      # Milwaukee shore
        (43.39, -87.84),                      # Port Washington shore
        (43.75, -87.68),                      # Sheboygan shore
        (44.09, -87.62),                      # Manitowoc shore
        (44.46, -87.47),                      # Kewaunee shore
        (44.85, -87.18),                      # Door east shore
        (45.15, -86.93),                      # Bailey's Harbor offshore
        (45.40, -86.85),                      # Washington Island east
        *[(la, lo) for la, lo in reversed(_GREEN_BAY)],
        *[(la, lo) for la, lo in reversed(_WI_MI)][1:],
        (46.60, -90.40),                      # Superior shore
        (47.15, -90.30),                      # Apostle Islands NE
        (47.15, -91.00),                      # Apostle Islands NW
        (46.90, -91.60),                      # Iron River offshore
        (46.79, -91.90),                      # Brule Point reach (S of
                                              # the MN water edge)
        (46.735, -92.06),                     # Superior entry
        (46.725, -92.105),                    # Superior Bay midline
        (46.66, -92.195),                     # Oliver reach
        (46.60, -92.27),                      # St. Louis River reach
        (46.15, -92.29),                      # state-line lakes
        (46.0, -92.39),                       # Danbury / St. Croix head
        (45.41, -92.6495),                    # St. Croix Falls gorge
        (45.32, -92.71),                      # Osceola
        (45.055, -92.795),                    # Stillwater / Houlton
        (44.97, -92.77),                      # Hudson / Lakeland
        (44.745, -92.80),                     # Prescott (St. Croix mouth)
        (44.575, -92.52),                     # Red Wing reach
        (44.52, -92.35),                      # Lake Pepin (Frontenac)
        (44.455, -92.22),                     # Lake Pepin (Pepin/Stockholm)
        (44.395, -92.02),                     # Wabasha / Nelson
        (44.045, -91.63),                     # Winona reach
        (43.81, -91.272),                     # La Crosse / La Crescent
        (43.57, -91.23),                      # Genoa reach
        *_MISSISSIPPI_WI_IA],                 # shared WI/IA river edge
    # --- Michigan: ONE ring wraps both peninsulas through the Straits
    # of Mackinac (the connecting water is Michigan, so the boundary
    # crosses the strait at its east and west mouths without
    # self-intersection).  Exact-class shares: the 41.7597 parallel
    # and -84.8029 meridian bit with Indiana, the Harris line with
    # Ohio, the _WI_MI and _GREEN_BAY lists with Wisconsin.  The
    # Detroit/St. Clair/St. Marys river borders and the De Tour-
    # Drummond passage track the channel (Detroit/Port Huron/Sault MI
    # in; Windsor/Sarnia/Soo ON out); the Lakes Huron/Superior/
    # Michigan edges stay safely US-side of the mid-lake line, with an
    # excursion enclosing Isle Royale; Lake Erie's edge hugs the shore.
    ("US", "Michigan"): [
        (41.73, -83.45),                      # OH corner (Harris line)
        (41.90, -83.25),                      # Monroe shore
        (42.05, -83.13),                      # Detroit River mouth
        (42.25, -83.10),                      # Grosse Ile reach
        (42.32, -83.07),                      # Detroit / Windsor
        (42.46, -82.755),                     # Lake St. Clair midline
        (42.62, -82.51),                      # St. Clair River
        (42.99, -82.415),                     # Port Huron / Sarnia
        (43.80, -82.45),                      # Lake Huron (thumb east)
        (44.10, -82.85),                      # Saginaw Bay mouth
        (44.33, -83.10),                      # Au Sable offshore
        (44.90, -83.20),                      # Thunder Bay offshore
        (45.20, -83.25),                      # Presque Isle offshore
        (45.60, -83.70),                      # Rogers City offshore
        (45.70, -84.40),                      # strait east mouth (LP)
        (45.95, -84.30),                      # Les Cheneaux (UP)
        (45.99, -83.90),                      # De Tour Passage
        (45.93, -83.70),                      # Drummond south offshore
        (45.95, -83.45),                      # Drummond SE offshore
        (46.08, -83.42),                      # False Detour Channel
        (46.09, -83.50),                      # Drummond north shore
        (46.07, -83.87),                      # Potagannissing Bay
        (46.18, -84.07),                      # Munuscong midchannel
        (46.30, -84.12),                      # Neebish east channel
        (46.45, -84.22),                      # Sugar Island east channel
        (46.505, -84.335),                    # Sault Ste. Marie twin Soos
        (46.77, -84.96),                      # Whitefish Point
        (46.70, -85.50),                      # Superior shore
        (46.68, -86.00),                      # Grand Marais
        (46.55, -86.65),                      # Munising offshore
        (46.65, -87.40),                      # Marquette offshore
        (47.30, -87.60),                      # Keweenaw east offshore
        (47.55, -87.75),                      # Keweenaw tip offshore
        (47.85, -88.65),                      # Isle Royale corridor
        (48.20, -88.45),                      # Isle Royale NE (Blake Pt)
        (48.20, -89.00),                      # Isle Royale north
        (47.88, -89.28),                      # Isle Royale SW
        (47.82, -88.90),                      # corridor return
        (47.45, -88.40),                      # Keweenaw NW offshore
        (47.15, -88.80),                      # Ontonagon approach
        (46.95, -89.15),                      # Ontonagon offshore
        (46.80, -89.60),                      # Porcupine Mtns offshore
        (46.70, -89.90),                      # Presque Isle River shore
        *_WI_MI,                              # shared WI/MI land border
        *_GREEN_BAY,                          # shared bay water line
        (45.60, -86.30),                      # UP Lake Michigan shore
        (45.85, -86.20),                      # Manistique shore
        (45.90, -85.60),                      # Naubinway shore
        (45.88, -84.95),                      # strait west mouth (UP)
        (45.72, -84.95),                      # strait west mouth (LP)
        (45.62, -85.10),                      # Cross Village shore
        (45.78, -85.45),                      # Beaver Island north
        (45.55, -85.70),                      # Beaver Island south
        (45.21, -85.62),                      # Grand Traverse Bay mouth
        (45.10, -86.08),                      # Leelanau offshore
        (44.63, -86.30),                      # Frankfort shore
        (43.95, -86.50),                      # Ludington shore
        (43.23, -86.36),                      # Muskegon shore
        (42.77, -86.25),                      # Holland shore
        (42.10, -86.55),                      # St. Joseph shore
        (41.7597, -86.83),                    # IN line at the lake
        (41.7597, -84.8029),                  # IN/OH meridian corner
        (41.70, -84.8029)],                   # OH corner (Harris west)
    # --- Arkansas: the 36.498 Missouri parallel, the 33N Louisiana
    # parallel and the -94.043 Texas meridian are exact; the west edge
    # reuses Oklahoma's line and Texas's Red River vertices verbatim;
    # the east edge shares the Missouri bootheel / St. Francis,
    # Tennessee chord and _MISSISSIPPI_AR_MS channel vertices (West
    # Memphis/Helena/Lake Village/Texarkana AR in; Memphis/Friars
    # Point/Greenville/Texarkana TX across).
    ("US", "Arkansas"): [
        (36.498, -94.617),                    # MO/OK corner (shared)
        (36.498, -90.125),                    # MO parallel (shared)
        (36.45, -90.135),                     # St. Francis (MO shared)
        (36.20, -90.23),                      # St. Francis (MO shared)
        (36.06, -90.30),                      # St. Francis (MO shared)
        (36.0, -90.30),                       # bootheel corner (shared)
        (36.0, -89.762),                      # bootheel east (MO/TN chord)
        (35.70, -89.955),                     # Osceola (TN shared)
        (35.35, -90.09),                      # Loosahatchie (TN shared)
        (35.13, -90.075),                     # Memphis / West Memphis
        *_MISSISSIPPI_AR_MS,                  # shared AR/MS river edge
        (33.0, -94.043),                      # 33N to the TX tripoint
        (33.55, -94.043),                     # TX meridian (shared)
        (33.87, -94.48),                      # Red River / OK corner
        (35.5, -94.43)],                      # OK line (shared)
    # --- Louisiana: 33N (AR) and 31N (MS, east of the river) are
    # exact; the -94.043 meridian bit is shared with Texas but the
    # Sabine chain is Louisiana's OWN east-of-channel conservative
    # line (Texas's chain is west-of-channel conservative — sharing it
    # would claim Orange TX); the Mississippi and Pearl are the shared
    # channel lists; the Gulf edge is a generous offshore envelope
    # around the delta.
    ("US", "Louisiana"): [
        (33.0, -94.043),                      # AR/TX tripoint (exact)
        (33.0, -91.166),                      # 33N to the river (shared)
        *_MISSISSIPPI_LA_MS,                  # shared LA/MS river edge
        (31.0, -89.728),                      # 31N east to the Pearl
        *_PEARL[1:],                          # shared Pearl edge
        (30.10, -89.45),                      # Rigolets water line (MS)
        (29.6, -88.9),                        # Chandeleur offshore
        (29.0, -89.0),                        # delta east offshore
        (28.85, -89.35),                      # bird-foot tip offshore
        (28.9, -90.0),                        # Grand Isle offshore
        (29.0, -91.0),                        # Atchafalaya offshore
        (29.3, -91.9),                        # Marsh Island offshore
        (29.45, -93.0),                       # Cameron offshore
        (29.70, -93.82),                      # Sabine mouth
        (29.95, -93.80),                      # Sabine Lake east midline
        (30.09, -93.70),                      # Orange reach (east bank)
        (30.3, -93.72),                       # Starks reach
        (30.7, -93.60),                       # Merryville reach
        (31.2, -93.60),                       # Toledo Bend east
        (31.5, -93.72),                       # Zwolle reach
        (31.9, -93.88),                       # Converse reach
        (32.0, -94.043)],                     # TX meridian (shared)
    # --- Mississippi: 34.995 (TN), 31N (LA) exact; the west edge is
    # the two shared river lists; the MS/AL line is the surveyed
    # near-straight diagonal (Columbus in, Aliceville AL out) with the
    # lower section to the Gulf east of Pascagoula; the Sound edge
    # keeps the MS barrier islands (Cat/Ship/Horn/Petit Bois) in and
    # Dauphin Island AL out.
    ("US", "Mississippi"): [
        (34.995, -90.30),                     # TN corner (shared vertex)
        (34.995, -88.20),                     # TN/AL corner (34.995)
        (31.894, -88.473),                    # AL diagonal (surveyed)
        (30.32, -88.40),                      # AL line at the coast
        (30.18, -88.35),                      # Petit Bois / Dauphin split
        (30.10, -88.85),                      # Sound offshore (islands in)
        (30.10, -89.45),                      # Rigolets water line (LA)
        *[(la, lo) for la, lo in reversed(_PEARL)][:-1],
        (31.0, -89.728),                      # Pearl at 31N (shared)
        (31.0, -91.64),                       # 31N west to the river
        *[(la, lo) for la, lo in reversed(_MISSISSIPPI_LA_MS)][1:],
        *[(la, lo) for la, lo in reversed(_MISSISSIPPI_AR_MS)][1:]],
    # --- Alabama: 34.995 (TN) and 31N (FL) exact; the MS diagonal and
    # the _CHATTAHOOCHEE/_PERDIDO channel lists are shared verbatim;
    # the upper AL/GA straight line runs corner-to-West-Point; the
    # Gulf edge keeps Dauphin Island and Orange Beach in, with the MS
    # Sound split shared with the Mississippi ring.
    ("US", "Alabama"): [
        (34.995, -88.20),                     # MS/TN corner (shared)
        (34.995, -85.605),                    # GA/TN corner (34.995)
        *_CHATTAHOOCHEE[:1],                  # West Point corner
        *_CHATTAHOOCHEE[1:],                  # shared AL/GA river edge
        (31.0, -87.601),                      # 31N west to the Perdido
        *_PERDIDO[1:],                        # shared AL/FL river edge
        (30.20, -87.55),                      # Orange Beach offshore
        (30.12, -88.00),                      # Gulf offshore
        (30.15, -88.15),                      # Dauphin Island south
        (30.18, -88.35),                      # Petit Bois split (shared)
        (30.32, -88.40),                      # MS line at the coast
        (31.894, -88.473)],                   # MS diagonal (shared)
    # --- Georgia: 34.995 (TN) and the ~35.0 NC line exact-class; west
    # = the straight West Point line + shared _CHATTAHOOCHEE and
    # _CHATTAHOOCHEE_FL; south = the shared _GA_FL list; east = the
    # Chattooga/Tugaloo/Savannah channel (Augusta/Savannah GA in,
    # North Augusta/Hardeeville SC out) and a generous Atlantic edge.
    ("US", "Georgia"): [
        (34.995, -85.605),                    # TN/AL corner
        (34.995, -84.32),                     # TN line (shared value)
        (35.0, -84.287),                      # TN/NC tripoint (shared)
        (34.99, -83.109),                     # Ellicott Rock (NC/SC)
        (34.90, -83.15),                      # Chattooga reach
        (34.75, -83.30),                      # Chattooga lower
        (34.54, -83.30),                      # Tugaloo / Toccoa
        (34.40, -82.90),                      # Hartwell Lake
        (34.35, -82.82),                      # Savannah head
        (34.0, -82.60),                       # Calhoun Falls reach
        (33.66, -82.20),                      # Clarks Hill
        (33.48, -81.96),                      # Augusta / North Augusta
        (33.0, -81.60),                       # Millhaven reach
        (32.55, -81.25),                      # Clyo reach
        (32.30, -81.14),                      # Hardeeville reach
        (32.03, -80.87),                      # Savannah mouth
        (31.9, -80.75),                       # Atlantic offshore
        (31.0, -81.20),                       # Brunswick offshore
        (30.71, -81.40),                      # Cumberland Sound
        *[(la, lo) for la, lo in reversed(_GA_FL)][1:],
        *[(la, lo) for la, lo in reversed(_CHATTAHOOCHEE_FL)][1:],
        *[(la, lo) for la, lo in reversed(_CHATTAHOOCHEE)][1:]],
    # --- Florida: 31N (AL) exact, the shared _PERDIDO /
    # _CHATTAHOOCHEE_FL / _GA_FL lists, and generous offshore edges
    # wrapping the peninsula, the Keys and the Dry Tortugas.
    ("US", "Florida"): [
        (31.0, -87.601),                      # AL corner (31N west end)
        (31.0, -85.09),                       # 31N east (shared)
        *_CHATTAHOOCHEE_FL[1:],               # shared FL/GA river edge
        *_GA_FL[1:],                          # shared FL/GA line
        (30.0, -81.10),                       # Atlantic offshore
        (28.0, -80.30),                       # Canaveral offshore
        (26.5, -79.90),                       # Gulf Stream edge
        (24.5, -80.20),                       # Keys east
        (24.4, -82.00),                       # Key West south
        (24.35, -82.90),                      # Tortugas south
        (24.75, -83.05),                      # Dry Tortugas west
        (25.5, -81.90),                       # Ten Thousand Islands
        (26.5, -82.40),                       # Fort Myers offshore
        (27.5, -83.00),                       # Tampa Bay offshore
        (28.8, -83.20),                       # Nature Coast offshore
        (29.5, -84.00),                       # Apalachee Bay
        (29.4, -85.50),                       # Cape San Blas offshore
        (30.0, -86.50),                       # Destin offshore
        (30.2, -87.30),                       # Pensacola Pass
        *[(la, lo) for la, lo in reversed(_PERDIDO)][:-1]],
    # --- South Carolina: west = Georgia's Chattooga/Tugaloo/Savannah
    # channel vertices verbatim; the 1735 coast-to-(34.8155,-79.6755)
    # diagonal is exact (both monumented endpoints shared with the NC
    # ring); the middle NC line and the Charlotte-notch panhandle are
    # conservative inside SC (Fort Mill/Tega Cay/Indian Land/Rock Hill
    # in; Pineville/Waxhaw NC left to the NC ring); the foothills
    # section rises with the surveyed line (Landrum in, Tryon out).
    ("US", "South Carolina"): [
        (34.99, -83.109),                     # Ellicott Rock (GA/NC)
        (34.90, -83.15),                      # Chattooga (GA shared)
        (34.75, -83.30),                      # Chattooga lower (shared)
        (34.54, -83.30),                      # Tugaloo (shared)
        (34.40, -82.90),                      # Hartwell (shared)
        (34.35, -82.82),                      # Savannah head (shared)
        (34.0, -82.60),                       # Calhoun Falls (shared)
        (33.66, -82.20),                      # Clarks Hill (shared)
        (33.48, -81.96),                      # Augusta (shared)
        (33.0, -81.60),                       # Millhaven (shared)
        (32.55, -81.25),                      # Clyo (shared)
        (32.30, -81.14),                      # Hardeeville (shared)
        (32.03, -80.87),                      # Savannah mouth (shared)
        (31.95, -80.65),                      # Atlantic offshore
        (32.50, -79.90),                      # Charleston offshore
        (33.00, -79.00),                      # Georgetown offshore
        (33.50, -78.30),                      # Grand Strand offshore
        (33.8514, -78.5414),                  # NC corner (monumented)
        (34.8155, -79.6755),                  # 1735 diagonal end (exact)
        (34.80, -80.30),                      # NC line (conservative)
        (34.80, -80.75),                      # Lancaster corner (cons.)
        (35.02, -80.81),                      # Indian Land panhandle
        (35.03, -80.95),                      # Fort Mill (cons.)
        (35.05, -81.06),                      # Tega Cay / Catawba
        (35.13, -81.12),                      # Kings Mountain (cons.)
        (35.15, -81.90),                      # Cherokee Foothills (cons.)
        (35.185, -82.20),                     # Landrum / Tryon line
        (35.07, -82.70)],                     # Caesars Head (cons.)
    # --- North Carolina: the 1735 diagonal (shared exact endpoints),
    # Georgia's 35N vertices and a conservative east-of-crest chain
    # against Tennessee's west-of-crest chain (Hot Springs/Murphy NC
    # in; the ridge strip falls to anchors); the VA line runs from the
    # (36.5888,-81.677) tripoint sloping to the surveyed 36.5441;
    # generous Outer Banks offshore edge.
    ("US", "North Carolina"): [
        (33.8514, -78.5414),                  # SC corner (monumented)
        (33.80, -78.50),                      # Atlantic offshore
        (33.80, -77.80),                      # Frying Pan offshore
        (34.50, -76.20),                      # Lookout offshore
        (35.00, -75.30),                      # Hatteras offshore
        (35.80, -75.30),                      # Bodie offshore
        (36.55, -75.50),                      # VA corner offshore
        (36.5505, -75.87),                    # VA line at the coast
        (36.5441, -76.50),                    # VA surveyed line
        (36.5441, -79.50),                    # VA surveyed line
        (36.56, -80.90),                      # VA line rising west
        (36.5888, -81.677),                   # TN/VA tripoint
        (36.33, -81.75),                      # Boone flank (cons.)
        (36.17, -82.05),                      # Roan flank (cons.)
        (35.90, -82.55),                      # Sams Gap flank (cons.)
        (35.93, -82.82),                      # Hot Springs wrap (cons.)
        (35.70, -83.02),                      # Max Patch flank (cons.)
        (35.62, -83.35),                      # Newfound Gap flank (cons.)
        (35.42, -83.75),                      # Smokies west (cons.)
        (35.25, -83.95),                      # Santeetlah flank (cons.)
        (35.05, -84.20),                      # Murphy flank (cons.)
        (35.0, -84.287),                      # GA/TN tripoint (shared)
        (34.99, -83.109),                     # Ellicott Rock (shared)
        (35.07, -82.70),                      # SC foothills (shared)
        (35.185, -82.20),                     # Landrum / Tryon (shared)
        (35.15, -81.90),                      # foothills (shared)
        (35.13, -81.12),                      # Kings Mountain (shared)
        (35.05, -81.06),                      # Catawba (shared)
        (35.03, -80.95),                      # Fort Mill (shared)
        (35.02, -80.81),                      # panhandle (shared)
        (34.80, -80.75),                      # Lancaster corner (shared)
        (34.80, -80.30),                      # line (shared)
        (34.8155, -79.6755)],                 # 1735 diagonal end (exact)
    # --- Kentucky: the ENTIRE north border is the three shared Ohio
    # River polylines verbatim (coincident with the OH/IN/IL rings —
    # every river twin city already split from the north side splits
    # identically from the south); the south border is the shared
    # _KY_TN Walker-line list; the Big Sandy/Tug Fork (WV) tracks the
    # channel at the Louisa/Williamson twin towns, then the VA ridge
    # chain is conservative (inside KY; the strip falls to anchors);
    # the Mississippi edge is conservative of the New Madrid bend (the
    # tiny Kentucky Bend exclave is ceded to anchors).
    ("US", "Kentucky"): [
        (38.485, -82.593),                    # Big Sandy mouth (channel)
        *_OHIO_RIVER_OH,                      # shared OH/KY river edge
        (39.103, -84.8029),                   # IN tripoint
        *_OHIO_RIVER_IN,                      # shared IN/KY river edge
        (37.80, -88.03),                      # Wabash mouth
        *_OHIO_RIVER_IL,                      # shared IL/KY river edge
        (36.984, -89.14),                     # Mississippi confluence
        (36.76, -89.13),                      # Columbus reach
        (36.57, -89.20),                      # Hickman
        (36.4977, -89.25),                    # conservative SW corner
        *[(la, lo) for la, lo in reversed(_KY_TN)],  # shared TN edge
        (36.70, -83.40),                      # White Rocks flank (cons.)
        (36.82, -83.15),                      # Cumberland Mtn (cons.)
        (36.93, -82.95),                      # Black Mountain (cons.)
        (37.06, -82.80),                      # Pine Mountain (cons.)
        (37.18, -82.60),                      # Pound Gap (Jenkins in)
        (37.24, -82.44),                      # Elkhorn flank (cons.)
        (37.295, -82.33),                     # Breaks (Elkhorn City in)
        *_TUG_BIG_SANDY],                     # shared WV channel edge
    # --- Tennessee: north = the shared _KY_TN Walker-line edge (plus
    # its own 36.4977 tail to the river) and the Bristol State Street
    # line 36.5951 (VA); south = the surveyed ~34.995 parallel (MS/AL/
    # GA) — East Ridge TN in, Rossville GA out; west = the Mississippi
    # channel (Memphis in, West Memphis AR out); east = conservative
    # Appalachian-crest chain inside TN (Mountain City/Johnson City/
    # Gatlinburg in, the NC slope falls to anchors).
    ("US", "Tennessee"): [
        (36.4977, -89.485),                   # river corner (Tiptonville)
        (36.4977, -89.4377),                  # bend west crossing
        (36.42, -89.36),                      # New Madrid dip (MO shared)
        (36.47, -89.26),                      # bend approach (MO shared)
        (36.4977, -89.2435),                  # bend east crossing (KY)
        *_KY_TN[::-1],                        # shared KY edge (W to E)
        (36.5951, -81.68),                    # Bristol line east end
        (36.55, -81.70),                      # Mountain City flank
        (36.20, -82.10),                      # Roan flank (cons.)
        (35.93, -82.58),                      # Sams Gap flank (cons.)
        (35.96, -82.88),                      # Paint Rock spike
        (35.80, -83.0),                       # Max Patch flank (cons.)
        (35.66, -83.46),                      # Newfound Gap flank
        (35.45, -84.0),                       # Smokies SW flank (cons.)
        (35.20, -84.20),                      # Hiwassee flank (cons.)
        (35.0, -84.287),                      # NC/GA tripoint (34.995N)
        (34.995, -84.32),                     # surveyed south line
        (34.995, -90.30),                     # line meets the Mississippi
        (35.13, -90.075),                     # Memphis / West Memphis
        (35.35, -90.09),                      # Loosahatchie reach
        (35.70, -89.955),                     # Osceola reach
        (36.19, -89.64),                      # Caruthersville reach
        (36.38, -89.54)],                     # Tiptonville reach
    # --- West Virginia: the Ellicott meridian -80.5194 (northern
    # panhandle east side, coincident with Pennsylvania's west edge)
    # and the Mason-Dixon 39.7222 are exact; the Fairfax Stone deed
    # line closes the MD west corner; the Potomac / North Branch edge
    # tracks the WV (south/west) bank within ~2 km — MD owns the river
    # — so the Piedmont/Westernport, Keyser/McCoole, Ridgeley/
    # Cumberland, Paw Paw, Falling Waters/Williamsport, Shepherdstown/
    # Sharpsburg and Harpers Ferry/Sandy Hook twins split correctly;
    # the Ohio River is the shared _OHIO_RIVER_WV list verbatim and
    # the Tug Fork/Big Sandy the shared _TUG_BIG_SANDY list; the VA
    # side is a conservative inside-WV Allegheny chain against
    # Virginia's inside-VA chain (Bluefield WV/VA, Peterstown/Rich
    # Creek, White Sulphur Springs/Covington and the Berkeley/
    # Frederick straight all split; the ridge strip falls to anchors).
    ("US", "West Virginia"): [
        (40.637, -80.5194),                   # OH/PA/WV tripoint (river)
        (39.7222, -80.5194),                  # Mason-Dixon west end (PA)
        (39.7222, -79.4766),                  # PA/MD/WV corner (exact)
        (39.1960, -79.4872),                  # Fairfax Stone
        (39.24, -79.42),                      # North Branch headwaters
        (39.285, -79.32),                     # Gormania
        (39.384, -79.18),                     # Kitzmiller south bank
        (39.482, -79.043),                    # Piedmont / Westernport
        (39.444, -78.976),                    # Keyser / McCoole
        (39.57, -78.83),                      # Patterson Creek bend
        (39.647, -78.765),                    # Ridgeley / Cumberland
        (39.53, -78.60),                      # Oldtown reach
        (39.535, -78.452),                    # Paw Paw
        (39.52, -78.38),                      # Paw Paw bends (cons. chord)
        (39.56, -78.32),                      # bends exit
        (39.622, -78.295),                    # Great Cacapon
        (39.692, -78.18),                     # Hancock south bank
        (39.60, -78.00),                      # Fort Frederick reach
        (39.598, -77.835),                    # Williamsport / Conococheague
        (39.55, -77.875),                     # Falling Waters
        (39.50, -77.885),                     # Dam No. 4 reach
        (39.468, -77.845),                    # Scrabble reach
        (39.437, -77.810),                    # Shepherdstown north
        (39.405, -77.755),                    # Antietam mouth
        (39.36, -77.775),                     # Dargan bend
        (39.328, -77.756),                    # Harpers Ferry west
        (39.3265, -77.72),                    # Shenandoah confluence
        (39.28, -77.78),                      # Loudoun Heights flank
        (39.25, -77.86),                      # Blue Ridge exit (cons.)
        (39.19, -77.96),                      # Rippon in / Berryville out
        (39.27, -78.04),                      # Berkeley straight (Bunker Hill)
        (39.36, -78.12),                      # Gerrardstown flank
        (39.44, -78.23),                      # Sleepy Creek (cons.)
        (39.50, -78.31),                      # north of the VA apex
        (39.44, -78.41),                      # Cacapon flank
        (39.28, -78.42),                      # Capon Bridge in
        (39.10, -78.54),                      # Hampshire crest (cons.)
        (39.02, -78.62),                      # Wardensville in
        (38.85, -78.86),                      # Lost River flank (Mathias in)
        (38.62, -79.15),                      # Brandywine in
        (38.55, -79.42),                      # Pendleton/Highland corner
        (38.46, -79.76),                      # Allegheny Mtn (Green Bank in)
        (38.20, -79.93),                      # Bath/Pocahontas crest (cons.)
        (37.95, -80.09),                      # Greenbrier flank
        (37.78, -80.26),                      # White Sulphur Springs in
        (37.56, -80.37),                      # Gap Mills in / Paint Bank out
        (37.405, -80.77),                     # Peterstown approach
        (37.395, -80.83),                     # Rich Creek out
        (37.37, -80.88),                      # Glen Lyn out
        (37.30, -81.05),                      # East River Mtn
        (37.255, -81.21),                     # Bluefield WV in
        (37.245, -81.36),                     # Bluefield VA out
        (37.28, -81.55),                      # Stony Ridge (Welch north)
        (37.30, -81.77),                      # War in
        (37.33, -81.90),                      # Bradshaw in
        (37.42, -82.05),                      # McDowell flank (Grundy out)
        *_TUG_BIG_SANDY,                      # shared KY channel edge
        (38.485, -82.593),                    # Big Sandy mouth (KY shared)
        *[(la, lo) for la, lo in reversed(_OHIO_RIVER_WV)]],  # shared OH
    # --- Virginia: the NC surveyed line and the TN Bristol segment
    # are the same vertices as those rings (coincident edges); the
    # KY and WV sides are conservative inside-VA chains SE of the
    # Pine/Cumberland Mountain crest and the Allegheny front (Pound,
    # Grundy, Bluefield VA, Narrows, Covington, Monterey, Berryville
    # in; the crest strips fall to anchors); the Potomac edge hugs
    # the VA bank — MD/DC own the river — so Arlington/Alexandria
    # stay in while DC, National Harbor and the MD north-bank towns
    # stay out; the Chesapeake Bay crossing keeps Tangier in and
    # Smith Island/Crisfield out (conservative of the 1877 line; the
    # Greenbackville sliver falls to anchors); the Atlantic edge is
    # generous offshore.
    ("US", "Virginia"): [
        (36.55, -75.50),                      # NC corner offshore (shared)
        (36.5505, -75.87),                    # NC line at the coast (shared)
        (36.5441, -76.50),                    # NC surveyed line (shared)
        (36.5441, -79.50),                    # NC surveyed line (shared)
        (36.56, -80.90),                      # NC line rising west (shared)
        (36.5888, -81.677),                   # TN/NC/VA tripoint (shared)
        (36.5951, -81.68),                    # Bristol line east end (TN)
        (36.60, -83.675),                     # Cumberland Gap (TN/KY shared)
        (36.655, -83.42),                     # Ewing under White Rocks
        (36.74, -83.12),                      # Pennington Gap flank
        (36.88, -82.86),                      # Big Stone Gap / Appalachia
        (36.96, -82.70),                      # Black Mtn SE flank
        (37.135, -82.615),                    # Pound Gap SE (Pound in)
        (37.20, -82.40),                      # Clintwood flank
        (37.30, -82.285),                     # Breaks village
        (37.33, -82.00),                      # Grundy in
        (37.27, -81.80),                      # War WV out
        (37.22, -81.55),                      # Stony Ridge S flank
        (37.246, -81.31),                     # East River Mtn (Bluefield VA)
        (37.242, -81.24),                     # Bluefield VA east
        (37.29, -81.05),                      # East River Mtn SE
        (37.33, -80.90),                      # Wolf Creek flank
        (37.377, -80.858),                    # Glen Lyn in
        (37.392, -80.820),                    # Rich Creek in / Peterstown out
        (37.355, -80.775),                    # Narrows in
        (37.47, -80.48),                      # Peters Mtn SE
        (37.60, -80.24),                      # Paint Bank in
        (37.73, -80.14),                      # Alleghany flank
        (37.92, -79.99),                      # Covington in
        (38.10, -79.85),                      # Warm Springs in
        (38.30, -79.72),                      # Highland W flank
        (38.45, -79.54),                      # Monterey in (N corner)
        (38.42, -79.20),                      # Shenandoah Mtn SE
        (38.60, -79.03),                      # Rockingham flank
        (38.78, -78.88),                      # Basye in
        (38.98, -78.62),                      # Great North Mtn SE
        (39.06, -78.50),                      # Star Tannery in
        (39.23, -78.40),                      # Frederick W
        (39.41, -78.34),                      # VA apex (cons., true 39.466)
        (39.25, -78.14),                      # Back Creek valley
        (39.28, -78.09),                      # Clear Brook in
        (39.21, -78.00),                      # Frederick/Clarke corner
        (39.165, -77.95),                     # Berryville in
        (39.24, -77.80),                      # Blue Ridge SE flank
        (39.30, -77.71),                      # Loudoun tip at the Potomac
        (39.302, -77.655),                    # Brunswick reach (MD out)
        (39.265, -77.55),                     # Point of Rocks reach
        (39.20, -77.47),                      # Monocacy mouth reach
        (39.12, -77.46),                      # Selden Island reach
        (39.06, -77.36),                      # Seneca reach
        (39.00, -77.27),                      # Great Falls VA in
        (38.955, -77.16),                     # Scotts Run
        (38.925, -77.12),                     # Chain Bridge
        (38.90, -77.068),                     # Rosslyn / Key Bridge
        (38.85, -77.038),                     # Reagan National east edge
        (38.80, -77.040),                     # Alexandria waterfront
        (38.77, -77.053),                     # Wilson Bridge west
        (38.70, -77.075),                     # Mount Vernon in
        (38.68, -77.11),                      # Gunston Cove
        (38.60, -77.20),                      # Occoquan / Woodbridge in
        (38.52, -77.27),                      # Quantico in
        (38.40, -77.31),                      # Aquia reach
        (38.36, -77.25),                      # Widewater
        (38.345, -77.05),                     # Dahlgren in
        (38.28, -76.95),                      # Colonial Beach in
        (38.20, -76.80),                      # Nomini reach (Cobb Is. out)
        (38.155, -76.62),                     # Coles Point in
        (38.05, -76.45),                      # Yeocomico reach
        (37.95, -76.33),                      # lower Potomac midline
        (37.89, -76.22),                      # Smith Point
        (37.90, -76.00),                      # bay line (Tangier in)
        (37.95, -75.75),                      # south of Crisfield MD
        (38.00, -75.62),                      # Pocomoke Sound
        (38.0425, -75.435),                   # Greenbackville in
        (38.0425, -75.405),                   # Stockton MD out
        (38.027, -75.24),                     # Chincoteague Bay crossing
        (37.60, -75.20),                      # Wallops offshore
        (37.10, -75.55),                      # Cape Charles offshore
        (36.80, -75.70)],                     # Virginia Beach offshore
    # --- Maryland: Mason-Dixon 39.7222 (shared PA vertices), the
    # Fairfax Stone deed line (shared WV), the MD/DE tangent line and
    # Transpeninsular 38.4510 (shared DE); the ENTIRE Potomac edge is
    # the WV and VA bank chains verbatim — MD owns the river, so every
    # vertex that keeps a WV/VA bank town out of Maryland keeps the
    # north-bank town in — with the District of Columbia square cut
    # out (its three landward sides exact, the NW side closed at the
    # river); the lower-bay / Delmarva line is the shared VA chain;
    # the Atlantic edge is generous offshore.
    ("US", "Maryland"): [
        (39.7222, -79.4766),                  # PA/MD/WV corner (exact)
        (39.7222, -75.788),                   # Mason-Dixon east end (PA/DE)
        (38.4510, -75.6931),                  # Transpeninsular middle (DE)
        (38.4510, -75.0490),                  # Fenwick Island (DE shared)
        (38.44, -74.95),                      # Atlantic offshore
        (38.05, -75.10),                      # Assateague offshore
        (38.027, -75.24),                     # Chincoteague Bay (VA shared)
        (38.0425, -75.405),                   # Stockton in (VA shared)
        (38.0425, -75.435),                   # Greenbackville out (shared)
        (38.00, -75.62),                      # Pocomoke Sound (VA shared)
        (37.95, -75.75),                      # Crisfield in (VA shared)
        (37.90, -76.00),                      # Smith Island in (VA shared)
        (37.89, -76.22),                      # Smith Point (VA shared)
        # Potomac VA-bank chain (shared VA vertices, upstream)
        (37.95, -76.33), (38.05, -76.45), (38.155, -76.62),
        (38.20, -76.80), (38.28, -76.95), (38.345, -77.05),
        (38.36, -77.25), (38.40, -77.31), (38.52, -77.27),
        (38.60, -77.20), (38.68, -77.11), (38.70, -77.075),
        (38.77, -77.053),
        # District of Columbia cut-out (original-square sides exact)
        (38.7916, -77.0404),                  # DC south corner (Jones Pt)
        (38.8927, -76.9094),                  # DC east corner
        (38.9955, -77.0410),                  # DC north corner
        (38.934, -77.121),                    # DC NW side at the river
        # Potomac VA-bank chain resumes (shared VA vertices)
        (38.955, -77.16), (39.00, -77.27), (39.06, -77.36),
        (39.12, -77.46), (39.20, -77.47), (39.265, -77.55),
        (39.302, -77.655),
        (39.30, -77.71),                      # Loudoun tip (VA shared)
        # Potomac WV-bank chain (shared WV vertices, upstream)
        (39.3265, -77.72), (39.328, -77.756), (39.36, -77.775),
        (39.405, -77.755), (39.437, -77.810), (39.468, -77.845),
        (39.50, -77.885), (39.55, -77.875), (39.598, -77.835),
        (39.60, -78.00), (39.692, -78.18), (39.622, -78.295),
        (39.56, -78.32), (39.52, -78.38), (39.535, -78.452),
        (39.53, -78.60), (39.647, -78.765), (39.57, -78.83),
        (39.444, -78.976), (39.482, -79.043), (39.384, -79.18),
        (39.285, -79.32), (39.24, -79.42),
        (39.1960, -79.4872)],                 # Fairfax Stone (WV shared)
    # --- Delaware: the Mason-Dixon tangent line (straight between the
    # shared PA/MD corner and the Transpeninsular middle point, ~1 km
    # envelope at mid-line), the Transpeninsular 38.4510 exact (Delmar
    # and Fenwick/Ocean City split), the Twelve-Mile-Circle chords
    # shared verbatim with Pennsylvania, the NJ-shore edge inside the
    # circle (Delaware owns the river to the New Jersey low-water
    # mark: Penns Grove/Pennsville NJ stay out by the shore line),
    # mid-bay below the circle, generous Atlantic.
    ("US", "Delaware"): [
        (39.7222, -75.788),                   # PA/MD corner (shared)
        (38.4510, -75.6931),                  # Transpeninsular middle
        (38.4510, -75.0490),                  # Fenwick Island (MD shared)
        (38.50, -74.90),                      # Atlantic offshore
        (38.85, -74.95),                      # bay mouth (Cape May out)
        (39.05, -75.12),                      # mid-bay
        (39.20, -75.28),                      # mid-bay (Fortescue out)
        (39.40, -75.40),                      # mid-bay narrows
        (39.55, -75.54),                      # Salem NJ out
        (39.65, -75.52),                      # Pennsville NJ out (circle)
        (39.73, -75.475),                     # Penns Grove NJ out (circle)
        (39.80, -75.43),                      # arc start (PA shared)
        (39.83, -75.56),                      # Twelve-Mile chord (PA shared)
        (39.78, -75.72)],                     # Twelve-Mile chord (PA shared)
    # --- New Jersey: the west edge is the shared _DELAWARE_PA_NJ
    # channel list reversed (coincident with Pennsylvania); inside the
    # Twelve-Mile Circle and down Delaware Bay the edge reuses
    # Delaware's NJ-shore/mid-bay vertices verbatim (Delaware owns the
    # river to the NJ low-water mark, so Pennsville/Penns Grove/Salem
    # sit between the two rings' shared vertices and resolve NJ); the
    # north edge is the 1774 straight line from the tri-state to the
    # Hudson (ends mid-river at the shared _NY_NJ_WATER top vertex —
    # the real line wobbles <~1 km about straight); the east edge is
    # the shared _NY_NJ_WATER channel list reversed; the Atlantic is
    # generous offshore (Sandy Hook to Cape May in).
    ("US", "New Jersey"): [
        (41.357, -74.695),                    # tri-state (PA/NY shared)
        *[(la, lo) for la, lo in reversed(_NY_NJ_WATER)],
        (40.40, -73.90),                      # Atlantic offshore
        (40.10, -73.90),                      # offshore (Asbury Park)
        (39.60, -74.10),                      # offshore (Barnegat)
        (39.20, -74.40),                      # offshore (Atlantic City)
        (38.85, -74.80),                      # offshore (Wildwood)
        (38.85, -74.95),                      # bay mouth (DE shared)
        (39.05, -75.12),                      # mid-bay (DE shared)
        (39.20, -75.28),                      # mid-bay (DE shared)
        (39.40, -75.40),                      # mid-bay narrows (DE shared)
        (39.55, -75.54),                      # Salem reach (DE shared)
        (39.65, -75.52),                      # Pennsville (DE shared)
        (39.73, -75.475),                     # Penns Grove (DE shared)
        *[(la, lo) for la, lo in reversed(_DELAWARE_PA_NJ)]],
    # --- New York: the PA border is exact (-79.762 meridian, the 42N
    # parallel) plus the shared _DELAWARE_NY_PA channel; the NJ border
    # is the 1774 line + shared _NY_NJ_WATER verbatim; the Niagara
    # follows the west (Chippawa) channel around Grand Island and the
    # gorge midline (Fort Erie/Chippawa/Niagara Falls ON/Queenston/
    # Niagara-on-the-Lake out, Buffalo/Grand Island/Niagara Falls NY/
    # Lewiston/Youngstown in); Lakes Erie/Ontario ride the
    # international midline (Toronto side out, Main Duck out, Galloo
    # in); the St. Lawrence channel passes south of Wolfe Island and
    # splits Clayton/Gananoque, Alexandria Bay/Rockport, Morristown/
    # Brockville, Ogdensburg/Prescott, Massena/Cornwall; the Canada
    # line east of St. Regis is the surveyed ~45.005 (Rouses Point and
    # Fort Covington in, Dundee/Hemmingford/Lacolle QC out); Lake
    # Champlain rides the midline (Plattsburgh/Essex/Ticonderoga in,
    # Grand Isle/Burlington/Chimney Point VT out) to the Poultney
    # corner; the VT/MA lines are near-straight surveyed chains; the
    # CT border is the Oblong line, the panhandle north edge and the
    # Byram corner (Greenwich/Stamford/Ridgefield/Danbury out, Rye/
    # White Plains/Armonk/Bedford/Brewster in); Long Island Sound
    # rides the NY/CT marine midline east (Orient, Plum and Fishers
    # Islands in; New London/Mystic/Stonington/Watch Hill out; Block
    # Island RI out) and the Atlantic side is generous offshore.
    ("US", "New York"): [
        (42.0, -79.762),                      # PA west line (shared)
        (42.28, -79.762),                     # lake edge (PA shared)
        (42.55, -79.25),                      # Lake Erie midline
        (42.80, -78.95),                      # Lake Erie midline NE
        (42.90, -78.908),                     # river head (Fort Erie W)
        (42.94, -78.94),                      # Black Rock reach
        (42.99, -79.00),                      # Chippawa channel (S of GI)
        (43.03, -79.03),                      # Chippawa channel
        (43.06, -79.045),                     # Welland mouth reach
        (43.078, -79.07),                     # Horseshoe Falls midline
        (43.12, -79.063),                     # Whirlpool gorge
        (43.16, -79.047),                     # Queenston / Lewiston
        (43.27, -79.063),                     # river mouth (NOTL out)
        (43.32, -79.00),                      # Lake Ontario (US waters)
        (43.40, -78.40),                      # lake midline
        (43.50, -77.40),                      # lake midline
        (43.55, -76.95),                      # lake midline east
        (43.90, -76.60),                      # Main Duck out, Galloo in
        (44.10, -76.42),                      # south of Wolfe Island
        (44.145, -76.33),                     # Cape Vincent reach
        (44.20, -76.20),                      # St. Lawrence midline
        (44.27, -76.05),                      # Clayton reach
        (44.36, -75.90),                      # Alexandria Bay reach
        (44.50, -75.75),                      # midline
        (44.595, -75.665),                    # Morristown / Brockville
        (44.703, -75.505),                    # Ogdensburg / Prescott
        (44.82, -75.25),                      # midline
        (44.98, -74.85),                      # Massena reach (Cornwall N)
        (45.005, -74.66),                     # St. Regis (45N line)
        *_NY_VT,                              # shared VT lake+land edge
        *_NY_CT,                              # shared CT land+Sound edge
        (41.25, -71.80),                      # east of Fishers (Watch Hill)
        (41.05, -71.70),                      # Block Island out, Montauk in
        (40.90, -71.75),                      # Atlantic offshore
        (40.55, -73.40),                      # offshore (Fire Island in)
        (40.44, -73.80),                      # offshore (Long Beach in)
        *_NY_NJ_WATER,                        # shared NJ water edge
        (41.357, -74.695),                    # tri-state (1774 line end)
        *[(la, lo) for la, lo in reversed(_DELAWARE_NY_PA)],
        (42.0, -75.36)],                      # 42N meets the Delaware
    # --- Connecticut: the west/south frontier is the shared _NY_CT
    # land+Sound chain reversed (coincident with New York); the north
    # edge is the shared _CT_MA surveyed line with the Southwick Jog;
    # the east edge is the shared _CT_RI Pawcatuck + -71.7972 line;
    # the southeast corner threads the Stonington peninsula in while
    # Watch Hill RI stays out.
    ("US", "Connecticut"): [
        *[(la, lo) for la, lo in reversed(_CT_RI)],
        *[(la, lo) for la, lo in reversed(_NY_CT)],
        *_CT_MA[1:-1]],                       # endpoints already present
    # --- Rhode Island: the shared _CT_RI west edge, the 42.0157 north
    # line and _RI_MA_EAST (both shared verbatim with Massachusetts),
    # and a generous Atlantic that encloses Block Island — which the
    # New York ring's (41.25,-71.80)/(41.05,-71.70) edge (reused here
    # verbatim, coincident) deliberately left outside.
    ("US", "Rhode Island"): [
        *_CT_RI,                              # Pawcatuck + north line
        (42.0157, -71.3817),                  # 42.0157 line (MA shared)
        *_RI_MA_EAST[1:],                     # east edge (MA shared)
        (41.25, -71.25),                      # Atlantic (Sakonnet out E)
        (41.05, -71.55),                      # south of Block Island
        (41.05, -71.70),                      # NY-ring vertex (shared)
        (41.25, -71.80),                      # NY-ring vertex (shared)
        (41.29, -71.87)],                     # Watch Hill offshore (stays
                                              #   east of the NY edge)
    # --- Massachusetts: every land border is a shared list — the
    # NY/MA line (vertices shared with New York), _MA_NH, _CT_MA and
    # _RI_MA_EAST — plus the MA/VT near-straight surveyed line from
    # the NY corner to the Connecticut River; the Atlantic envelope
    # wraps Cape Ann, Cape Cod, Nantucket and Martha's Vineyard.
    ("US", "Massachusetts"): [
        (42.0497, -73.4875),                  # NY/MA/CT tripoint (shared)
        (42.7449, -73.2764),                  # MA/VT/NY tripoint (shared)
        *_MA_NH,                              # shared NH line + seaward
        (42.70, -70.50),                      # Cape Ann offshore
        (42.55, -70.45),                      # offshore
        (42.30, -70.55),                      # Stellwagen reach
        (42.25, -70.05),                      # outer Cape offshore
        (42.10, -69.90),                      # offshore (Provincetown in)
        (41.85, -69.75),                      # offshore (Chatham E)
        (41.40, -69.80),                      # offshore
        (41.10, -69.95),                      # south of Nantucket
        (41.15, -70.70),                      # south of the Vineyard
        (41.20, -70.95),                      # offshore (Cuttyhunk in)
        *[(la, lo) for la, lo in reversed(_RI_MA_EAST)],
        *list(reversed(_CT_MA))[:-1]],        # first vertex closes ring
    # --- Vermont: the west edge is the shared _NY_VT lake+land chain
    # reversed (coincident with New York — the Champlain midline keeps
    # Alburgh and Isle La Motte in); the north edge continues the same
    # surveyed ~45.005 Canada line as New York (Derby Line sits ON the
    # line and is unasserted); the east edge is the shared
    # _CT_RIVER_VT_NH west-bank chain (New Hampshire owns the river);
    # the south edge closes on the MA/VT surveyed line, coincident
    # with Massachusetts.
    ("US", "Vermont"): [
        *[(la, lo) for la, lo in reversed(_NY_VT)],
        *_CT_RIVER_VT_NH,                     # shared NH river edge
        (42.7269, -72.4583)],                 # VT/NH/MA corner (shared)
    # --- New Hampshire: the west edge is _CT_RIVER_VT_NH reversed (the
    # river itself is New Hampshire, matching the 1933 decree); the
    # Canada edge is Halls Stream and the highlands divide; the east
    # edge is the shared _NH_ME line/river chain; the south edge is
    # the shared _MA_NH chain reversed.
    ("US", "New Hampshire"): [
        *[(la, lo) for la, lo in reversed(_CT_RIVER_VT_NH)],
        (45.10, -71.49),                      # Halls Stream (E Hereford W)
        (45.20, -71.43),                      # Halls Stream upper
        (45.26, -71.36),                      # highlands divide corner
        *_NH_ME,                              # shared ME line + seaward
        *[(la, lo) for la, lo in reversed(_MA_NH)]],
    # --- Maine: the QC border follows the highlands divide northeast
    # (Coburn Gore/Jackman crossings), the straight northeast line to
    # Estcourt, the St. Francis and St. John channels (Fort Kent/
    # Van Buren ME south bank, Clair/Edmundston/Saint-Leonard NB
    # north), the exact -67.7837 due-south line (Houlton in, Grand
    # Falls/Woodstock NB out), the Chiputneticook Lakes and St. Croix
    # (Calais in, St. Stephen NB out), and Passamaquoddy Bay threading
    # Eastport and Lubec in while Deer Island and Campobello NB stay
    # Canadian; the Atlantic envelope wraps Mount Desert, Matinicus
    # and Monhegan but stays west of Grand Manan.
    ("US", "Maine"): [
        (45.3055, -71.0840),                  # NH/ME/QC corner (shared)
        (45.33, -70.92),                      # divide (Woburn QC out)
        (45.347, -70.80),                     # Coburn Gore crossing
        (45.40, -70.73),                      # divide
        (45.47, -70.66),                      # divide
        (45.57, -70.47),                      # divide (Megantic out)
        (45.667, -70.40),                     # divide
        (45.72, -70.28),                      # Boundary Bald reach
        (45.77, -70.39),                      # Armstrong crossing
        (45.95, -70.31),                      # divide
        (46.09, -70.29),                      # St-Georges reach (QC out)
        (46.27, -70.20),                      # divide
        (46.42, -70.06),                      # Ste-Aurelie reach
        (46.58, -69.99),                      # divide
        (46.70, -69.87),                      # Lac Frontiere corner
        (47.46, -69.22),                      # Estcourt (NE straight)
        (47.32, -69.05),                      # St. Francis River
        (47.28, -68.95),                      # St. Francis mouth
        (47.26, -68.60),                      # St. John (Fort Kent in)
        (47.36, -68.33),                      # Madawaska / Edmundston
        (47.30, -68.10),                      # Grand Isle reach
        (47.16, -67.93),                      # Van Buren / St-Leonard
        (47.066, -67.7837),                   # Grand Falls bend (exact)
        (45.94, -67.7837),                    # the Monument (line exact)
        (45.79, -67.76),                      # North Lakes
        (45.60, -67.52),                      # Chiputneticook Lakes
        (45.568, -67.425),                    # Vanceboro reach
        (45.35, -67.44),                      # St. Croix River
        (45.19, -67.277),                     # Calais / St. Stephen
        (45.13, -67.17),                      # St. Croix estuary
        (45.07, -67.10),                      # estuary (St. Andrews out)
        (44.97, -67.02),                      # Passamaquoddy (Deer Is out)
        (44.90, -66.968),                     # Western Passage (Eastport)
        (44.87, -66.966),                     # Friar Roads (Welshpool out)
        (44.82, -66.95),                      # Lubec Narrows reach
        (44.65, -67.05),                      # Grand Manan Channel
        (44.20, -67.60),                      # Atlantic offshore
        (43.90, -68.40),                      # offshore (Matinicus in)
        (43.60, -69.50),                      # offshore (Monhegan in)
        (43.30, -70.30),                      # offshore (Portland in)
        *list(reversed(_NH_ME))[:-1]],        # shared NH edge (dedup)
    # --- Alaska: the 141W meridian is exact and shared with Yukon's
    # ring; the 60N closing edge is coincident with Yukon's south
    # border; the panhandle edge reuses British Columbia's Portland
    # Canal / conservative-interior chain VERBATIM (Hyder AK west of
    # the canal, Stewart BC east; the dead strip of the conservative
    # interior run is claimed seaward, where there are no BC towns);
    # the Dixon Entrance edge meets BC's marine line at its own
    # vertices; the Bering edge threads the 1867 treaty line between
    # the Diomedes (-168.98 exact: Little Diomede US, Big Diomede RU)
    # and between St. Lawrence Island and Chukotka; the ring clips at
    # -179.9 (no shipped ring crosses the antimeridian), so the far
    # western Aleutians (Attu/Shemya/Kiska) fall to anchors.
    ("US", "Alaska"): [
        (60.0, -141.0),                       # YT corner (141W exact)
        (69.7, -141.0),                       # Beaufort end (YT shared)
        (70.5, -141.3),                       # Arctic generous
        (71.6, -156.5),                       # Utqiagvik offshore
        (72.2, -165.0),                       # Chukchi generous
        (68.5, -168.98),                      # treaty meridian north
        (65.4, -168.98),                      # Diomedes split (exact)
        (64.2, -170.5),                       # strait southwest
        (64.05, -173.0),                      # St. Lawrence / Chukotka
        (62.5, -176.0),                       # treaty line southwest
        (58.5, -179.9),                       # antimeridian clip
        (51.2, -179.9),                       # antimeridian clip south
        (51.0, -170.0),                       # Aleutians south (Adak in)
        (52.0, -163.0),                       # south of Unalaska
        (54.0, -156.0),                       # Alaska Peninsula south
        (56.0, -150.0),                       # Kodiak offshore
        (58.5, -143.0),                       # Gulf of Alaska
        (57.8, -137.5),                       # Sitka offshore
        (56.0, -136.0),                       # Baranof offshore
        (54.8, -134.8),                       # ocean corner
        (54.6, -134.5),                       # Dixon Entrance approach
        (54.49, -132.5),                      # A-B line (BC shared)
        (54.5, -131.0),                       # Dixon Entrance (BC shared)
        (54.55, -130.7),                      # Portland Inlet (BC shared)
        (55.3, -129.95),                      # Portland Canal (BC shared)
        (55.90, -130.0),                      # canal head (BC shared)
        (55.936, -129.99),                    # Hyder / Stewart (BC shared)
        (56.2, -130.0),                       # Salmon River (BC shared)
        (56.6, -131.0),                       # panhandle (BC shared)
        (57.3, -131.8),                       # panhandle (BC shared)
        (58.1, -132.9),                       # panhandle (BC shared)
        (58.7, -133.7),                       # panhandle (BC shared)
        (59.1, -134.2),                       # panhandle (BC shared)
        (59.45, -134.6),                      # panhandle (BC shared)
        (59.7, -135.2),                       # White Pass (BC shared)
        (59.75, -136.2),                      # panhandle (BC shared)
        (59.3, -137.3),                       # Fairweather (BC shared)
        (59.7, -138.3),                       # panhandle (BC shared)
        (60.0, -139.0)],                      # YT corner (BC shared)
    # --- Hawaii: a generous ocean envelope around the eight main
    # islands (Niihau to the Big Island); the uninhabited Northwestern
    # Hawaiian Islands beyond Kauai (and Midway, which is a US Minor
    # Outlying Island, not Hawaii) stay outside and fall to anchors.
    ("US", "Hawaii"): [
        (22.8, -160.8), (22.8, -154.6),
        (18.6, -154.6), (18.6, -160.8)],
    # --- Argentina: Patagonian provinces whose major borders are the
    # 42S / 46S / 52S parallels (exact); the Andes border with Chile
    # is conservative (east of the true line), the Atlantic generous.
    # La Pampa: the -35 parallel (San Luis/Cordoba) and the -63.3833
    # meridian (Buenos Aires) are exact-class; the Colorado River
    # chain tracks the channel within ~3 km (25 de Mayo LP in,
    # Catriel RN out); the Mendoza side is conservative (the 36S
    # step approximated inside).
    ("AR", "La Pampa"): [
        (-35.0, -63.3833),                    # the -35 line (exact)
        (-39.09, -63.3833),                   # -63.3833 meridian (exact)
        (-38.985, -64.085),                   # Colorado (La Adela reach)
        (-38.9, -65.3),                       # Colorado
        (-38.77, -66.44),                     # Colorado (Gob. Duval in)
        (-38.25, -67.2),                      # Colorado (Casa de Piedra)
        (-37.81, -67.72),                     # 25 de Mayo / Catriel
        (-37.3, -68.0),                       # Colorado upper reach
        (-36.88, -68.2),                      # river corner (conserv.)
        (-35.0, -68.2)],                      # Mendoza line (conserv.)
    ("AR", "Chubut"): [
        (-42.0, -71.0), (-42.0, -60.0), (-46.0, -60.0),
        (-46.0, -71.0)],
    ("AR", "Santa Cruz"): [
        (-46.0, -71.7), (-46.0, -60.0), (-52.0, -60.0),
        (-52.0, -68.4), (-52.0, -71.8), (-51.0, -72.0),
        (-48.0, -72.2)],
    # --- Mexico (round 4h): the ENTIRE US border is shared vertices —
    # California's straight line and Colorado-corner, Arizona's two
    # treaty lines, New Mexico's bootheel and the whole Texas Rio
    # Grande channel (every twin pair proven from the US side —
    # Tijuana/San Diego, Mexicali/Calexico, Juarez/El Paso, Nuevo
    # Laredo/Laredo, Matamoros/Brownsville — now resolves its Mexican
    # half); the Guatemala side carries the exact 17.8167 Peten
    # parallel and an Usumacinta/Chiapas chain (conservative where
    # surveyed detail exceeds authoring precision); the Belize side
    # follows the Rio Hondo (Chetumal in, Corozal BZ out) and Boca
    # Bacalar Chico (Ambergris Caye BZ out); both ocean sides are
    # generous, with the Gulf of California interior.
    ("MX", None): [
        (32.534, -117.124),                   # CA corner (shared)
        (32.718, -114.719),                   # Colorado corner (shared)
        (32.49, -114.81),                     # AZ line west (shared)
        (31.33, -111.07),                     # AZ treaty line (shared)
        (31.33, -108.21),                     # 31.33 parallel (NM shared)
        (31.78, -108.21),                     # NM bootheel (shared)
        (31.78, -106.53),                     # bootheel east (TX shared)
        (31.75, -106.47),                     # Juarez / El Paso (shared)
        (31.5, -106.2),                       # Rio Grande (TX shared,
        (31.1, -105.6),                       #   reversed downstream)
        (30.68, -105.0),
        (30.1, -104.72),
        (29.555, -104.40),                    # Ojinaga / Presidio
        (29.17, -103.6),
        (29.0, -103.15),
        (29.2, -102.7),
        (29.8, -102.1),
        (29.75, -101.4),
        (29.45, -101.05),
        (29.33, -100.92),                     # Acuna / Del Rio
        (29.0, -100.65),
        (28.7, -100.51),                      # Piedras Negras / Eagle P.
        (28.05, -100.05),
        (27.5, -99.515),                      # Nuevo Laredo / Laredo
        (26.9, -99.32),
        (26.55, -99.17),
        (26.398, -99.06),
        (26.401, -99.021),
        (26.36, -98.82),
        (26.09, -98.26),                      # Reynosa / McAllen
        (26.063, -97.953),
        (25.888, -97.50),                     # Matamoros / Brownsville
        (25.955, -97.15),                     # river mouth (TX shared)
        (25.6, -96.9),                        # Gulf offshore
        (22.3, -97.1),                        # Tampico offshore
        (19.5, -95.3),                        # Veracruz offshore
        (18.4, -93.9),                        # Coatzacoalcos offshore
        (18.9, -92.0),                        # Campeche bight
        (20.2, -90.8),                        # Campeche offshore
        (21.7, -90.4),                        # Yucatan north offshore
        (21.9, -87.2),                        # Cabo Catoche offshore
        (21.5, -86.5),                        # Cancun offshore
        (20.3, -86.6),                        # Cozumel offshore
        (19.0, -87.2),                        # Tulum/Sian Kaan offshore
        (18.6, -87.4),                        # Xcalak approach
        (18.19, -87.83),                      # Boca Bacalar Chico
        (18.4, -88.05),                       # Chetumal Bay midline
        (18.49, -88.30),                      # Hondo mouth (Corozal out)
        (18.2, -88.6),                        # Rio Hondo (BZ line)
        (17.95, -88.9),                       # Rio Hondo upper
        (17.8167, -89.15),                    # MX/BZ/GT tripoint (exact)
        (17.8167, -90.99),                    # Peten parallel (exact)
        (17.25, -91.43),                      # Usumacinta (Palenque in)
        (16.4, -90.4),                        # Usumacinta upper
        (16.07, -90.43),                      # Chiapas corner
        (16.08, -91.74),                      # the straight line
        (15.5, -92.12),                       # Motozintla in
        (15.0, -92.17),                       # Tacana GT out
        (14.68, -92.147),                     # Suchiate midline (Cd.
                                              #   Hidalgo / Tecun Uman)
        (14.54, -92.23),                      # Suchiate mouth
        (14.3, -92.9),                        # Pacific offshore
        (15.5, -97.5),                        # Oaxaca offshore
        (16.3, -100.5),                       # Acapulco offshore
        (17.8, -103.0),                       # Michoacan offshore
        (18.6, -104.8),                       # Manzanillo offshore
        (20.0, -106.3),                       # Vallarta offshore
        (22.5, -107.3),                       # Islas Marias in
        (22.2, -110.5),                       # Cabo San Lucas offshore
        (24.0, -113.0),                       # Baja Pacific offshore
        (27.5, -115.8),                       # Baja Pacific offshore
        (29.5, -116.6),                       # Baja north offshore
        (31.5, -117.6)],                      # Tijuana offshore
    # --- Peru / Bolivia / Paraguay / Brazil (round 4h): the Andes and
    # Amazon frontiers are conservative chains (jungle, few towns);
    # the classic exact pieces — the Concordia vertices (Chile
    # shared), the Titicaca crossing, the 22S-region Villazon/La
    # Quiaca step, the Chaco lines, the Apaporis-Tabatinga line and
    # the Pedro Juan Caballero border street — are carried; every
    # border two of these rings share is one vertex run in both.
    ("PE", None): [
        (-18.35, -70.42),                     # Concordia (CL shared)
        (-17.9, -69.8),                       # Concordia line (shared)
        (-17.65, -69.47),                     # CL/BO corner (shared)
        (-16.9, -69.2),                       # BO line (shared)
        (-16.3, -69.15),                      # Titicaca crossing (Puno
        (-15.5, -69.4),                       #   PE west, Copacabana BO)
        (-14.0, -68.9),                       # BO cordillera (shared)
        (-12.5, -68.7),                       # BO jungle (shared)
        (-11.2, -69.4),                       # BO line (shared)
        (-10.95, -69.57),                     # PE/BO/BR tripoint
        (-9.8, -70.6),                        # BR line (shared)
        (-7.1, -73.8),                        # Breu bulge (shared)
        (-5.5, -72.5),                        # Yavari (BR shared)
        (-4.4, -70.1),                        # Yavari mouth (BR shared)
        (-4.23, -69.94),                      # Tabatinga corner (shared)
        (-3.7, -70.35),                       # CO trapezoid (Leticia out)
        (-2.5, -71.7),                        # Putumayo (conserv.)
        (-2.2, -73.0),                        # Putumayo (conserv.)
        (-1.6, -74.2),                        # CO/EC region (conserv.)
        (-2.3, -76.3),                        # EC line (conserv.)
        (-4.4, -78.6),                        # Condor (conserv.)
        (-4.55, -79.5),                       # EC south bulge (Loja out)
        (-4.55, -79.9),                       # Macara region
        (-3.42, -80.30),                      # Boca de Capones (coast)
        (-3.3, -81.3),                        # Pacific offshore
        (-6.0, -82.0),                        # Pacific offshore
        (-14.0, -77.5),                       # Pacific (Lima offshore)
        (-18.4, -71.2)],                      # Pacific south
    ("BO", None): [
        (-17.65, -69.47),                     # PE/CL corner (shared)
        (-16.9, -69.2),                       # PE line (shared)
        (-16.3, -69.15),                      # Titicaca (PE shared)
        (-15.5, -69.4),                       # PE line (shared)
        (-14.0, -68.9),                       # PE line (shared)
        (-12.5, -68.7),                       # PE line (shared)
        (-11.2, -69.4),                       # PE line (shared)
        (-10.95, -69.57),                     # PE/BR tripoint (shared)
        (-11.018, -68.76),                    # Acre twins (Cobija/
        (-10.62, -68.15),                     #   Brasileia, BR shared)
        (-10.0, -66.7),                       # Abuna (BR shared)
        (-9.9, -65.4),                        # Madeira (BR shared)
        (-10.81, -65.345),                    # Guayaramerin / Guajara-M.
        (-12.5, -63.1),                       # Mamore/Itenez (BR shared)
        (-13.5, -61.0),                       # Itenez (BR shared)
        (-15.0, -60.2),                       # the straight (BR shared)
        (-16.3, -58.4),                       # San Matias (BR shared)
        (-17.2, -58.3),                       # Pantanal (BR shared)
        (-18.2, -57.7),                       # Paraguay River (shared)
        (-19.0, -57.72),                      # Pto Suarez / Corumba
        (-19.5, -58.1),                       # Bahia Negra approach
        (-20.1, -58.2),                       # BO/PY/BR corner (shared)
        (-19.5, -59.1),                       # Chaco line (PY shared)
        (-19.8, -60.6),                       # Chaco line (PY shared)
        (-21.0, -62.27),                      # Chaco line (PY shared)
        (-22.25, -62.64),                     # BO/PY/AR corner (shared)
        (-22.1, -63.68),                      # Yacuiba dip (AR line)
        (-22.0, -64.3),                       # AR line (conserv.)
        (-22.1, -65.6),                       # Villazon / La Quiaca
        (-22.6, -66.3),                       # AR puna (conserv.)
        (-22.8, -67.2),                       # Zapaleri corner
        (-22.9, -67.85),                      # CL chain (shared)
        (-21.3, -68.15),                      # CL chain (shared)
        (-20.5, -68.45),                      # CL chain (shared)
        (-19.0, -68.6)],                      # CL chain (shared)
    ("PY", None): [
        (-20.1, -58.2),                       # BO/BR corner (shared)
        (-21.2, -57.85),                      # Paraguay R. (BR shared)
        (-22.1, -57.9),                       # Apa corner (BR shared)
        (-22.05, -56.4),                      # Apa line (BR shared)
        (-22.3, -55.80),                      # ridge (BR shared)
        (-22.45, -55.7275),                   # the border street (Pedro
        (-22.65, -55.7275),                   #   Juan C. / Ponta Pora)
        (-23.1, -55.3),                       # ridge (BR shared)
        (-23.9, -54.9),                       # ridge (BR shared)
        (-24.0, -54.3),                       # Salto del Guaira (shared)
        (-24.7, -54.45),                      # Parana (BR shared)
        (-25.52, -54.60),                     # Cd. del Este / Foz do I.
        (-25.59, -54.59),                     # PY/BR/AR triple (shared)
        (-26.0, -54.75),                      # Parana (AR side)
        (-26.9, -55.4),                       # Parana midline
        (-27.35, -55.885),                    # Encarnacion / Posadas
        (-27.4, -56.5),                       # Parana midline west
        (-27.27, -57.5),                      # Parana bend
        (-26.9, -58.2),                       # Paraguay River (AR side)
        (-26.3, -58.15),                      # river midline
        (-25.6, -57.85),                      # river midline
        (-25.37, -57.655),                    # Pilcomayo mouth
        (-25.27, -57.70),                     # Asuncion in, Clorinda out
        (-25.30, -58.0),                      # Pilcomayo (AR line)
        (-24.7, -59.3),                       # Pilcomayo (conserv.)
        (-23.8, -60.6),                       # Chaco (conserv.)
        (-23.0, -61.8),                       # Chaco (conserv.)
        (-22.25, -62.64)],                    # BO/AR corner (shared)
    ("BR", None): [
        (-33.72, -53.39),                     # Chuy coast (UY strip gap)
        (-32.45, -53.37),                     # Merin east (SVP in)
        (-31.95, -54.16),                     # Acegua in
        (-31.0, -55.40),                      # approach
        (-30.897, -55.50),                    # the border street:
        (-30.897, -55.62),                    #   Livramento BR north,
        (-30.55, -56.10),                     #   Rivera UY south
        (-30.45, -56.46),                     # Quarai in
        (-30.2, -57.6),                       # BR/UY/AR corner (shared)
        (-29.73, -57.08),                     # Uruguaiana / P. Libres
        (-28.6, -56.02),                      # Sao Borja / Santo Tome
        (-27.8, -55.12),                      # Uruguay R. (AR side)
        (-27.12, -53.85),                     # Pepiri corner
        (-26.3, -53.68),                      # San Antonio line
        (-25.55, -53.96),                     # Iguazu corner
        (-25.6, -54.45),                      # Iguazu midline (falls AR)
        (-25.59, -54.59),                     # PY/AR triple (shared)
        (-25.52, -54.60),                     # Foz in, CdE PY out
        (-24.7, -54.45),                      # Parana (PY shared)
        (-24.0, -54.3),                       # Salto del Guaira (shared)
        (-23.9, -54.9),                       # PY ridge (shared)
        (-23.1, -55.3),                       # PY ridge (shared)
        (-22.65, -55.7275),                   # the border street
        (-22.45, -55.7275),                   #   (Ponta Pora in)
        (-22.3, -55.80),                      # PY ridge (shared)
        (-22.05, -56.4),                      # Apa line (PY shared)
        (-22.1, -57.9),                       # Apa corner (PY shared)
        (-21.2, -57.85),                      # Paraguay R. (PY shared)
        (-20.1, -58.2),                       # BO/PY corner (shared)
        (-19.5, -58.1),                       # BO chain (shared)
        (-19.0, -57.72),                      # Corumba in (BO shared)
        (-18.2, -57.7),                       # BO chain (shared)
        (-17.2, -58.3),                       # BO chain (shared)
        (-16.3, -58.4),                       # BO chain (shared)
        (-15.0, -60.2),                       # the straight (BO shared)
        (-13.5, -61.0),                       # BO chain (shared)
        (-12.5, -63.1),                       # BO chain (shared)
        (-10.81, -65.345),                    # Guajara-Mirim in (shared)
        (-9.9, -65.4),                        # BO chain (shared)
        (-10.0, -66.7),                       # BO chain (shared)
        (-10.62, -68.15),                     # BO chain (shared)
        (-11.018, -68.76),                    # Brasileia in (BO shared)
        (-10.95, -69.57),                     # PE/BO tripoint (shared)
        (-9.8, -70.6),                        # PE chain (shared)
        (-7.1, -73.8),                        # PE chain (shared)
        (-5.5, -72.5),                        # Yavari (PE shared)
        (-4.4, -70.1),                        # Yavari mouth (PE shared)
        (-4.23, -69.94),                      # Tabatinga in, Leticia out
        (-1.4, -69.42),                       # Apaporis line (exact-ish)
        (1.2, -69.85),                        # CO rivers (conserv.)
        (1.9, -67.3),                         # CO line (conserv.)
        (1.22, -66.86),                       # Piedra del Cocuy (VE)
        (2.5, -63.8),                         # VE divide (conserv.)
        (4.0, -62.5),                         # VE divide (conserv.)
        (4.55, -61.13),                       # Pacaraima / Santa Elena
        (5.1, -60.73),                        # Roraima corner (GY)
        (4.0, -59.7),                         # GY line (conserv.)
        (3.37, -59.815),                      # Bonfim / Lethem (Takutu)
        (1.5, -58.5),                         # GY divide (conserv.)
        (1.2, -57.0),                         # GY/SR divide (conserv.)
        (2.0, -56.2),                         # SR divide (conserv.)
        (2.2, -55.0),                         # SR divide (conserv.)
        (2.3, -54.2),                         # GF divide (conserv.)
        (3.0, -52.6),                         # Oyapock (conserv.)
        (3.87, -51.81),                       # Oiapoque / St-Georges
        (4.6, -51.1),                         # Cape Orange offshore
        (2.0, -48.0),                         # Atlantic offshore
        (0.0, -44.0),                         # Atlantic offshore
        (-2.0, -41.0),                        # Atlantic offshore
        (-4.0, -36.0),                        # Atlantic offshore
        (-6.0, -34.3),                        # Recife offshore
        (-9.5, -34.5),                        # Atlantic offshore
        (-13.0, -38.0),                       # Salvador offshore
        (-16.5, -38.3),                       # Abrolhos offshore
        (-21.0, -39.8),                       # Vitoria offshore
        (-23.5, -43.0),                       # Rio offshore
        (-24.6, -45.8),                       # Santos offshore
        (-26.5, -48.0),                       # Florianopolis offshore
        (-29.0, -49.0),                       # Torres offshore
        (-32.0, -51.3),                       # Rio Grande offshore
        (-34.0, -52.8)],                      # Chuy offshore
    # --- Chile: the Concordia line (Arica in, Tacna PE out), the -52
    # parallel and Punta Dungeness drop shared with Argentina's Santa
    # Cruz ring values, and the exact -68.604 Tierra del Fuego
    # meridian (Porvenir CL west, Ushuaia AR east of the Beagle turn);
    # the Andes edge is conservative (inside the divide) with dead
    # strips to the AR rings — lake-district and Patagonia border
    # towns like Futaleufu, Cochrane and Puerto Natales stay in while
    # Bariloche, El Calafate and Trevelin never fall to Chile.
    ("CL", None): [
        (-18.35, -70.42),                     # Concordia at the sea
        (-17.9, -69.8),                       # Concordia line (conserv.)
        (-17.65, -69.47),                     # PE/BO corner (Visviri)
        (-19.0, -68.6),                       # BO divide (conserv.)
        (-20.5, -68.45),                      # BO divide
        (-21.3, -68.15),                      # Ollague reach
        (-22.9, -67.85),                      # San Pedro de Atacama in
        (-24.0, -67.3),                       # AR tripoint region
        (-26.0, -68.6),                       # Andes (conserv.)
        (-28.0, -69.4),                       # Andes
        (-30.0, -70.0),                       # Andes
        (-33.0, -70.0),                       # Andes (Santiago in)
        (-35.0, -70.5),                       # Andes
        (-38.0, -71.0),                       # Andes
        (-40.0, -71.8),                       # lake district (conserv.)
        (-43.2, -71.75),                      # Futaleufu in, Trevelin out
        (-47.0, -72.3),                       # Cochrane in
        (-48.5, -72.5),                       # Villa O'Higgins in
        (-49.4, -73.0),                       # El Chalten AR stays out
        (-50.2, -73.1),                       # ice field west
        (-50.7, -72.75),                      # Torres del Paine in,
        (-51.35, -72.55),                     #   El Calafate AR out
        (-51.7, -72.35),                      # Puerto Natales in
        (-52.0, -71.8),                       # -52 line (AR shared)
        (-52.0, -68.4),                       # -52 line east (AR shared)
        (-52.39, -68.44),                     # Punta Dungeness
        (-52.9, -68.604),                     # TDF meridian (exact)
        (-54.87, -68.604),                    # meridian at the Beagle
        (-54.88, -68.1),                      # Beagle midline (Ushuaia N)
        (-54.91, -67.3),                      # Puerto Williams in
        (-55.1, -66.3),                       # Beagle islands (CL)
        (-56.2, -67.3),                       # Cape Horn
        (-55.8, -70.5),                       # Pacific
        (-52.0, -76.0),                       # Pacific generous
        (-46.0, -76.5),                       # Pacific
        (-33.0, -73.0),                       # Pacific (Valparaiso in)
        (-25.0, -71.5),                       # Pacific
        (-18.6, -71.0)],                      # Pacific north
    # --- Uruguay: the Uruguay River midline splits the twin pairs
    # (Salto/Concordia AR, Paysandu/Colon AR), the Rio de la Plata
    # midline keeps Buenos Aires out, and the Brazil side is
    # conservative (the street-split twins Rivera/Livramento and
    # Chuy/Chui concede to anchors rather than risk claiming Brazil).
    ("UY", None): [
        (-30.2, -57.6),                       # Cuareim / Uruguay corner
        (-31.39, -57.99),                     # Salto in, Concordia out
        (-32.3, -58.12),                      # Paysandu in, Colon out
        (-33.1, -58.40),                      # Fray Bentos reach
        (-33.9, -58.42),                      # river mouth
        (-34.55, -57.8),                      # Plata midline (BA out)
        (-35.1, -56.5),                       # Plata midline
        (-35.3, -55.0),                       # Atlantic
        (-35.0, -53.3),                       # Atlantic
        (-33.70, -53.48),                     # Chuy corner (both street
                                              #   twins concede, conserv.)
        (-33.3, -53.65),                      # west of Laguna Merin
        (-32.65, -53.55),                     # Jaguarao south (conserv.)
        (-32.4, -53.76),                      # BR line (conserv.)
        (-31.9, -54.4),                       # BR line (conserv.)
        (-31.4, -55.0),                       # BR line (conserv.)
        (-31.1, -55.6),                       # Rivera concedes
        (-30.8, -56.0),                       # BR line (conserv.)
        (-30.6, -56.3),                       # Artigas concedes
        (-30.4, -57.0)],                      # Cuareim (conserv.)
    # --- Africa / Oceania COUNTRY-level rings (subdivision None):
    # exact on the famous meridian/parallel treaty lines, conservative
    # or generous-offshore elsewhere; nearest_subdivision (constrained
    # to the ring's country) still provides admin-1 where anchors
    # exist.  Egypt/Sudan uses the de-jure 22N line (the Hala'ib
    # triangle follows the treaty line here, as a boundary dataset
    # would).
    # Egypt: the Gulf of Aqaba edge follows the gulf MIDLINE (round 4f
    # tightened it from a generous line so the Saudi ring can hold the
    # NEOM coast opposite without overlap; Dahab/Sharm stay in).
    ("EG", None): [
        (22.0, 25.0), (32.2, 25.0), (32.2, 29.0), (31.9, 32.0),
        (31.5, 34.22), (31.32, 34.215), (29.49, 34.905),
        (29.0, 34.77), (28.0, 34.62), (27.65, 34.42),
        (27.5, 34.7), (25.0, 35.5), (22.0, 36.89)],
    # Libya: the 25E east edge (Egypt/Sudan) and 15E conservative west
    # edge; the south edge is the 1955-treaty diagonal (Toummo to the
    # Sudan tripoint) so the Tibesti towns resolve to Chad — the
    # round-3 flat-21N box misassigned Bardai/Aouzou (awarded to Chad
    # by the 1994 ICJ ruling) to Libya.  Shared verbatim with Chad.
    ("LY", None): [
        (22.62, 15.0), (33.5, 15.0), (33.5, 25.0),
        (20.0, 25.0), (20.0, 24.0)],
    ("SD", None): [
        (22.0, 25.0), (22.0, 36.89), (19.0, 38.2), (17.5, 37.5),
        (14.5, 36.0), (13.0, 34.0), (13.0, 24.5), (20.0, 24.5),
        (20.0, 25.0)],
    # Namibia/Botswana: 20E south of 22S, 21E north of it, the 22S jog
    # between, and the ~17.39S Angola straight segment — all exact;
    # Orange/Molopo/Limpopo river borders conservative.
    # Chad: the north edge is the shared 1955 line (Libya); the east
    # edge approximates the Sudan border (Adre TD in, El Geneina SD
    # out) with a dead strip to Sudan's conservative 24.5 edge; the
    # CAR edge is conservative; the Cameroon edge carries the
    # Mayo-Kebbi bulge (Fianga/Lere in, Kaele CM out) and the
    # Logone/Chari channels (N'Djamena east bank in, Kousseri CM
    # west); the Niger edge is a shared desert chain (verbatim).
    ("TD", None): [
        (22.62, 15.0), (20.0, 24.0),          # 1955 line (LY shared)
        (16.0, 23.4), (14.2, 22.35),
        (13.47, 22.26),                       # Adre / El Geneina
        (12.5, 22.0), (11.5, 22.55), (10.95, 22.7),
        (10.9, 22.2), (9.9, 21.0), (9.0, 19.5),
        (8.6, 18.5),                          # Sarh stays in
        (8.3, 17.0), (7.9, 16.6), (7.7, 15.5),
        (8.6, 15.1), (9.2, 14.5), (9.55, 13.95),
        (9.8, 14.0), (10.0, 14.6),            # Mayo-Kebbi bulge
        (10.28, 15.34),                       # Bongor (Yagoua CM out)
        (11.3, 15.1), (11.8, 15.05),
        (12.10, 15.034),                      # N'Djamena / Kousseri
        (12.5, 14.9), (12.95, 14.55),         # Chari to Lake Chad
        (13.0, 14.2), (13.8, 13.85),          # lake (NE shared)
        (14.5, 14.0), (15.3, 14.8),           # desert chain (NE shared)
        (18.0, 15.5)],                        # desert chain (NE shared)
    # Niger: the Chad desert chain and the Toummo/1955 corner are
    # shared verbatim; the Algeria edge is the two straight treaty
    # segments (Assamaka in, In Guezzam DZ out); the Mali/Burkina/
    # Benin edges are conservative (the Gaya river elbow concedes the
    # bank towns to anchors); the Nigeria edge rises from the river
    # to the Komadougou Yobe channel (Birnin Konni/Maradi/Diffa in;
    # Illela/Katsina/Nguru/Damasak NG out).
    ("NE", None): [
        (23.4, 12.0),                         # Algeria/Libya corner
        (22.62, 15.0),                        # Toummo line (TD/LY shared)
        (18.0, 15.5), (15.3, 14.8),           # desert chain (TD shared)
        (14.5, 14.0), (13.8, 13.85),          # desert chain (TD shared)
        (13.5, 13.35),                        # Lake Chad (Baga NG out)
        (13.30, 12.61),                       # Komadougou (Diffa in)
        (13.25, 12.0), (13.15, 10.7),
        (13.0, 9.6), (12.97, 8.95),           # Magaria reach
        (13.1, 8.3),                          # Daura NG out
        (13.33, 7.10),                        # Maradi in, Katsina out
        (13.75, 5.28),                        # B. Konni in, Illela out
        (12.6, 4.0), (12.0, 3.35),            # river (conservative)
        (12.25, 2.95), (12.85, 1.95),         # Benin/Burkina conserv.
        (13.6, 0.95),                         # Torodi in, Sebba BF out
        (14.2, 0.35),                         # Tera in, Dori BF out
        (14.93, 0.70),                        # Labbezanga reach
        (15.1, 1.3), (15.6, 4.0),             # Mali conservative
        (19.15, 4.25),                        # Algeria tripoint
        (19.85, 7.0)],                        # Assamaka line corner
    ("NA", None): [
        (-17.25, 11.5), (-17.39, 13.9), (-17.39, 20.6),
        (-18.32, 21.0), (-22.0, 21.0), (-22.0, 20.0),
        (-28.2, 20.0), (-28.45, 17.5), (-28.65, 16.45),
        (-28.8, 13.0)],
    ("BW", None): [
        (-26.6, 20.0), (-22.0, 20.0), (-22.0, 21.0),
        (-18.35, 21.0), (-18.1, 23.4), (-18.4, 24.9),
        (-19.5, 27.0), (-21.5, 27.5), (-24.5, 26.5),
        (-25.5, 25.0), (-26.6, 21.5)],
    # Indonesia/Papua New Guinea: the 141E meridian is exact; the Fly
    # River bulge corridor (140.85-141E, 5.8-7.3S) is ceded to the
    # anchor fallback by both rings; PNG's ring stays north of -9.8 so
    # it can never meet the Queensland ring, and the Louisiades stay
    # anchor-resolved.
    ("ID", None): [
        (-9.5, 133.0), (-0.2, 133.0), (-0.2, 141.0),
        (-5.8, 141.0), (-5.8, 140.85), (-7.3, 140.85),
        (-7.3, 141.0), (-9.5, 141.0)],
    ("PG", None): [
        (-9.8, 141.0), (0.5, 141.0), (0.5, 149.0), (-9.8, 149.0)],
    # --- Maghreb / western Sahara (round 4g).  The classic treaty
    # staircase is exact: the 27.666N line (Morocco / Western Sahara),
    # the -8.667 meridian, the 26N and Tropic-of-Cancer (23.45) steps
    # and the -12/-13 meridians (Western Sahara / Mauritania), the
    # Cap Blanc peninsula midline (La Guera EH west, Nouadhibou MR
    # east), the DZ/MR diagonal to (25.0, -4.806) and Mali's
    # near-vertical northwest line — every shared border one vertex
    # run in both rings.  The Morocco/Algeria chain threads the
    # Oujda/Maghnia and Figuig/Beni Ounif twins; the Senegal-river
    # chain splits Rosso MR / Richard Toll SN; the Algeria/Tunisia
    # and Algeria/Libya edges are conservative (Ghadames/Ghat/Tozeur
    # stay out); the Spanish enclaves (Ceuta, Melilla) and the Canary
    # Islands stay outside Morocco's envelope.
    ("MA", None): [
        (35.09, -2.21),                       # Med corner (DZ shared)
        (34.85, -1.79),                       # Oujda in, Maghnia DZ out
        (34.5, -1.70),                        # DZ chain (shared)
        (33.7, -1.60),                        # DZ chain (shared)
        (32.8, -1.30),                        # DZ chain (shared)
        (32.1, -1.18),                        # Figuig in, Beni Ounif out
        (32.0, -2.1),                         # DZ chain (Bechar out)
        (31.7, -3.0),                         # DZ chain (shared)
        (30.9, -4.3),                         # DZ chain (shared)
        (30.2, -5.5),                         # Draa (conservative)
        (29.5, -6.5),                         # Draa (conservative)
        (28.7, -7.8),                         # DZ chain (shared)
        (27.666, -8.667),                     # WS/DZ corner (exact)
        (27.666, -13.17),                     # 27.666N line (EH shared)
        (27.95, -13.35),                      # Atlantic (Tarfaya in,
        (29.4, -10.9),                        #   Canaries out)
        (30.5, -10.3),                        # Atlantic (Agadir in)
        (31.6, -10.3),                        # Atlantic
        (32.4, -9.8),                         # Atlantic (Safi in)
        (33.6, -8.2),                         # Atlantic (Casablanca in)
        (34.3, -7.2),                         # Atlantic (Rabat in)
        (35.3, -6.3),                         # Atlantic (Tangier in)
        (35.95, -5.95),                       # Cape Spartel
        (35.83, -5.45),                       # Ceuta ES stays out
        (35.82, -5.25),                       # Med (Fnideq concedes)
        (35.5, -4.5),                         # Med (Al Hoceima in)
        (35.25, -3.1),                        # Melilla ES cut west
        (35.22, -2.85),                       # Melilla ES cut east
        (35.45, -2.4)],                       # Med (Nador in)
    ("EH", None): [                           # Western Sahara
        (27.666, -8.667),                     # NE corner (MA/DZ shared)
        (26.0, -8.667),                       # -8.667 line (MR shared)
        (26.0, -12.0),                        # 26N step (MR shared)
        (23.45, -12.0),                       # -12 meridian (MR shared)
        (23.45, -13.0),                       # Tropic of Cancer (shared)
        (21.3394, -13.0),                     # -13 meridian (MR shared)
        (21.3394, -17.005),                   # 21.34 line (MR shared)
        (20.77, -17.055),                     # Cap Blanc tip (MR shared)
        (21.5, -17.6),                        # Atlantic generous
        (24.5, -16.2),                        # Atlantic (Dakhla in)
        (27.0, -14.5),                        # Atlantic
        (27.78, -13.6),                       # Atlantic (Laayoune in,
        (27.666, -13.17)],                    #   Canaries out; MA shared
    ("MR", None): [                           # Mauritania
        (26.0, -8.667),                       # EH staircase (shared)
        (27.666, -8.667),                     # meridian up (EH corner)
        (25.0, -4.806),                       # DZ diagonal (shared)
        (15.6, -5.5),                         # Mali vertical (shared)
        (15.5, -6.5),                         # Hodh arc (ML shared)
        (15.6, -7.3),                         # Nema in, Nara ML out
        (15.5, -8.4),                         # Hodh arc (ML shared)
        (15.31, -9.35),                       # Ayoun in, Nioro ML out
        (14.78, -12.1),                       # ML/SN tripoint (shared)
        (14.77, -12.25),                      # Senegal River (Bakel out)
        (15.67, -13.26),                      # river (Matam SN out)
        (16.135, -13.51),                     # river (Kaedi in)
        (16.60, -14.30),                      # river (Boghe in)
        (16.68, -14.96),                      # river (Podor SN out)
        (16.49, -15.75),                      # Rosso in, R. Toll out
        (16.03, -16.52),                      # river mouth (St-Louis out)
        (18.0, -16.5),                        # Atlantic (Nouakchott in)
        (20.2, -17.1),                        # Atlantic
        (20.77, -17.055),                     # Cap Blanc tip (EH shared)
        (21.3394, -17.005),                   # peninsula midline
        (21.3394, -13.0),                     # staircase (EH shared)
        (23.45, -13.0),                       # Tropic (EH shared)
        (23.45, -12.0),                       # staircase (EH shared)
        (26.0, -12.0)],                       # 26N step (EH shared)
    ("ML", None): [                           # Mali
        (25.0, -4.806),                       # DZ/MR tripoint (shared)
        (21.35, 0.90),                        # DZ line (Tessalit in,
        (20.1, 3.2),                          #   B.B. Mokhtar DZ out)
        (19.15, 4.25),                        # NE tripoint (shared)
        (15.6, 4.0),                          # Niger chain (NE shared)
        (15.1, 1.3),                          # Niger chain (NE shared)
        (14.93, 0.70),                        # Labbezanga (NE shared)
        (14.2, 0.35),                         # Burkina chain (NE shared)
        (13.9, -0.4),                         # Burkina (conservative)
        (14.4, -2.5),                         # Dogon line (Koro reach)
        (13.9, -3.4),                         # BF line (Ouahigouya out)
        (13.1, -4.35),                        # BF line (San in)
        (12.0, -4.45),                        # BF line (Bobo out)
        (11.1, -5.5),                         # Sikasso in
        (10.75, -6.0),                        # CI line (Tengrela out)
        (10.65, -6.6),                        # CI line (conservative)
        (10.2, -7.6),                         # CI/GN corner
        (10.9, -8.2),                         # Guinea (Yanfolila in)
        (11.3, -8.7),                         # Guinea (Kangaba in)
        (12.1, -9.4),                         # Guinea (Siguiri GN out)
        (12.4, -10.6),                        # Guinea (conservative)
        (12.7, -11.3),                        # Guinea/Senegal
        (13.5, -11.75),                       # Faleme (Kidira SN out)
        (14.78, -12.1),                       # MR/SN tripoint (shared)
        (15.31, -9.35),                       # Hodh arc (MR shared)
        (15.5, -8.4),                         # Hodh arc (MR shared)
        (15.6, -7.3),                         # Hodh arc (MR shared)
        (15.5, -6.5),                         # Hodh arc (MR shared)
        (15.6, -5.5)],                        # vertical line (MR shared)
    ("DZ", None): [                           # Algeria
        (35.09, -2.21),                       # Med corner (MA shared)
        (36.3, -1.5),                         # Med (Oran in)
        (36.9, 1.0),                          # Med generous
        (37.3, 4.0),                          # Med generous
        (37.5, 7.0),                          # Med (Annaba in)
        (36.95, 8.55),                        # TN corner (Tabarka out)
        (36.5, 8.2),                          # TN line (El Kala in)
        (35.2, 8.1),                          # TN line (conservative)
        (33.9, 7.75),                         # Nefta/Tozeur TN out
        (32.2, 8.9),                          # TN south (conservative)
        (30.1, 9.45),                         # LY line (Ghadames out)
        (28.0, 9.75),                         # LY line (In Amenas in)
        (26.5, 9.8),                          # LY line (conservative)
        (25.0, 9.95),                         # LY line (Ghat LY out)
        (24.2, 10.8),                         # LY line
        (23.4, 12.0),                         # NE tripoint (shared)
        (19.85, 7.0),                         # Niger line (NE shared)
        (19.15, 4.25),                        # Niger line (NE shared)
        (20.1, 3.2),                          # Mali line (ML shared)
        (21.35, 0.90),                        # Mali line (ML shared)
        (25.0, -4.806),                       # MR tripoint (shared)
        (27.666, -8.667),                     # WS corner (exact, shared)
        (28.7, -7.8),                         # Morocco chain (shared)
        (29.5, -6.5),                         # Morocco chain (shared)
        (30.2, -5.5),                         # Morocco chain (shared)
        (30.9, -4.3),                         # Morocco chain (shared)
        (31.7, -3.0),                         # Morocco chain (shared)
        (32.0, -2.1),                         # Bechar in (MA shared)
        (32.1, -1.18),                        # Beni Ounif in (shared)
        (32.8, -1.30),                        # Morocco chain (shared)
        (33.7, -1.60),                        # Morocco chain (shared)
        (34.5, -1.70),                        # Morocco chain (shared)
        (34.85, -1.79)],                      # Maghnia in (MA shared)
    # --- Middle East desert treaty lines (round 4f).  The JO/SA
    # zigzag (Winston's hiccup — the 1925/1965 straight lines, with
    # the Saudi salient at (31.33, 36.98) keeping Qurayyat SA out of
    # Jordan), the JO/IQ and IQ/SA straight lines and the Kuwait
    # lines are each ONE shared vertex run spliced into both rings;
    # the Syria/Iran/Turkey/Yemen/Oman/UAE/Qatar edges are
    # conservative or midline chains (no rings on those sides).
    ("JO", None): [
        (29.36, 34.96),                       # Gulf of Aqaba (SA shared)
        (29.53, 34.975),                      # Aqaba in, Eilat IL out
        (30.5, 35.15),                        # Arava valley
        (31.3, 35.47),                        # Dead Sea midline
        (31.75, 35.54),                       # Dead Sea north
        (32.0, 35.555),                       # Jordan River east bank
        (32.35, 35.565),                      #   (the West Bank valley
                                              #   floor stays west)
        (32.62, 35.565),                      # Yarmouk confluence
        (32.68, 35.75),                       # Yarmouk (Golan edge out)
        (32.72, 35.90),                       # Yarmouk upper
        (32.59, 36.02),                       # Ramtha in, Deraa SY out
        (32.52, 36.84),                       # Syria line (conserv.)
        (32.75, 38.0),                        # Syria line
        (33.38, 38.79),                       # SY/IQ tripoint (IQ shared)
        (32.15, 39.19),                       # JO/IQ/SA tripoint (shared)
        (31.33, 36.98),                       # hiccup apex (SA shared)
        (30.5, 37.67),                        # SA line (shared)
        (29.3, 36.07)],                       # SA line (shared)
    ("IQ", None): [
        (33.38, 38.79),                       # JO/SY tripoint (JO shared)
        (34.42, 41.0),                        # Al-Qaim in, Albu Kamal out
        (35.2, 41.25),                        # Syria line (conserv.)
        (36.62, 41.6),                        # Sinjar in, Hasakah SY out
        *_TR_IQ,                              # Turkey chain (shared
        (36.8, 45.05),                        #   VERBATIM); Piranshahr out
        (36.2, 45.3),                         # Iran chain (conserv.)
        (35.7, 46.15),                        # Penjwin reach
        (35.2, 46.1),                         # Halabja in, Marivan out
        (34.4, 45.45),                        # Khanaqin in, Qasr-e-S. out
        (33.3, 45.95),                        # Badra reach
        (32.9, 46.3),                         # Iran chain
        (32.0, 47.38),                        # Iran chain
        (31.0, 47.68),                        # Iran chain
        (30.45, 48.02),                       # Shatt al-Arab head
        (30.42, 48.14),                       # Khorramshahr IR out
        (30.3, 48.23),                        # Abadan IR out, Basra in
        (29.85, 48.6),                        # Shatt mouth
        (29.97, 48.33),                       # Faw peninsula south
        (30.02, 48.06),                       # Khawr Abd Allah (UQ in)
        (30.12, 47.7),                        # north of Safwan line
        (30.1, 46.55),                        # Kuwait west meridian
        (29.1, 46.55),                        # IQ/KW/SA tripoint (shared)
        (29.9, 44.7),                         # SA line (shared)
        (30.8, 42.1),                         # SA line (shared)
        (31.5, 41.0),                         # Arar SA out (shared)
        (32.15, 39.19)],                      # JO tripoint (shared)
    ("SA", None): [
        (29.36, 34.96),                       # JO corner (shared)
        (29.3, 36.07),                        # JO line (shared)
        (30.5, 37.67),                        # JO line (shared)
        (31.33, 36.98),                       # hiccup apex (shared)
        (32.15, 39.19),                       # JO/IQ tripoint (shared)
        (31.5, 41.0),                         # IQ line (shared)
        (30.8, 42.1),                         # IQ line (shared)
        (29.9, 44.7),                         # IQ line (shared)
        (29.1, 46.55),                        # IQ/KW tripoint (shared)
        (28.54, 47.45),                       # KW south (shared)
        (28.54, 48.42),                       # KW coast corner (shared)
        (28.8, 48.9),                         # Gulf (Khafji in)
        (27.5, 49.95),                        # Gulf (Jubail in)
        (26.9, 50.25),                        # Gulf
        (26.45, 50.33),                       # Dammam/Khobar in
        (25.8, 50.45),                        # Bahrain out
        (24.62, 50.72),                       # Gulf of Salwa (Qatar out)
        (24.55, 51.35),                       # Khawr al Udayd
        (24.2, 51.58),                        # UAE line north
        (22.63, 51.58),                       # UAE line (exact-class)
        (22.63, 55.2),                        # UAE/Oman corner
        (19.0, 52.0),                         # Oman 1990 line corner
        (17.4, 47.5),                         # Yemen line (conserv.)
        (17.05, 46.3),                        # Yemen line
        (17.25, 45.3),                        # Yemen line
        (17.35, 44.3),                        # Najran in, Saada YE out
        (16.95, 43.15),                       # Yemen west
        (16.37, 42.77),                       # Red Sea terminus
        (16.5, 42.0),                         # Red Sea generous
        (18.0, 40.5),                         # Red Sea
        (20.5, 38.3),                         # Red Sea
        (23.5, 37.3),                         # Red Sea
        (25.5, 36.3),                         # Red Sea
        (26.8, 35.4),                         # Red Sea north
        (27.7, 34.62),                        # Gulf of Aqaba mouth
        (27.9, 34.70),                        # gulf midline (EG east)
        (29.2, 34.88),                        # gulf midline (Haql in)
        (29.38, 34.95)],                      # gulf head
    ("KW", None): [
        (29.1, 46.55),                        # IQ/SA tripoint (shared)
        (30.1, 46.55),                        # west meridian (IQ shared)
        (29.95, 47.72),                       # north line (Safwan out)
        (29.90, 48.10),                       # Bubiyan west
        (29.70, 48.42),                       # Bubiyan in (dead strip N)
        (29.4, 48.6),                         # Gulf (Failaka in)
        (28.75, 48.7),                        # Gulf generous
        (28.54, 48.42),                       # SA corner (shared)
        (28.54, 47.45)],                      # SA line (shared)
    # Qatar / Bahrain: small-Gulf envelopes with water gaps to the
    # Saudi ring's coast edge (no shared vertices needed over open
    # water); Bahrain's Hawar islets concede to anchors.
    ("QA", None): [
        (26.20, 50.72), (26.20, 51.70),
        (24.65, 51.70), (24.65, 51.33),
        (24.72, 50.78)],
    ("BH", None): [
        (26.32, 50.42), (26.32, 50.70),
        (25.75, 50.70), (25.75, 50.50)],
    # --- United Kingdom (Great Britain island + Hebrides/Orkney/
    # Shetland/Scilly/Wight): the envelope threads the Dover Strait
    # and Channel midlines (Calais/Boulogne/Cherbourg FR out), stays
    # north of the Channel Islands (crown dependencies, not GB),
    # excludes the Isle of Man (also a crown dependency) through the
    # gap between Anglesey and the Galloway coast, and runs the Irish
    # Sea / North Channel midline (Dublin and the NI coast concede to
    # anchors — Northern Ireland is GB-by-anchor, outside this ring).
    ("GB", None): [
        (49.7, -6.6),                         # Scilly southwest
        (50.3, -6.6),                         # Celtic Sea
        (50.9, -6.3),                         # Celtic Sea north
        (51.9, -5.83),                        # Irish Sea midline (St
                                              #   David's in, Rosslare out)
        (53.1, -5.15),                        # midline (Holyhead in,
                                              #   Dublin out)
        (53.8, -4.55),                        # Anglesey / Man gap
        (54.1, -4.15),                        # east of the Isle of Man
        (54.45, -4.1),                        # Man excluded north
        (54.52, -4.45),                       # Galloway channel
        (54.55, -4.9),                        # Mull of Galloway south
        (54.75, -5.33),                       # North Channel midline
        (55.2, -6.1),                         # midline (Rathlin NI out)
        (55.5, -6.35),                        # Islay in
        (56.5, -7.8),                         # Hebrides offshore
        (57.9, -8.9),                         # St Kilda in
        (59.0, -7.0),                         # north Atlantic
        (60.0, -2.5),                         # Orkney/Fair Isle
        (61.0, -1.5),                         # Shetland north
        (61.0, -0.5),                         # Shetland east
        (58.0, -0.3),                         # North Sea (generous)
        (56.0, 1.5),                          # North Sea
        (52.5, 2.2),                          # East Anglia offshore
        (51.3, 1.9),                          # strait approach
        (51.04, 1.58),                        # Dover Strait midline
        (50.7, 1.3),                          # strait (Boulogne out)
        (50.3, 0.0),                          # Channel midline
        (49.9, -1.5),                         # midline (Cherbourg out)
        (49.82, -2.1),                        # Channel Is. stay out
        (49.80, -2.6),                        #   (open water; room
        (49.8, -4.0),                         #   for the GG box)
        (49.7, -5.7)],                        # Lizard offshore
    # --- Ireland (the Republic): the Atlantic/Celtic sides are
    # generous; the Northern Ireland land border is CONSERVATIVE
    # (the meander around Fermanagh/Monaghan is cut inside, so a few
    # border villages concede to anchors) but wraps Donegal and
    # Inishowen around NI's west with the Foyle/Lough Foyle midline
    # (Buncrana/Greencastle IE in, Derry/Magilligan NI out); the
    # Irish Sea edge leaves a water gap to the GB ring.
    ("IE", None): [
        (54.05, -6.2),                        # Carlingford (Dundalk in,
                                              #   Newry NI out)
        (54.1, -7.0),                         # Monaghan line (conserv.)
        (54.28, -7.85),                       # Fermanagh cut
        (54.33, -8.0),                        # Belleek reach
        (54.52, -8.18),                       # Bundoran in
        (54.65, -7.9),                        # Pettigo reach
        (55.02, -7.40),                       # Bridgend (Derry NI out)
        (55.12, -7.14),                       # Lough Foyle midline
        (55.28, -6.90),                       # Greencastle in
        (55.50, -7.3),                        # Malin Head offshore
        (55.45, -8.5),                        # Tory Island in
        (55.0, -9.2),                         # Atlantic
        (54.2, -10.6),                        # Achill offshore
        (53.0, -10.8),                        # Aran offshore
        (51.4, -10.6),                        # Skelligs offshore
        (51.2, -9.0),                         # Celtic Sea
        (51.5, -7.5),                         # Celtic Sea
        (51.9, -6.1),                         # Carnsore offshore
        (52.3, -5.95),                        # Irish Sea (GB gap)
        (53.2, -5.7),                         # Irish Sea (Dublin in)
        (53.8, -5.5),                         # Irish Sea north
        (54.03, -5.9)],                       # Carlingford approach
    # --- Island nations (round 4f): countries whose territory is
    # wholly surrounded by water get exact country assignment from a
    # generous ocean envelope — over-extension cannot misassign
    # because no foreign soil competes, while the envelope edges
    # thread the handful of narrow straits where it does (Palk
    # Strait, the Florida/Yucatan/Windward passages, the Comoros
    # gap).  Admin-1 inside each ring resolves through the
    # country-constrained anchor path (_ring_subdivision).
    ("IS", None): [                           # Iceland
        (67.0, -25.0), (67.0, -13.2), (63.0, -13.2), (63.0, -25.0)],
    ("NZ", None): [                           # New Zealand (Chathams
        (-34.0, 165.5), (-34.0, 179.2),       #   beyond 180 fall to
        (-48.3, 179.2), (-48.3, 165.5)],      #   anchors)
    ("TW", None): [                           # Taiwan incl. Penghu;
        (21.7, 119.3), (24.2, 119.3),         #   Kinmen/Matsu by the
        (25.4, 121.0), (25.5, 122.1),         #   mainland coast fall
        (21.8, 122.1)],                       #   to anchors
    ("LK", None): [                           # Sri Lanka (Delft in,
        (9.4, 79.55), (10.0, 79.8),           #   Dhanushkodi/
        (10.0, 81.0), (8.0, 82.2),            #   Rameswaram IN out)
        (5.6, 81.9), (5.6, 79.8)],
    ("MG", None): [                           # Madagascar (Mayotte and
        (-11.8, 48.6), (-11.8, 50.5),         #   the Comoros stay out
        (-15.0, 51.0), (-25.0, 48.5),         #   of the northwest gap)
        (-26.2, 45.5), (-23.5, 42.8),
        (-19.5, 43.5), (-16.0, 44.0),
        (-13.5, 47.0)],
    ("CU", None): [                           # Cuba (Key West, the
        (23.5, -85.3), (23.5, -80.5),         #   Bahamas, Inagua,
        (22.3, -77.5), (21.2, -75.5),         #   Haiti, the Caymans
        (20.7, -73.95), (19.6, -74.7),        #   and Cancun all
        (19.6, -78.2), (20.8, -84.2),         #   threaded out)
        (21.3, -85.3)],
    ("JM", None): [                           # Jamaica
        (18.75, -78.6), (18.75, -75.95),
        (17.5, -75.95), (17.5, -78.6)],
    # --- Japan: the envelope threads every contested strait — La
    # Perouse (Wakkanai in, Sakhalin out), the Nemuro Strait (the
    # Shiretoko and Nemuro peninsulas in; Kunashir and the Habomais,
    # Russian-administered, out), the Korea Strait midline (Tsushima
    # in, Busan/Geoje out) and the Yonaguni gap to the Taiwan ring
    # (a dead strip over water between 122.1 and ~122.55).  The
    # Ogasawara dip reaches Iwo To; Ulleungdo/Dokdo and the Senkakus
    # are deliberately left to the anchor fallback.
    ("JP", None): [
        (45.65, 141.0),                       # La Perouse midline W
        (45.65, 142.2),                       # La Perouse midline E
        (44.6, 145.2),                        # Shiretoko offshore
        (44.5, 145.4),                        # Nemuro Strait midline
        (44.0, 145.5),                        # strait (Kunashir east)
        (43.7, 145.55),                       # strait south
        (43.42, 145.85),                      # Goyomai channel
        (43.25, 146.0),                       # Habomais out
        (42.5, 147.5),                        # Pacific offshore
        (38.0, 144.0),                        # Pacific offshore
        (33.0, 141.5),                        # Pacific offshore
        (28.5, 143.5),                        # Ogasawara east
        (24.5, 141.8),                        # Iwo To southeast
        (24.5, 140.8),                        # Iwo To southwest
        (27.5, 139.8),                        # Ogasawara west
        (28.0, 133.0),                        # Philippine Sea
        (25.6, 131.5),                        # Daito southeast
        (25.5, 128.5),                        # Okinawa southeast
        (23.8, 124.5),                        # Yaeyama south
        (23.9, 122.7),                        # Yonaguni south
        (24.2, 122.55),                       # Yonaguni west (TW gap)
        (24.8, 122.8),                        # East China Sea
        (26.0, 125.3),                        # ECS (Okinawa west)
        (28.5, 127.0),                        # ECS (Amami west)
        (31.0, 127.8),                        # ECS
        (33.0, 128.25),                       # Goto west
        (34.55, 128.7),                       # Korea Strait midline
        (34.9, 129.25),                       # Tsushima / Busan split
        (36.5, 131.8),                        # Sea of Japan (Oki in)
        (40.5, 135.5),                        # Sea of Japan midline
        (43.0, 138.5),                        # Sea of Japan NE
    ],
    # --- South Korea: the DMZ chain is CONSERVATIVE (the ring stays
    # ~3-8 km south of the military demarcation line, leaving a dead
    # strip to the anchor fallback — whose nearest anchor is Seoul,
    # so DMZ-adjacent towns still resolve KR); the east-sea bump
    # encloses Ulleungdo; the Korea Strait side stays west/north of
    # Japan's midline (Busan/Geoje in, Tsushima out); Jeju is
    # enclosed by the southwest lobe.  Baengnyeongdo and the other
    # far-northwest islands fall to anchors.
    ("KR", None): [
        (37.6, 124.9),                        # Yellow Sea northwest
        (37.75, 126.15),                      # Han estuary (conserv.)
        (37.8, 126.90),                       # DMZ chain (Kaesong out)
        (38.0, 127.5),                        # DMZ chain
        (38.25, 128.1),                       # DMZ chain
        (38.45, 128.37),                      # DMZ at the east coast
        (38.45, 129.0),                       # East Sea
        (37.9, 131.1),                        # Ulleungdo bump north
        (37.2, 131.2),                        # Ulleungdo bump east
        (36.8, 130.0),                        # East Sea midline
        (35.3, 129.6),                        # Ulsan offshore
        (35.0, 129.35),                       # Busan (Tsushima out)
        (34.6, 128.65),                       # Geoje south
        (34.15, 127.5),                       # south coast offshore
        (33.0, 126.95),                       # Jeju southeast
        (33.0, 126.0),                        # Jeju southwest
        (33.9, 125.7),                        # Yellow Sea south
        (34.6, 125.3),                        # Heuksando west
        (36.5, 125.7),                        # Yellow Sea midline
        (37.2, 125.9),                        # Yellow Sea (Deokjeok in)
    ],
    # --- France (round 4i): Atlantic/Channel envelope threading the
    # crown-dependency Channel Islands out (Jersey/Guernsey/Alderney
    # west of the Cotentin edge) and staying southeast of the GB
    # ring's Dover midline; the FR/BE, FR/LU, FR/DE (Rhine), FR/CH
    # (Jura + Lake Geneva midline + the Geneva canton wrap) and FR/IT
    # (Alpine crest, 1947 line) shared chains; the Med coast with a
    # Monaco notch (Europe/Monaco anchors it); the Pyrenees chains
    # with the Andorra pocket closed on the north by _AD_NORTH.
    # Llivia is a HOLE (the matching ("ES","Catalonia") square claims
    # it).  Corsica is its own admin-1 ring (Bonifacio midline).
    ("FR", None): [
        (43.60, -2.00),                       # Biscay offshore
        (44.50, -1.65),
        (45.50, -1.60),
        (46.20, -1.80),                       # Oleron/Re in
        (46.70, -2.55),                       # Yeu in
        (47.00, -3.40),                       # Belle-Ile in
        (47.60, -4.60),
        (47.90, -5.20),
        (48.50, -5.45),                       # Ouessant in
        (48.85, -4.80),
        (49.10, -3.60),
        (48.90, -2.70),                       # St-Malo gulf (Channel
        (48.85, -2.20),                       #   Islands stay out)
        (48.95, -1.95),
        (49.35, -1.95),                       # Cotentin west (Jersey W)
        (49.78, -2.02),                       # La Hague (Alderney W)
        (49.85, -1.40),
        (49.80, -0.70),
        (49.90, 0.00),                        # Le Havre offshore
        (50.30, 1.20),
        (50.55, 1.30),                        # GB midline stays NW
        (50.90, 1.52),                        # Boulogne in
        (51.05, 1.88),                        # Calais in
        (51.15, 2.45),                        # Dunkirk in
        *_FR_BE,
        *_FR_LU[1:],
        *_FR_DE[1:],
        *_FR_CH[1:],
        *_FR_IT[1:],
        (43.74, 7.49),                        # Cap Martin offshore
        (43.715, 7.41),                       # (Monaco is a HOLE,
        (43.70, 7.36),                        #   claimed back by the
        (43.63, 7.33),                        #   ("MC",None) ring)
        (43.52, 7.17),                        # Antibes offshore
        (43.40, 7.05),
        (43.10, 6.70),                        # St-Tropez offshore
        (42.90, 6.00),                        # Toulon offshore
        (42.90, 5.00),
        (43.20, 4.30),                        # Camargue offshore
        (43.10, 3.50),
        (42.70, 3.30),
        (42.47, 3.25),
        *_PYRENEES_E[::-1][1:],               # coast -> east tripoint
        *_AD_NORTH[::-1][1:],                 # north Andorra skirt
        *_PYRENEES_W[::-1][1:],               # west tripoint -> Bidasoa
    ],
    ("FR", "Corsica"): [
        (43.10, 8.45), (43.10, 9.65),         # Bonifacio midline south
        (41.30, 9.35), (41.30, 8.55)],        #   (Sardinia 41.26 out)
    # --- Italy (round 4i): the Adriatic midline (Istria/Dalmatia HR
    # and SI east), the Otranto/Sicily-channel/Malta midlines, a west
    # bulge wrapping Sardinia (Bonifacio midline shared value with the
    # Corsica box edge), the Ligurian approach to the Menton coast
    # point, and the _FR_IT/_CH_IT/_AT_IT/_IT_SI chains.  San Marino
    # and the Vatican are HOLES (their zone1970 anchors resolve them);
    # Campione d'Italia gets a matching ("IT","Lombardy") square
    # inside a CH hole.  Lampedusa/Linosa ride their own Sicily box.
    ("IT", None): [
        *_FR_IT[::-1],                        # Menton -> Mont Dolent
        *_CH_IT[1:],                          # -> Piz Lad
        *_AT_IT[1:],                          # -> AT/IT/SI tripoint
        *_IT_SI[1:],                          # -> the Adriatic coast
        (45.555, 13.58),                      # Gulf of Trieste midline
        (45.50, 13.45),                       #   (Piran SI east)
        (44.95, 13.15),
        (44.80, 13.10),                       # Adriatic midline
        (43.94, 14.03),
        (43.60, 14.40),
        (42.50, 16.00),
        (41.90, 17.20),
        (40.50, 18.90),                       # Otranto strait midline
        (39.80, 18.60),
        (39.50, 17.60),                       # Gulf of Taranto
        (38.80, 17.40),
        (37.70, 16.20),
        (36.55, 15.35),                       # Sicily southeast
        (36.30, 14.90),
        (36.30, 14.30),                       # Malta midline (MT south)
        (36.55, 11.75),                       # Pantelleria in
        (37.35, 11.55),                       # Sicily channel (Cap Bon
        (37.90, 11.70),                       #   TN southwest)
        (38.90, 13.10),                       # Ustica in
        (38.70, 11.00),                       # toward Sardinia
        (38.55, 9.70),                        # Cagliari offshore
        (38.55, 8.25),                        # Sant'Antioco in
        (39.50, 7.95),
        (40.80, 7.95),
        (41.10, 8.15),                        # Asinara in
        (41.295, 8.55),                       # Bonifacio midline (the
        (41.295, 9.35),                       #   Corsica box is 41.30)
        (41.10, 9.70),                        # La Maddalena in
        (40.90, 9.90),
        (40.40, 10.30),
        (40.50, 12.20),                       # Tyrrhenian (Ponza in)
        (41.35, 12.00),
        (42.20, 11.40),
        (42.45, 10.70),                       # Giglio in
        (42.60, 9.98),                        # Elba in (Corsica box E)
        (43.08, 9.75),                        # Capraia in
        (43.60, 9.60),                        # Gorgona in
        (43.70, 8.60),                        # Ligurian offshore
        (43.75, 7.90),
        (43.76, 7.65),                        # Menton approach
    ],
    ("IT", "Sicily"): [                       # Pelagie box (Lampedusa/
        (36.00, 12.20), (36.00, 13.20),       #   Linosa; TN coast far
        (35.30, 13.20), (35.30, 12.20)],      #   west, Malta northeast)
    ("IT", "Lombardy"): [                     # Campione d'Italia (the
        (45.975, 8.955), (45.975, 8.99),      #   enclave in Ticino; CH
        (45.952, 8.99), (45.952, 8.955)],     #   cuts a matching hole)
    ("MT", None): [                           # Malta
        (36.10, 14.10), (36.10, 14.60),
        (35.78, 14.60), (35.78, 14.10)],
    # Micro-states: tzdata merged their zones into the neighbours'
    # rows (FR,MC Europe/Paris; IT,SM,VA Europe/Rome; CH,DE,LI
    # Europe/Zurich), so no anchor resolves them — each needs its own
    # ring inside the host's HOLE (the Llivia pattern).  The timezone
    # stays the neighbour's zone, which IS their canonical tzdb zone.
    ("MC", None): [                           # Monaco (= the FR hole)
        (43.7555, 7.4395), (43.7415, 7.4252),
        (43.7325, 7.4128), (43.7258, 7.4082),
        (43.7165, 7.4060), (43.7215, 7.4230),
        (43.7345, 7.4395), (43.7475, 7.4485)],
    ("SM", None): [                           # San Marino (= IT hole)
        (43.995, 12.39), (43.995, 12.525),
        (43.885, 12.525), (43.885, 12.39)],
    ("VA", None): [                           # Vatican City (= IT hole)
        (41.909, 12.444), (41.909, 12.461),
        (41.898, 12.461), (41.898, 12.444)],
    ("LI", None): [                           # Liechtenstein: the west
        *_LI_WEST,                            #   + south run is the CH
        (47.263, 9.560),                      #   skirt VERBATIM (no
        (47.22, 9.595),                       #   dead strip on the
        (47.16, 9.625),                       #   Rhine); the AT side is
        (47.063, 9.62)],                      #   conservative
    ("DE", "Baden-Württemberg"): [            # Buesingen am Hochrhein
        (47.712, 8.672), (47.712, 8.728),     #   (the DE enclave on
        (47.692, 8.728), (47.692, 8.672)],    #   the CH north bank)
    # --- Germany (round 4j): the FR/CH/AT/CZ/PL shared chains, the
    # 1920 Danish line with the Lister Dyb threaded (Sylt in, Roemoe
    # out), the North Sea envelope (Borkum/Helgoland in; the Ems
    # estuary midline), the DE/NL land chain (the Winterswijk and
    # Venlo NL salients, the Selfkant DE salient), and the DE/BE/LU
    # chains down to Schengen.
    ("DE", None): [
        *_FR_DE,                              # Schengen -> Basel
        *_CH_DE[::-1],                        # Basel -> the lake mouth
        *_DE_AT[1:],                          # -> DE/AT/CZ tripoint
        *_DE_CZ[1:],                          # -> DE/CZ/PL tripoint
        *_DE_PL[1:],                          # -> the Pomeranian Bight
        *_DE_DK[::-1],                        # -> the North Sea
        (55.10, 7.60),                        # North Sea envelope
        (54.50, 7.20),                        # (Helgoland in)
        (53.90, 6.55),
        (53.58, 6.62),                        # Borkum in / Rottumeroog
                                              #   NL out
        *_DE_NL,                              # the Ems -> Vaals
        *_DE_BE[1:],                          # -> the Ouren tripoint
        *_DE_LU[1:-1],                        # -> the Moselle (closes
    ],                                        #   at Schengen, _FR_DE[0])
    # --- Austria (round 4j): the DE/CH/LI/IT shared chains; the AT/SI
    # Karawanks and Mura edges conservative; the AT/HU line with the
    # Sopron salient wrapped (Sopron HU anchors to Budapest); the
    # March/Morava midline with Bratislava east; the AT/CZ line with
    # the Gmuend / Ceske Velenice split threaded.
    ("AT", None): [
        *_DE_AT[::-1],                        # tripoint -> the lake
        *_CH_AT_RHINE[::-1][1:],              # the Alpenrhein (CH side)
        (47.266, 9.572),                      # AT/LI east skirt
        (47.225, 9.605),                      #   (conservative ~1 km
        (47.16, 9.638),                       #   strip to the LI ring;
        (47.065, 9.632),                      #   Feldkirch AT stays in)
        (47.049, 9.62),
        *_CH_AT[::-1][1:],                    # -> Piz Lad
        *_AT_IT[1:],                          # -> AT/IT/SI tripoint
        (46.48, 13.90),                       # AT/SI: the Karawanks
        (46.44, 14.15),                       #   (conservative)
        (46.43, 14.55),
        (46.41, 14.82),
        (46.47, 15.05),
        (46.60, 15.40),                       # Maribor SI south
        (46.68, 15.65),
        (46.68, 15.99),                       # Bad Radkersburg reach
        (46.72, 16.05),
        *_AT_HU,                              # the Sopron wrap etc.
        *_AT_SK[1:],                          # the March midline
        (48.78, 16.72),                       # AT/CZ line (Mikulov CZ
        (48.80, 16.45),                       #   north)
        (48.77, 16.10),
        (48.85, 15.85),
        (48.84, 15.55),
        (48.95, 15.25),
        (48.90, 15.00),
        (48.87, 14.99),
        (48.77, 14.965),                      # Gmuend AT / Ceske
        (48.70, 14.95),                       #   Velenice CZ (split)
        (48.62, 14.70),
        (48.60, 14.40),
        (48.58, 14.05),
        (48.63, 13.95),                       # closes at the tripoint
    ],
    # --- Czechia (round 4j): entirely shared chains + the CZ/SK
    # conservative crest (the White Carpathians).
    ("CZ", None): [
        *_DE_CZ,                              # DE/AT -> DE/PL tripoint
        *_CZ_PL[1:],                          # -> CZ/SK/PL (Hrcava)
        *_CZ_SK[::-1][1:],                    # the CZ/SK crest
        (48.78, 16.72),                       # the AT/CZ chain shared
        (48.80, 16.45),                       #   with the AT ring
        (48.77, 16.10),                       #   (reversed verbatim)
        (48.85, 15.85),
        (48.84, 15.55),
        (48.95, 15.25),
        (48.90, 15.00),
        (48.87, 14.99),
        (48.77, 14.965),                      # Ceske Velenice CZ /
        (48.70, 14.95),                       #   Gmuend AT
        (48.62, 14.70),
        (48.60, 14.40),
        (48.58, 14.05),
        (48.63, 13.95),                       # closes at the tripoint
    ],
    # --- Poland (round 4j): the Oder/Neisse chain, the Baltic
    # envelope south of the Bornholm lobe, the 1945 Kaliningrad line,
    # conservative LT/BY/UA edges with the Bug midline (Terespol PL /
    # Brest BY split), the PL/SK Carpathian crest, and the CZ chain.
    ("PL", None): [
        *_DE_PL,                              # tripoint -> the Baltic
        (54.50, 15.40),                       # Baltic envelope
        (54.60, 16.20),                       #   (Bornholm DK north)
        (54.85, 17.00),
        (54.90, 18.00),
        (54.75, 18.90),                       # Gdansk bay (Hel in)
        (54.60, 19.40),
        (54.457, 19.645),                     # Vistula Spit crossing
        (54.36, 19.80),                       # the 1945 line (RU north)
        (54.33, 20.00),
        (54.34, 21.00),
        (54.37, 22.00),
        (54.36, 22.79),                       # PL/LT/RU tripoint
        (54.25, 23.05),                       # PL/LT (conservative)
        (54.15, 23.35),
        (53.96, 23.51),                       # PL/BY/LT tripoint
        (53.60, 23.60),                       # PL/BY (conservative)
        (53.20, 23.85),
        (52.70, 23.93),                       # Bialowieza east
        (52.28, 23.50),
        (52.09, 23.66),                       # Terespol PL / Brest BY
        (51.90, 23.60),                       #   (the Bug midline)
        (51.55, 23.62),                       # Wlodawa east
        (51.20, 23.85),
        (50.85, 24.15),                       # PL/UA (conservative)
        (50.70, 24.10),
        (50.40, 23.95),
        (50.30, 23.60),
        (49.95, 22.95),
        (49.80, 22.85),                       # Przemysl PL west
        (49.50, 22.70),
        *_PL_SK[::-1],                        # the Carpathian crest
        *_CZ_PL[::-1],                        # Hrcava -> the tripoint
    ],
    # --- Denmark (round 4j): the 1920 line + strait midlines shared
    # with Germany; the Oeresund midline threading Ven SE out and
    # Saltholm DK in (Copenhagen/Malmoe split); the Kattegat and
    # Skagerrak midlines; a Bornholm lobe clear of the PL envelope.
    ("DK", None): [
        *_DE_DK,                              # North Sea -> the Baltic
        (54.90, 14.60),                       # Bornholm lobe south
        (54.92, 15.40),
        (55.37, 15.33),                       # Bornholm lobe north
        (55.35, 14.20),
        (55.30, 13.50),                       # (Trelleborg SE north)
        (55.24, 12.95),
        *_DK_SE,                              # the Oeresund + Kattegat
        (58.15, 10.45),                       # Skagerrak midline
        (58.00, 9.00),                        #   (Norway north)
        (57.50, 8.00),
        (56.50, 7.80),                        # North Sea envelope
        (55.50, 7.90),
    ],
    # --- Benelux (round 4k): every land border is an existing shared
    # chain (_DE_NL/_DE_BE/_DE_LU, _FR_BE/_FR_LU, _NL_BE, _BE_LU).
    ("NL", None): [
        (53.58, 6.62),                        # Ems mouth (DE shared)
        *_DE_NL,                              # -> Vaals
        *_NL_BE[::-1][1:],                    # -> the coast at Cadzand
        (51.55, 3.30),                        # North Sea envelope
        (51.70, 3.40),                        #   (the delta)
        (52.00, 3.90),
        (52.50, 4.40),
        (53.15, 4.60),                        # Texel in
        (53.35, 4.80),
        (53.52, 5.10),                        # Frisian islands in
        (53.55, 5.60),
        (53.60, 6.20),                        # Schiermonnikoog in
    ],
    ("BE", None): [
        (51.09, 2.546),                       # coast (FR shared)
        (51.30, 2.85),                        # North Sea (Ostend in)
        (51.40, 3.25),
        (51.375, 3.38),                       # coast (NL shared)
        *_NL_BE[1:],                          # -> Vaals
        *_DE_BE[1:],                          # -> Ouren
        *_BE_LU[1:],                          # -> the FR tripoint
        *_FR_BE[::-1][1:],                    # -> the coast
    ],
    ("LU", None): [
        *_BE_LU,                              # Ouren -> the FR tripoint
        *_FR_LU[1:],                          # -> Schengen
        *_DE_LU[::-1][1:],                    # -> Ouren (closes)
    ],
    # --- The Nordics (round 4k).
    ("SE", None): [
        *_NO_SE[::-1],                        # Treriksroset -> the
        (58.45, 11.00),                       #   Oslofjord; Bohuslaen
        *_DK_SE[::-1],                        # Kattegat + Oeresund
        (55.24, 12.95),                       # the DK ring's Baltic
        (55.30, 13.50),                       #   edge SHARED verbatim
        (55.35, 14.20),                       #   (coincident, no gap)
        (55.45, 14.60),                       # north of the Bornholm
        (55.48, 15.40),                       #   lobe
        (55.60, 16.50),
        (56.00, 17.00),
        (56.80, 17.50),                       # Oeland in
        (56.90, 18.80),                       # Gotland south in
        (57.30, 19.70),                       # Gotland east in
        (58.00, 19.90),
        (58.60, 19.80),
        (59.30, 19.60),
        *_SE_FI_SEA[::-1][1:],                # the Aland + Bothnia
        *_SE_FI[::-1][1:],                    #   midline; the Torne
    ],                                        #   valley -> Treriksroset
    ("NO", None): [
        *_NO_SE,                              # Svinesund -> Treriksroset
        *_FI_NO[::-1][1:],                    # -> the RU tripoint area
        (69.25, 29.30),                       # NO/RU (conservative;
        (69.45, 30.05),                       #   Kirkenes NO north)
        (69.55, 30.20),
        (69.65, 30.45),
        (69.79, 30.80),                       # Grense Jakobselv
        (70.00, 31.20),                       # the Varangerfjord
        (71.30, 31.00),                       # Barents envelope
        (71.40, 26.00),                       # North Cape in
        (71.20, 22.00),
        (70.50, 17.50),
        (69.50, 13.50),                       # Lofoten in
        (68.00, 11.50),
        (66.00, 10.00),
        (64.00, 8.00),
        (62.50, 3.50),
        (60.50, 3.30),                        # Bergen offshore
        (58.50, 4.50),
        (57.80, 7.20),                        # Skagerrak midline
        (57.90, 8.50),                        #   (north of the DK
        (58.25, 10.00),                       #   ring's edge)
        (58.40, 10.60),
    ],
    # --- Southeastern Europe (round 4l): Slovenia (the IT chain, its
    # own conservative AT-side edge — a dead strip to the AT ring —
    # the shared SI/HU and SI/HR chains, and a Gulf-of-Trieste sliver
    # east of the IT midline), Croatia (the shared Adriatic-midline
    # values of the IT ring, the Neum corridor cut — BA's coast splits
    # the ring's LAND but the sea keeps it one polygon — and
    # conservative BA/RS/ME edges), Hungary (the AT/SI/HR/SK shared
    # chains and conservative UA/RO/RS lines), Slovakia (entirely
    # shared chains + a short conservative UA edge), and Greece (a
    # conservative north land border and an Aegean envelope threading
    # every strait: the Corfu channel, Gökçeada/Bozcaada TR out,
    # Lesbos/Chios/Samos/Kos/Rhodes midlines; Kastellorizo concedes
    # to its anchor).
    ("SI", None): [
        *_IT_SI[::-1],                        # the coast -> AT tripoint
        (46.47, 13.95),                       # SI's AT edge
        (46.42, 14.16),                       #   (conservative; dead
        (46.40, 14.55),                       #   strip to the AT ring)
        (46.38, 14.83),
        (46.44, 15.06),
        (46.56, 15.42),
        (46.62, 15.63),                       # Maribor SI in
        (46.645, 15.98),
        (46.72, 16.18),
        (46.80, 16.18),
        (46.87, 16.11),                       # AT/SI/HU tripoint
        *_SI_HU[1:],                          # -> SI/HU/HR
        *_SI_HR[::-1][1:],                    # -> the Dragonja mouth
        (45.50, 13.47),                       # Gulf of Trieste sliver
        (45.555, 13.60),                      #   (east of the IT
    ],                                        #   midline; Piran in)
    ("HR", None): [
        *_SI_HR,                              # the Dragonja -> SI/HU/HR
        *_HR_HU[1:],                          # the Drava -> HU/HR/RS
        (45.65, 18.90),                       # HR/RS (the Danube,
        (45.52, 18.95),                       #   conservative west)
        (45.40, 19.05),
        (45.32, 19.20),
        (45.22, 19.40),                       # Ilok HR east
        (45.15, 19.25),
        (45.05, 19.10),
        (44.90, 19.05),                       # the Sava corner
        *_HR_BA,                              # the Sava/Una/Dinara
                                              #   crescent + the Neum
                                              #   corridor cut (shared
                                              #   VERBATIM with the BA
                                              #   ring; Dubrovnik in)
        (42.55, 18.45),
        (42.47, 18.50),                       # Prevlaka (ME concedes)
        (42.28, 18.35),                       # the Adriatic south
        (42.10, 17.80),
        (41.90, 17.20),                       # the IT-ring midline
        (42.50, 16.00),                       #   values SHARED verbatim
        (43.60, 14.40),                       #   (coincident, no gap)
        (43.94, 14.03),
        (44.80, 13.10),
        (44.95, 13.15),
        (45.50, 13.45),                       # Gulf of Trieste (the
    ],                                        #   SI sliver northeast)
    ("HU", None): [
        *_AT_HU[::-1],                        # AT/HU/SK -> the SI
        *_SI_HU,                              #   tripoint; -> SI/HU/HR
        *_HR_HU,                              # the Drava -> HU/HR/RS
        *_HU_RS[1:],                          # conservative RS line
        *_HU_RO[1:],                          # -> the HU/UA/RO tripoint
        (48.00, 22.80),                       # HU/UA (conservative)
        (48.20, 22.40),
        (48.41, 22.155),                      # HU/SK/UA tripoint
        *_HU_SK[::-1][1:],                    # -> AT/HU/SK (closes)
    ],
    ("SK", None): [
        *_AT_SK,                              # AT/HU/SK -> AT/CZ/SK
        *_CZ_SK[1:],                          # -> Hrcava
        *_PL_SK[1:],                          # -> PL/SK/UA
        (48.80, 22.33),                       # SK/UA (conservative;
        (48.62, 22.24),                       #   Uzhhorod UA east)
        (48.41, 22.155),
        *_HU_SK[::-1][1:],                    # -> AT/HU/SK (closes)
    ],
    ("GR", None): [
        (39.755, 19.975),                     # the Corfu channel
        (39.68, 20.10),                       # GR/AL (conservative)
        (39.92, 20.30),
        (40.05, 20.60),
        (40.30, 20.80),
        (40.48, 20.95),
        (40.55, 21.05),                       # GR/AL/MK tripoint
        (40.85, 21.15),                       # GR/MK (conservative;
        (41.05, 21.60),                       #   Bitola MK north)
        (41.10, 22.00),
        (41.12, 22.50),                       # (Gevgelija MK north)
        (41.15, 22.75),
        (41.20, 23.00),                       # GR/BG (conservative)
        (41.38, 23.35),                       # Promachonas/Kulata
        (41.40, 24.00),                       # the Rhodopes
        (41.35, 24.60),
        (41.45, 25.20),
        (41.30, 25.90),
        (41.32, 26.20),
        (41.50, 26.30),
        (41.70, 26.34),                       # GR/BG/TR tripoint
        (41.66, 26.53),                       # the Evros midline
        (41.55, 26.60),                       #   (Edirne TR east,
        (41.40, 26.61),                       #   Didymoteicho GR west)
        (41.35, 26.55),
        (41.20, 26.40),
        (41.00, 26.33),
        (40.85, 26.10),
        (40.73, 26.05),                       # the Evros delta
        (40.45, 25.95),                       # Aegean: Gökçeada TR out
        (40.28, 25.58),
        (39.95, 25.68),                       # (Limnos GR west)
        (39.60, 26.25),                       # (Bozcaada TR northeast)
        (39.35, 26.72),                       # Lesbos strait midline
        (39.05, 26.73),
        (38.85, 26.52),
        (38.60, 26.42),                       # Chios strait (Cesme TR)
        (38.35, 26.23),
        (38.10, 25.98),
        (37.90, 26.30),
        (37.86, 26.70),                       # Samos north midline
        (37.82, 27.00),                       #   (Kusadasi TR north)
        (37.70, 27.065),                      # the Mycale strait
        (37.55, 27.12),                       #   (~1.6 km, threaded)
        (37.30, 27.18),
        (37.05, 27.28),                       # (Bodrum TR east)
        (36.92, 27.38),                       # Kos east
        (36.78, 27.52),
        (36.68, 27.85),
        (36.55, 28.15),                       # Rhodes strait
        (36.28, 28.42),
        (35.95, 28.32),                       # (Kastellorizo concedes
        (35.55, 27.75),                       #   to its anchor)
        (35.18, 27.15),                       # Karpathos in
        (34.70, 26.20),
        (34.60, 24.50),                       # Crete south (Gavdos in)
        (34.70, 23.30),
        (35.70, 23.20),                       # Crete west
        (36.00, 22.75),                       # Kythira in
        (35.95, 22.30),
        (36.15, 21.85),
        (36.55, 21.35),                       # the Peloponnese west
        (37.20, 20.85),
        (37.55, 20.35),                       # Zakynthos in
        (38.25, 20.15),                       # Kefalonia in
        (38.85, 20.25),
        (39.35, 19.65),                       # Corfu west
        (39.62, 19.52),
        (39.82, 19.78),                       # Corfu north (the channel
    ],                                        #   closes at the midline)
    # --- The Balkans + Romania/Bulgaria (round 4l).  Serbia and
    # Kosovo stay deliberately anchor-resolved (their shared borders
    # would pin the Kosovo question into geometry; Belgrade/Novi Sad
    # anchors already resolve RS) — every neighbour ring keeps a
    # conservative edge against them.
    ("RO", None): [
        *_HU_RO[::-1],                        # HU/UA/RO -> the RS
        (45.95, 20.45),                       #   tripoint; RO/RS
        (45.80, 20.60),                       #   (conservative; the
        (45.55, 20.80),                       #   Banat line)
        (45.35, 21.05),
        (45.15, 21.36),
        (44.95, 21.40),
        (44.82, 21.40),                       # the Danube at Bazias
        (44.66, 21.65),                       # the Iron Gates midline
        (44.65, 22.00),
        (44.68, 22.30),
        (44.70, 22.45),                       # Orsova RO north
        (44.62, 22.63),                       # Drobeta RO / Kladovo RS
        (44.45, 22.72),
        (44.35, 22.70),
        (44.21, 22.68),                       # the Timok mouth (BG)
        *_RO_BG,                              # the Danube + Dobruja
        (43.75, 28.90),                       # Black Sea envelope
        (44.00, 29.10),
        (44.50, 29.30),
        (45.10, 29.80),                       # the delta offshore
        (45.35, 29.62),
        (45.25, 29.20),                       # the Chilia arm (Izmail
        (45.30, 28.75),                       #   UA north)
        (45.40, 28.45),
        (45.47, 28.21),                       # the Prut/Danube corner
        (45.60, 28.15),                       # the Prut north (Moldova
        (45.90, 28.20),                       #   east, anchor-resolved)
        (46.30, 28.25),
        (46.80, 28.10),
        (47.00, 27.90),
        (47.20, 27.75),                       # (Iasi RO west)
        (47.50, 27.30),
        (47.80, 26.90),
        (48.10, 26.70),
        (48.22, 26.63),                       # RO/UA/MD tripoint area
        (48.00, 26.30),                       # RO/UA (conservative;
        (47.95, 26.00),                       #   Chernivtsi UA north)
        (47.90, 25.90),
        (47.73, 25.20),
        (47.73, 24.90),
        (47.90, 24.20),
        (47.94, 23.90),                       # the Tisza (Sighetu RO S)
        (47.90, 23.20),
    ],
    ("BG", None): [
        *_RO_BG[::-1],                        # the Dobruja + Danube
        (44.05, 22.60),                       # BG/RS (conservative)
        (43.85, 22.45),
        (43.65, 22.50),
        (43.40, 22.55),
        (43.15, 22.80),
        (43.00, 22.92),                       # (Dimitrovgrad RS west)
        (42.85, 22.55),
        (42.70, 22.45),
        (42.50, 22.45),
        (42.32, 22.37),                       # RS/MK/BG area corner
        (42.20, 22.45),                       # BG/MK (conservative;
        (42.10, 22.60),                       #   MK keeps a dead strip)
        (41.90, 22.70),
        (41.75, 22.90),
        (41.60, 22.95),
        (41.40, 22.95),
        (41.34, 22.94),                       # MK/GR/BG tripoint area
        (41.20, 23.00),                       # the GR chain SHARED
        (41.38, 23.35),                       #   verbatim (the
        (41.40, 24.00),                       #   Rhodopes)
        (41.35, 24.60),
        (41.45, 25.20),
        (41.30, 25.90),
        (41.32, 26.20),
        (41.50, 26.30),
        (41.70, 26.34),                       # GR/BG/TR tripoint
        (41.97, 26.60),                       # BG/TR (conservative;
        (41.94, 27.00),                       #   Edirne/Kirklareli TR
        (41.92, 27.30),                       #   south, Malko Tarnovo
        (41.96, 27.55),                       #   BG north)
        (41.98, 28.02),                       # Rezovo (the coast)
        (42.20, 28.20),                       # Black Sea envelope
        (42.80, 28.10),
        (43.40, 28.80),
    ],
    ("AL", None): [
        (39.755, 19.975),                     # the Corfu channel (GR
        (39.68, 20.10),                       #   chain shared verbatim)
        (39.92, 20.30),
        (40.05, 20.60),
        (40.30, 20.80),
        (40.48, 20.95),
        *_AL_MK,                              # the lakes -> AL/MK/XK
        (42.10, 20.55),                       # AL/XK (conservative)
        (42.30, 20.45),
        (42.40, 20.22),
        *_AL_ME,                              # -> the Bojana mouth
        (41.70, 19.30),                       # Adriatic envelope
        (41.30, 19.15),                       # (Durres in)
        (40.60, 19.15),
        (40.30, 19.20),                       # (Vlore in)
        (40.05, 19.48),
        (39.90, 19.80),
        (39.80, 19.99),                       # Saranda in (Corfu GR
    ],                                        #   west of the midline)
    ("MK", None): [
        *_AL_MK[::-1],                        # AL/MK/XK -> the GR
        (40.55, 21.05),                       #   tripoint; then the GR
        (40.85, 21.15),                       #   chain shared verbatim
        (41.05, 21.60),                       #   (Bitola MK north of
        (41.10, 22.00),                       #   it, Florina GR south)
        (41.12, 22.50),
        (41.15, 22.75),
        (41.30, 22.86),                       # MK/BG (conservative;
        (41.55, 22.90),                       #   dead strip to the BG
        (41.75, 22.85),                       #   ring)
        (41.90, 22.68),
        (42.10, 22.58),
        (42.22, 22.40),
        (42.32, 22.37),                       # RS/MK/BG area corner
        (42.37, 21.90),                       # MK/RS + MK/XK north
        (42.32, 21.70),                       #   (conservative;
        (42.25, 21.50),                       #   Kumanovo/Skopje in)
        (42.25, 21.15),
        (42.20, 21.00),
        (42.10, 20.75),
        (41.98, 20.65),
    ],
    ("ME", None): [
        (42.47, 18.50),                       # the HR reach (shared)
        (42.55, 18.45),
        *_ME_BA,                              # -> the RS/BA/ME corner
        (43.40, 19.50),                       # ME/RS (conservative)
        (43.25, 19.70),
        (43.15, 19.95),
        (43.05, 20.10),
        (42.95, 20.25),
        (42.85, 20.25),                       # the XK corner area
        (42.70, 20.20),                       # ME/XK (conservative)
        *_AL_ME,                              # -> the Bojana mouth
        (41.88, 19.18),                       # the Adriatic coast
        (42.05, 18.95),                       # (Ulcinj/Bar/Budva in)
        (42.20, 18.70),
        (42.35, 18.55),                       # the Bay of Kotor
        (42.40, 18.48),
    ],
    ("BA", None): [
        *_HR_BA[::-1],                        # the Dubrovnik reach ->
        (44.90, 19.05),                       #   the Sava corner (HR
        (44.70, 19.25),                       #   shared); BA/RS: the
        (44.50, 19.13),                       #   Drina (conservative)
        (44.30, 19.35),
        (44.10, 19.28),
        (43.95, 19.40),
        (43.75, 19.35),
        (43.60, 19.25),
        (43.50, 19.22),                       # RS/BA/ME corner
        *_ME_BA[::-1][1:],                    # -> the HR reach
        (42.55, 18.45),                       # (shared with HR/ME)
    ],
    # --- The Baltics (round 4m).
    ("EE", None): [
        *_EE_LV_GULF[::-1],                   # the Irbe -> Ainazi
        *_EE_LV,                              # -> the RU tripoint
        (57.65, 27.35),                       # EE/RU (conservative;
        (57.80, 27.52),                       #   Pechory RU east)
        (57.85, 27.55),
        (57.95, 27.70),
        (58.05, 27.60),                       # Lake Peipus midline
        (58.30, 27.50),
        (58.70, 27.50),
        (59.00, 27.90),                       # the Narva river
        (59.20, 28.15),
        (59.376, 28.200),                     # Narva EE / Ivangorod RU
        (59.47, 28.045),                      # the Narva mouth
        (59.52, 27.85),                       # Gulf of Finland shore
        (59.55, 26.50),                       #   (south of the FI
        (59.55, 25.00),                       #   ring's midline)
        (59.55, 24.00),
        (59.40, 23.00),                       # the NW envelope
        (59.30, 22.60),
        (59.15, 22.10),                       # Hiiumaa in
        (58.90, 21.60),
        (58.20, 21.45),                       # Saaremaa west in
        (57.70, 21.75),                       # (Soerve in; joins the
    ],                                        #   Irbe midline)
    ("LV", None): [
        *_EE_LV[::-1],                        # the RU tripoint -> the
        (57.875, 24.37),                      #   Ainazi coast...
        *_EE_LV_GULF[1:],                     # the gulf split (Kolka
        (57.60, 21.40),                       #   in); the open Baltic
        (57.20, 21.00),
        (56.30, 20.80),
        *_LV_LT,                              # Butinge -> the tripoint
        (55.85, 27.00),                       # LV/BY (conservative;
        (55.95, 27.40),                       #   Daugavpils in)
        (56.15, 27.65),
        (56.30, 28.00),
        (56.45, 28.20),
        (56.65, 28.10),                       # LV/RU (conservative)
        (56.85, 28.00),
        (57.05, 27.80),
        (57.30, 27.55),
    ],
    ("LT", None): [
        *_LV_LT[::-1],                        # the tripoint -> Butinge
        (55.80, 20.80),                       # the Baltic (Klaipeda,
        (55.30, 20.70),                       #   Palanga in)
        (55.275, 20.965),                     # the Curonian spit
        (55.28, 21.10),                       #   crossing (Nida LT in)
        (55.30, 21.25),                       # the lagoon / Neman delta
        (55.085, 21.88),                      # Sovetsk RU / Panemune LT
        (55.04, 22.40),                       # the Neman midline
        (54.95, 22.75),
        (54.70, 22.80),
        (54.36, 22.79),                       # PL/LT/RU tripoint
        (54.25, 23.05),                       # the PL chain shared
        (54.15, 23.35),                       #   verbatim
        (53.96, 23.51),                       # PL/BY/LT tripoint
        (54.00, 24.20),                       # LT/BY (conservative;
        (53.95, 24.70),                       #   Grodno BY south)
        (54.15, 25.00),
        (54.15, 25.50),
        (54.30, 25.60),
        (54.60, 25.75),                       # (Vilnius LT west)
        (54.85, 25.75),
        (54.95, 26.00),
        (55.25, 26.50),
        (55.40, 26.75),
    ],
    # --- Turkey + Cyprus (round 4m).  Turkey's west edge shares the
    # GR ring's Evros + Aegean strait midlines and the BG ring's
    # Thrace line VERBATIM; the Black Sea/Med envelopes are generous;
    # the eastern land borders (GE/AM/IR/IQ/SY) are conservative with
    # no rings on the far side; the envelope threads the 1-2 km gaps
    # around the Kastellorizo square and stays north of Cyprus.
    # Cyprus is one ISO ring (the whole island resolves CY, as the
    # reference's country-boundaries DB does).
    ("TR", None): [
        (41.70, 26.34),                       # GR/BG/TR tripoint
        (41.66, 26.53),                       # the Evros midline
        (41.55, 26.60),                       #   (GR shared verbatim)
        (41.40, 26.61),
        (41.35, 26.55),
        (41.20, 26.40),
        (41.00, 26.33),
        (40.85, 26.10),
        (40.73, 26.05),                       # the Evros delta
        (40.45, 25.95),                       # the Aegean midlines
        (40.28, 25.58),                       #   (GR shared verbatim;
        (39.95, 25.68),                       #   Goekceada/Bozcaada in)
        (39.60, 26.25),
        (39.35, 26.72),
        (39.05, 26.73),
        (38.85, 26.52),
        (38.60, 26.42),
        (38.35, 26.23),
        (38.10, 25.98),
        (37.90, 26.30),
        (37.86, 26.70),
        (37.82, 27.00),
        (37.70, 27.065),                      # the Mycale strait
        (37.55, 27.12),
        (37.30, 27.18),
        (37.05, 27.28),
        (36.92, 27.38),
        (36.78, 27.52),
        (36.68, 27.85),
        (36.55, 28.15),
        (36.28, 28.42),                       # the Rhodes midline end
        (36.18, 28.90),
        (36.18, 29.54),                       # the Kastellorizo thread
        (36.185, 29.63),                      #   (Kas TR north, the GR
        (36.15, 30.00),                       #   square south)
        (36.00, 31.00),
        (35.95, 32.30),                       # north of Cyprus
        (35.95, 34.60),
        (36.10, 35.40),
        (35.95, 35.91),                       # the Med coast at the
        (35.98, 36.06),                       #   SY border (Kessab SY
        (36.30, 36.65),                       #   freed); the Hatay rim
        (36.55, 36.60),                       #   (conservative)
        (36.86, 36.82),                       # the Afrin salient wrap
        (36.72, 37.05),                       #   (Meidan Ekbis SY out)
        (36.80, 37.40),
        (36.90, 38.00),
        (36.95, 38.35),                       # Kobani SY stays south,
        (36.75, 38.95),                       #   Suruc TR in
        (36.80, 39.20),
        (36.90, 40.00),
        (37.09, 40.50),
        (37.12, 40.95),                       # Amuda SY stays south
        (37.085, 41.22),                      # (Qamishli SY south)
        (37.14, 41.65),                       # the railway line rises
        (37.25, 42.00),                       #   to the Tigris (Idil/
        (37.33, 42.23),                       #   Cizre TR in; the SY
        (37.29, 42.31),                       #   duck-bill stays out)
        *_TR_IQ,                              # the Iraq chain (shared
        (37.45, 44.60),                       #   VERBATIM); then TR/IR
        (37.95, 44.50),
        (38.40, 44.30),
        (38.80, 44.30),
        (39.00, 44.40),
        (39.40, 44.40),
        (39.65, 44.80),                       # the Aras corner
        (39.72, 44.60),                       # TR/AM + Nakhchivan
        (40.02, 43.58),                       #   (conservative;
        (40.20, 43.65),                       #   Gyumri AM east)
        (40.60, 43.65),
        (41.10, 43.45),
        (41.18, 43.38),                       # TR/GE (conservative)
        (41.40, 43.00),
        (41.45, 42.50),
        (41.48, 42.00),
        (41.51, 41.54),                       # Sarpi (Batumi GE north)
        (41.80, 40.80),                       # Black Sea envelope
        (41.60, 39.50),
        (41.50, 38.00),
        (42.40, 35.00),                       # (Sinop in)
        (42.10, 33.00),
        (42.30, 31.50),
        (42.00, 29.30),
        (41.98, 28.40),
        (41.98, 28.02),                       # Rezovo (the BG chain
        (41.96, 27.55),                       #   shared verbatim)
        (41.92, 27.30),
        (41.94, 27.00),
        (41.97, 26.60),
    ],
    ("CY", None): [                           # Cyprus (whole-island
        (35.90, 32.10), (35.90, 34.70),       #   ISO assignment; the
        (34.40, 34.70), (34.40, 32.10)],      #   TR envelope stays N)
    # --- Southeast Asia (round 4n; chain rationale at the constants
    # above).  Thailand: the Mekong/range Laos border, the Dangrek
    # Cambodia border, the shared _TH_MY chain, generous gulf and
    # Andaman envelopes threading Koh Kut (TH) vs the Koh Kong
    # islands (KH), Ko Lipe/Tarutao (TH) vs Langkawi (MY) and the
    # Surin islands (TH) vs Myanmar's Mergui archipelago, and a
    # conservative Myanmar land edge that dips at the uncertain
    # range segments (no MM ring; MM has its own tz anchor).
    ("TH", None): [
        *_MEKONG_GT,
        *_TH_LA_RANGE,
        *_MEKONG_LOWER,
        *_TH_LA_S,
        *_TH_KH[1:],                          # (tripoint shared)
        (11.50, 102.76),                      # Koh Kut TH in, the
        (11.05, 102.55),                      #   Koh Kong islands out
        (10.20, 102.00),                      # gulf envelope
        (9.20, 101.70),
        (8.30, 101.75),
        (7.10, 102.30),
        (6.30, 102.115),                      # toward the Golok mouth
        *_TH_MY,
        (6.40, 99.28),                        # Ko Lipe/Adang TH in
        (6.60, 98.90),                        # Andaman envelope
        (7.50, 97.90),
        (8.70, 97.45),                        # Similan TH in
        (9.45, 97.65),                        # Surin TH in
        (9.87, 98.47),                        # Mergui MM stays north
        (9.98, 98.585),                       # the Pakchan estuary:
        (10.35, 98.73),                       #   Ranong TH east,
        (10.64, 98.78),                       #   Kawthaung MM west
        (11.00, 99.00),                       # the Tenasserim crest
        (11.60, 99.38),
        (11.81, 99.64),                       # Dan Singkhon (Prachuap
        (12.30, 99.40),                       #   12 km strip)
        (12.90, 99.20),
        (13.54, 99.22),                       # Suan Phueng TH east
        (14.10, 98.93),
        (14.50, 98.60),
        (14.68, 98.34),                       # the Pilok salient dip
        (14.95, 98.48),
        (15.10, 98.42),
        (15.303, 98.39),                      # Three Pagodas Pass
        (15.70, 98.51),                       # the Moei river north:
        (16.00, 98.57),                       #   Mae Sot TH east /
        (16.70, 98.535),                      #   Myawaddy MM west
        (17.20, 98.30),
        (17.55, 97.95),
        (17.84, 97.74),                       # Moei-Salween confluence
        (18.25, 97.72),                       # the Salween reach
        (18.55, 97.66),
        (18.75, 97.83),
        (19.30, 97.80),                       # Mae Hong Son TH east
        (19.58, 97.93),
        (19.78, 98.60),                       # Wiang Haeng dip
        (20.05, 99.00),
        (20.06, 99.30),                       # Mae Ai dip
        (20.30, 99.60),
        (20.437, 99.88),                      # Mae Sai TH / Tachileik
        (20.44, 99.95),                       #   MM (the Sai river)
        (20.37, 100.06),                      # the Ruak to the GT
    ],
    # Peninsular Malaysia (Borneo's Sarawak/Sabah keep their own
    # admin-1 anchors and stay anchor-resolved; Langkawi in via the
    # shared Tarutao thread; the Malacca-strait midline keeps
    # Sumatra/Rupat/Karimun Indonesian; Tanjung Piai rounds the tip;
    # the shared _JOHOR_STRAIT midline splits JB/Woodlands).
    ("MY", None): [
        *_TH_MY,
        (6.10, 99.20),                        # west of Langkawi
        (5.90, 98.80),                        # Malacca strait midline
        (4.50, 99.30),
        (3.00, 100.35),
        (2.20, 101.75),
        (1.90, 102.10),                       # Rupat ID stays west
        (1.45, 102.85),
        (1.30, 103.30),                       # Karimun ID stays south
        (1.255, 103.515),                     # Tanjung Piai / Kukup
        (1.30, 103.56),
        *_JOHOR_STRAIT,
        (1.45, 104.40),                       # Desaru in
        (2.00, 104.50),
        (2.90, 104.45),                       # Tioman in, Anambas ID
        (4.50, 103.90),                       #   far east out
        (5.50, 103.60),
        (6.10, 102.95),                       # Perhentian/Redang in
        (6.30, 102.60),                       # (dead water wedge vs
    ],                                        #   the TH gulf edge)
    ("SG", None): [                           # Singapore: the shared
        *[(la, lo) for la, lo in reversed(_JOHOR_STRAIT)],
        (1.24, 103.60),                       #   strait midline N,
        (1.195, 103.70),                      #   Singapore-strait
        (1.195, 103.93),                      #   midline S (Sentosa/
        (1.26, 104.10),                       #   Jurong I. in; Batam/
    ],                                        #   Sambu ID out)
    # Laos: tzdata merged Asia/Vientiane into Asia/Bangkok so Laos
    # has NO anchors — every Lao photo resolved to Thailand before
    # this ring.  Thailand edges are the four shared chains verbatim
    # (zero dead strip on the Mekong); the MM edge is the upper
    # Mekong midline; the CN edge and the whole VN edge (the
    # Annamite crest) are conservative with a deliberate dead strip —
    # Vietnam's ring carries its own conservative west edge, the
    # YT/NT divide convention, because the jungle crest cannot be
    # hand-authored to shared-verbatim precision.
    ("LA", None): [
        (20.55, 100.22),                      # the upper Mekong
        (20.80, 100.55),                      #   (LA/MM midline,
        (21.10, 100.80),                      #   Tachileik side west)
        (21.30, 101.05),
        (21.44, 101.14),                      # MM/CN tripoint region
        (21.32, 101.55),                      # CN edge (conservative;
        (21.28, 101.80),                      #   Boten unasserted)
        (21.55, 102.00),
        (22.30, 102.05),                      # the Phongsali salient
        (22.45, 102.18),                      #   (wrapped N of 22.4)
        (22.20, 102.45),
        (21.70, 102.50),                      # VN edge begins:
        (21.40, 102.75),                      #   Dien Bien Phu VN east
        (20.90, 102.90),
        (20.60, 103.30),
        (20.55, 103.80),                      # the Houaphanh salient
        (20.70, 104.10),                      #   (Sam Neua inside,
        (20.55, 104.45),                      #   Son La VN north)
        (20.20, 104.70),
        (19.90, 104.50),
        (19.50, 104.40),
        (19.00, 104.85),
        (18.60, 105.10),                      # Vinh VN east
        (18.30, 105.35),                      # the Keo Nua pass
        (17.90, 105.65),                      # (Quang Binh narrows)
        (17.60, 105.95),
        (17.20, 106.25),
        (16.80, 106.45),
        (16.62, 106.53),                      # Lao Bao VN east
        (16.30, 106.80),
        (16.05, 107.10),                      # A Luoi VN east
        (15.70, 107.35),
        (15.20, 107.45),
        (14.95, 107.50),
        *_LA_KH,                              # (ends at the Emerald
        *[(la, lo) for la, lo in reversed(_TH_LA_S)][1:],   # tripoint)
        *[(la, lo) for la, lo in reversed(_MEKONG_LOWER)],
        *[(la, lo) for la, lo in reversed(_TH_LA_RANGE)],
        *[(la, lo) for la, lo in reversed(_MEKONG_GT)],
    ],
    # Cambodia: tzdata merged Asia/Phnom_Penh into Asia/Bangkok so
    # Cambodia has NO anchors either — Phnom Penh resolved to VIETNAM
    # and Siem Reap/Angkor to THAILAND before this ring.  The TH edge
    # is the shared Dangrek chain verbatim; the LA edge the shared
    # _LA_KH chain; the VN edge is conservative (dead strip, see the
    # LA comment) threading the Parrot's Beak (Bavet KH inside, Moc
    # Bai/Tay Ninh VN out) and the Ha Tien coast; the gulf envelope
    # wraps WEST and NORTH of Vietnamese Phu Quoc and keeps the Koh
    # Kong islands, Koh Rong, Koh Tang and Poulo Wai Cambodian
    # against the Thai envelope.
    ("KH", None): [
        *_TH_KH,                              # tripoint -> Hat Lek
        (11.50, 102.76),                      # shared with TH's gulf
        (11.10, 102.75),                      #   thread (Koh Kut TH /
        (9.80, 102.80),                       #   Koh Kong KH)
        (9.90, 103.60),                       # Koh Tang / Poulo Wai in
        (10.35, 103.70),                      # west of Phu Quoc VN
        (10.47, 103.95),                      # north of Phu Quoc
        (10.44, 104.25),
        (10.53, 104.52),                      # coast (Kep KH in, Ha
        (10.63, 104.80),                      #   Tien VN out)
        (10.76, 105.07),                      # Chau Doc VN south
        (10.95, 105.40),
        (10.93, 105.80),
        (10.96, 106.02),                      # the Parrot's Beak:
        (11.06, 106.19),                      #   Bavet KH at the tip,
        (11.22, 105.98),                      #   Moc Bai VN east,
        (11.55, 105.90),                      #   Tay Ninh VN north
        (11.75, 106.20),
        (11.95, 106.45),                      # Loc Ninh VN east
        (12.10, 106.70),
        (12.50, 107.35),                      # the Mondulkiri bulge
        (12.80, 107.55),
        (13.20, 107.62),
        (13.60, 107.60),
        (14.10, 107.55),                      # Banlung KH west
        (14.45, 107.52),
        *_LA_KH[:-1],                         # tripoint -> Emerald
    ],                                        #   (end shared with TH)
    # --- The Caribbean (round 4o).  zone1970 merged the whole AST
    # basin into America/Puerto_Rico (AG AI AW BL BQ CW DM GD GP KN
    # LC MF MS SX TT VC VG VI), America/Toronto (BS) and
    # America/Panama (KY), so NONE of these countries has an anchor:
    # every photo taken there resolved to Puerto Rico, Canada or
    # Panama-adjacent anchors.  Island envelopes with channel
    # midlines at every contested strait: the 1648 St Martin line
    # (MF north / SX south), the Anguilla Channel, the Narrows
    # (St John VI / Tortola VG at ~1.5 km), the VC/GD Grenadines
    # split (Union VC / Petite Martinique GD), the Bocas (Patos VE /
    # Chacachacare TT), and the Bahamas envelope threading the
    # Florida Strait, the Old Bahama Channel and the Turks gap.
    ("BS", None): [                           # the Bahamas archipelago
        (27.5, -79.10),
        (27.5, -77.00),
        (26.2, -74.70),
        (23.8, -73.80),                       # San Salvador in
        (22.60, -72.65),                      # Mayaguana in
        (22.10, -72.85),                      # Turks & Caicos south
        (21.30, -73.00),
        (20.75, -73.35),                      # Great Inagua in
        (20.78, -74.00),                      # Cuba's Maisi southwest
        (21.50, -75.50),                      # the Old Bahama Channel
        (22.46, -77.60),                      #   (Ragged chain in),
        (23.22, -79.70),                      #   riding just north of
        (23.48, -80.32),                      #   Cuba's envelope
        (23.58, -80.55),                      # Cay Sal bank in
        (23.62, -80.90),
        (24.10, -80.50),                      # the Keys envelope
        (24.35, -80.16),                      #   stays US (west of
        (25.30, -79.72),                      #   the -80.2 line)
        (25.75, -79.70),                      # Bimini in, Miami out
        (26.55, -79.50),
    ],
    ("KY", None): [                           # all three Caymans
        (19.85, -81.55), (19.85, -79.65),
        (19.15, -79.65), (19.15, -81.55)],
    ("TT", None): [                           # Trinidad & Tobago
        (11.55, -61.15),
        (11.50, -60.40),                      # Tobago in
        (10.80, -60.40),
        (10.02, -60.85),
        (9.99, -61.55),                       # the Columbus Channel
        (10.20, -61.85),                      # Venezuela's delta south
        (10.55, -61.82),
        (10.72, -61.78),                      # the Bocas: Chacachacare
        (11.00, -61.60),                      #   TT in, Patos VE out
    ],
    ("GD", None): [                           # Grenada + Carriacou +
        (12.56, -61.55),                      #   Petite Martinique
        (12.555, -61.37),                     # (Union VC stays north)
        (12.30, -61.35),
        (11.90, -61.50),
        (11.90, -61.85),
        (12.30, -61.85),
    ],
    ("VC", None): [                           # St Vincent + the north
        (13.45, -61.35),                      #   Grenadines down to
        (13.45, -61.05),                      #   Union Island
        (12.85, -61.05),
        (12.575, -61.30),
        (12.575, -61.52),
        (12.90, -61.45),
    ],
    ("LC", None): [                           # St Lucia (Martinique
        (14.25, -61.15), (14.25, -60.80),     #   midline north, SV
        (13.55, -60.80), (13.55, -61.15)],    #   midline south)
    ("GP", None): [                           # Guadeloupe + Marie-
        (16.68, -61.90),                      #   Galante + Les
        (16.68, -60.95),                      #   Saintes + Desirade
        (15.72, -61.10),                      # (Dominica midline S,
        (15.72, -61.75),                      #   Antigua midline N)
        (16.10, -61.90),
    ],
    ("DM", None): [                           # Dominica
        (15.695, -61.65), (15.695, -61.10),
        (15.05, -61.10), (15.05, -61.65)],
    ("MS", None): [                           # Montserrat
        (16.90, -62.33), (16.90, -62.05),
        (16.60, -62.05), (16.60, -62.33)],
    ("AG", None): [                           # Antigua + Barbuda +
        (17.85, -62.00),                      #   Redonda (the L wraps
        (17.85, -61.60),                      #   Redonda southwest,
        (16.905, -61.60),                     #   north of Montserrat)
        (16.905, -62.40),
        (17.05, -62.40),
        (17.05, -62.00),
    ],
    ("KN", None): [                           # St Kitts & Nevis
        (17.46, -62.90), (17.46, -62.45),     #   (Statia BQ west)
        (17.05, -62.45), (17.05, -62.90)],
    ("BQ", "Bonaire"): [
        (12.40, -68.50), (12.40, -68.10),
        (11.95, -68.10), (11.95, -68.50)],
    ("BQ", "Sint Eustatius"): [
        (17.54, -63.03), (17.54, -62.92),
        (17.45, -62.92), (17.45, -63.03)],
    ("BQ", "Saba"): [
        (17.70, -63.30), (17.70, -63.15),
        (17.56, -63.15), (17.56, -63.30)],
    ("CW", None): [                           # Curacao + Klein
        (12.45, -69.25),                      #   Curacao (Venezuela's
        (12.45, -68.68),                      #   Paraguana stays SW)
        (11.93, -68.60),
        (11.93, -69.00),
        (12.20, -69.25),
    ],
    ("AW", None): [                           # Aruba
        (12.70, -70.15), (12.70, -69.80),
        (12.35, -69.80), (12.35, -70.15)],
    ("MF", None): [                           # St Martin, French N of
        (18.143, -63.18),                     #   the 1648 line
        (18.143, -62.95),                     #   (Marigot/Tintamarre;
        (18.058, -62.95),                     #   Anguilla Channel N)
        (18.058, -63.18),
    ],
    ("SX", None): [                           # Sint Maarten, Dutch
        (18.058, -63.155),                    #   south (Philipsburg,
        (18.058, -62.97),                     #   the airport)
        (17.985, -62.97),
        (17.985, -63.155),
    ],
    ("BL", None): [                           # St Barthelemy
        (17.975, -62.95), (17.975, -62.73),
        (17.84, -62.73), (17.84, -62.95)],
    ("AI", None): [                           # Anguilla (Sombrero
        (18.33, -63.30), (18.33, -62.92),     #   rock conceded)
        (18.155, -62.92), (18.155, -63.30)],
    ("VI", None): [                           # US Virgin Islands:
        (18.42, -65.12),                      #   St Thomas + St John
        (18.42, -64.84),                      #   + St Croix; the
        (18.422, -64.79),                     #   Narrows midline vs
        (18.380, -64.76),                     #   the UK side (Great
        (18.370, -64.73),                     #   Thatch in the strip)
        (18.357, -64.70),
        (18.322, -64.67),
        (18.279, -64.625),
        (17.62, -64.48),                      # St Croix in
        (17.62, -65.02),
        (18.10, -65.05),
    ],
    ("VG", None): [                           # British Virgin Islands
        (18.80, -64.50),                      #   (Anegada, Virgin
        (18.80, -64.18),                      #   Gorda, Tortola,
        (18.28, -64.18),                      #   Norman, Jost Van
        (18.295, -64.635),                    #   Dyke; Great Thatch
        (18.338, -64.68),                     #   conceded to the
        (18.373, -64.71),                     #   Narrows strip)
        (18.393, -64.74),
        (18.408, -64.77),
        (18.438, -64.80),
        (18.52, -64.80),
        (18.52, -64.50),
    ],
    # --- Southern Africa (round 4o).  ZW/ZM/MW/LS/SZ all lost their
    # zone rows to merges (Africa/Maputo covers ZW ZM MW; Africa/
    # Johannesburg covers LS SZ), so none has an anchor: Victoria
    # Falls photos resolved to nothing, Maseru and Mbabane to South
    # Africa.  The ZM/ZW border is the shared _ZM_ZW Zambezi/Kariba
    # chain verbatim (Livingstone/Vic Falls, Siavonga/Kariba and
    # Chirundu all split at the water); the ZW/BW edge stays well
    # east of Botswana's conservative ring; the ZM/CD edge wraps the
    # Congo Pedicle and the Luapula; Malawi's lake edge takes the
    # median (the TZ-claimed northeast quadrant and Mozambican
    # middle-east water conceded) with Likoma/Chizumulu as their own
    # enclave ring; Lesotho and Eswatini are conservative enclave
    # rings inside South Africa's anchor field.
    ("LS", None): [
        (-28.67, 28.18),                      # Fouriesburg ZA north
        (-28.78, 28.78),                      # the Drakensberg crest
        (-28.95, 29.05),
        (-29.25, 29.25),
        (-29.589, 29.289),                    # Sani Pass head
        (-29.78, 29.08),
        (-30.16, 28.70),                      # Qacha's Nek in
        (-30.52, 27.70),                      # Quthing in
        (-30.28, 27.32),
        (-29.90, 27.15),                      # Mafeteng in, Wepener
        (-29.55, 27.40),                      #   ZA out
        (-29.32, 27.475),                     # Maseru on the Caledon
        (-29.12, 27.70),                      #   (Ladybrand ZA west)
        (-28.885, 27.893),                    # Maputsoe / Ficksburg
        (-28.75, 28.05),                      #   river twins
    ],
    ("SZ", None): [
        (-25.78, 31.10),                      # Barberton ZA northwest
        (-25.78, 31.85),
        (-25.99, 31.99),                      # the Lebombo line
        (-26.85, 32.08),                      #   (Lomahasha/Namaacha
        (-27.07, 31.97),                      #   conceded to the
        (-27.25, 31.75),                      #   strip); Big Bend in
        (-27.25, 31.35),
        (-27.05, 31.05),                      # Nhlangano in
        (-26.80, 30.90),
        (-26.10, 30.95),
        (-25.90, 31.00),
    ],
    ("ZW", None): [
        *_ZM_ZW,                              # Kazungula -> Luangwa
        (-16.40, 30.40),                      # MZ edge (Zumbo MZ N)
        (-16.70, 30.95),
        (-16.70, 31.80),
        (-17.00, 32.55),
        (-17.30, 32.95),
        (-18.00, 32.90),
        (-18.60, 32.88),
        (-18.96, 32.705),                     # Mutare in, Manica MZ out
        (-19.50, 32.83),
        (-19.80, 32.95),
        (-20.10, 32.85),
        (-20.40, 32.68),                      # Espungabera MZ east
        (-20.90, 32.48),
        (-21.30, 32.41),
        (-22.38, 31.32),                      # Crooks Corner tripoint
        (-22.33, 30.90),                      # the Limpopo midline:
        (-22.28, 30.03),                      #   Beitbridge ZW north,
        (-22.20, 29.60),                      #   Musina ZA south
        (-22.21, 29.38),                      # the Shashe confluence
        (-21.40, 28.40),                      # BW edge (east of the
        (-20.90, 27.90),                      #   conservative BW ring)
        (-20.50, 27.765),                     # Plumtree ZW in
        (-19.80, 27.72),
        (-18.60, 25.80),                      # Pandamatenga BW west
    ],
    ("ZM", None): [
        (-17.70, 25.10),                      # NA edge: the Zambezi
        (-17.49, 24.285),                     # (Sesheke ZM / Katima
        (-17.45, 24.10),                      #   Mulilo NA split)
        (-16.80, 23.10),                      # AO edge (conservative)
        (-16.00, 22.40),
        (-13.03, 22.20),                      # the 22E side (Chavuma
        (-13.03, 23.90),                      #   in); the Cazombo
        (-11.35, 24.02),                      #   bulge wrapped
        (-11.20, 24.10),                      # CD edge begins
        (-10.75, 25.40),
        (-11.60, 26.60),
        (-11.95, 27.20),                      # Lubumbashi CD north
        (-12.33, 27.78),                      # Kasumbalesa corridor
        (-12.50, 28.30),                      # the Pedicle south edge
        (-12.58, 28.68),                      #   (Mufulira in); the
        (-12.05, 28.88),                      #   Luapula north: CD
        (-11.20, 28.78),                      #   west, Mansa ZM east
        (-10.50, 28.60),
        (-9.60, 28.45),                       # Lake Mweru midline
        (-8.75, 28.55),                       #   (Nchelenge in)
        (-8.45, 29.80),
        (-8.25, 30.30),                       # Lake Tanganyika SW
        (-8.45, 31.00),                       # (Mpulungu in)
        (-8.60, 31.40),                       # TZ edge (conservative;
        (-9.00, 32.20),                       #   Nakonde/Tunduma
        (-9.322, 32.758),                     #   conjoined unasserted)
        (-9.60, 32.95),                       # MW edge (own line,
        (-10.00, 33.30),                      #   dead strip vs MW)
        (-10.55, 33.50),
        (-11.00, 33.35),
        (-11.90, 33.30),
        (-12.60, 33.10),                      # Lundazi in
        (-12.80, 32.95),
        (-13.55, 32.72),                      # Chipata in, Mchinji
        (-14.05, 32.65),                      #   MW east
        (-14.40, 31.90),                      # MZ edge (conservative)
        (-14.90, 31.20),
        (-15.40, 30.65),
        *[(la, lo) for la, lo in reversed(_ZM_ZW)],
    ],                                        # Luangwa -> Kazungula
    ("MW", None): [
        (-9.78, 33.22),                       # the ZM side (own line,
        (-9.52, 33.22),                       #   Chitipa in)
        (-9.63, 33.80),                       # the Songwe (Kyela TZ
        (-9.62, 33.87),                       #   north of the dip);
        (-9.51, 33.93),                       #   the lake:
        (-9.80, 34.30),                       #   median line, the
        (-10.50, 34.45),                      #   TZ-claimed NE and
        (-11.50, 34.50),                      #   Mozambican middle-
        (-12.30, 34.45),                      #   east water conceded
        (-13.20, 34.55),
        (-13.60, 34.85),
        (-14.40, 35.25),                      # Mangochi at the outlet
        (-14.55, 35.50),
        (-15.20, 35.75),
        (-15.60, 35.85),
        (-15.95, 35.70),                      # the Mulanje wrap
        (-16.15, 35.60),
        (-16.55, 35.40),
        (-16.95, 35.35),                      # Nsanje in
        (-17.05, 35.20),                      # the Shire tail
        (-16.60, 35.05),                      #   (conservative)
        (-16.20, 34.85),
        (-15.50, 34.45),
        (-14.60, 34.35),
        (-14.38, 34.28),                      # Dedza in
        (-14.05, 33.65),                      # the Tete salient wrap
        (-14.15, 33.40),
        (-14.12, 33.00),
        (-13.80, 32.80),                      # Mchinji in (ZM west)
        (-13.00, 32.98),
        (-12.35, 33.33),
        (-12.00, 33.40),
        (-11.00, 33.48),
        (-10.55, 33.65),
    ],
    ("MW", "Likoma"): [                       # the Likoma/Chizumulu
        (-11.96, 34.58), (-11.96, 34.82),     #   enclaves in
        (-12.13, 34.82), (-12.13, 34.58)],    #   Mozambican water
    # --- East Africa (round 4o).  Uganda, Rwanda and Burundi all
    # lost their zone rows to merges (Africa/Nairobi's row covers UG,
    # Africa/Maputo's covers RW and BI), so none has an anchor —
    # Kampala resolved to a Kenyan anchor, Kigali to a Tanzanian.  The
    # UG/TZ border is the exact 1-degree-south parallel (including
    # through Lake Victoria); the UG/RW border is the shared _UG_RW
    # chain from Mount Sabyinyo's three-country summit; Lake Kivu's
    # border threads EAST of Congolese Idjwi island and splits the
    # conjoined Goma/Gisenyi and Bukavu/Kamembe pairs; the RW/BI
    # border leaves a dead strip (both sides conservative) around
    # Burundi's northern bulge so Kirundo stays Burundian; the
    # CD-facing edges are conservative lake midlines (Albert, Edward,
    # Kivu, Tanganyika) and the Ilemi triangle stays out of Uganda.
    ("UG", None): [
        (-1.00, 33.92),                       # UG/KE/TZ lake tripoint
        (0.30, 34.02),                        # the KE lake line
        (0.463, 34.100),                      # Busia (conjoined twins
        (0.80, 34.25),                        #   unasserted)
        (1.20, 34.62),                        # Wagagai summit UG west
        (1.90, 34.78),
        (2.50, 34.90),                        # Moroto in
        (3.00, 34.75),
        (3.45, 34.42),                        # Ilemi stays out
        (3.70, 33.60),                        # SS edge (conservative)
        (3.78, 33.00),
        (3.70, 32.60),
        (3.58, 32.05),                        # the Nimule dip (SS)
        (3.70, 31.72),                        # Moyo in
        (3.60, 31.30),
        (3.55, 30.95),                        # Koboko in
        (3.20, 30.80),                        # CD edge: Arua in,
        (2.95, 30.87),                        #   Aru CD out
        (2.60, 30.90),
        (2.30, 31.10),
        (2.18, 31.35),                        # Lake Albert midline
        (1.85, 31.05),                        #   (Butiaba UG east)
        (1.50, 30.75),
        (1.15, 30.50),
        (0.90, 30.35),                        # the Semliki valley
        (0.60, 30.10),
        (0.40, 29.93),
        (0.386, 29.86),                       # Margherita peak (the
        (0.10, 29.75),                        #   border summit, UG
        (-0.20, 29.70),                       #   side); Lake Edward
        (-0.35, 29.68),                       #   midline (Beni CD W)
        (-0.60, 29.63),
        (-1.00, 29.58),
        (-1.20, 29.57),
        *_UG_RW,                              # Sabyinyo -> the Kagera
    ],                                        #   then 1S to the lake
    ("RW", None): [
        *[(la, lo) for la, lo in reversed(_UG_RW)],
        (-1.45, 29.45),                       # the Virunga chain SW
        (-1.58, 29.30),
        (-1.674, 29.241),                     # Goma CD / Gisenyi RW
        (-1.90, 29.16),                       # Lake Kivu: the border
        (-2.10, 29.13),                       #   runs EAST of
        (-2.30, 29.05),                       #   Congolese Idjwi
        (-2.475, 28.888),                     # Bukavu CD / Kamembe RW
        (-2.62, 28.905),                      # the Ruzizi
        (-2.70, 28.98),                       # BI tripoint region
        (-2.75, 29.30),                       # BI edge (conservative,
        (-2.80, 29.60),                       #   dead strip): Butare
        (-2.72, 29.90),                       #   RW north
        (-2.60, 30.00),
        (-2.40, 30.15),                       # Burundi's bulge south
        (-2.34, 30.30),
        (-2.40, 30.45),
        (-2.42, 30.55),                       # BI/TZ tripoint region
        (-2.10, 30.85),                       # the Kagera (TZ east):
        (-1.60, 30.83),                       #   Akagera park in
        (-1.30, 30.70),
        (-1.06, 30.50),
    ],
    ("BI", None): [
        (-2.74, 29.01),                       # the Ruzizi NW corner
        (-2.80, 29.32),                       # RW edge (conservative
        (-2.86, 29.60),                       #   south of RW's line)
        (-2.78, 29.92),
        (-2.64, 30.00),
        (-2.44, 30.15),                       # Kirundo in (the bulge)
        (-2.46, 30.30),
        (-2.47, 30.53),
        (-3.00, 30.62),                       # TZ edge (conservative)
        (-3.40, 30.72),
        (-3.78, 30.50),
        (-4.10, 30.25),
        (-4.45, 29.93),                       # the southern tip
        (-4.44, 29.70),                       # Nyanza-Lac shore in
        (-4.30, 29.42),                       # Lake Tanganyika
        (-3.90, 29.30),                       #   midline: Bujumbura
        (-3.60, 29.22),                       #   east in, Uvira CD
        (-3.20, 29.21),                       #   west out
        (-2.95, 29.05),
    ],
    # --- The Horn and the Arabian south (round 4o).  OM YE DJ ER SO
    # are all anchor-less (Asia/Dubai's merged row swallowed Muscat;
    # Africa/Nairobi's swallowed the Horn), so Muscat resolved to the
    # UAE and Hargeisa/Asmara to Ethiopian anchors.  The OM/SA and
    # OM/YE edges keep dead strips against the existing SA ring's
    # conservative diagonals; Musandam and Socotra are their own
    # rings; the Bab-el-Mandeb midline splits Perim YE from Ras
    # Siyyan DJ; the 1998-arbitration Hanish islands resolve Yemeni
    # and EEBC-final Badme Eritrean; the ET/SO provisional straight
    # lines (the 8N-48E apex to Ferfer to Dolo) and the KE/SO line
    # are conservative inside Somalia.  Concessions: Madha, Abd al
    # Kuri, Ras Doumeira (disputed), Beled Hawo (tripoint-tight).
    ("OM", None): [
        (24.97, 56.38),                       # Khatmat Malaha coast
        (24.90, 56.30),
        (24.75, 56.22),                       # the Hatta AE wrap
        (24.72, 56.10),
        (24.50, 55.85),
        (24.255, 55.775),                     # Buraimi OM / Al Ain AE
        (24.00, 55.70),
        (23.00, 55.55),
        (22.50, 55.35),                       # SA diagonal dead strip
        (21.00, 54.00),
        (19.30, 52.45),
        (19.05, 52.15),                       # the 19N/52E tripoint
        (17.80, 52.60),                       # YE diagonal (own side)
        (16.68, 53.13),                       # coast (Hawf YE west)
        (16.80, 53.80),
        (16.90, 54.10),                       # Salalah in
        (17.80, 56.50),                       # Arabian Sea envelope
        (19.00, 58.00),                       #   (Masirah in)
        (20.20, 59.00),
        (22.30, 60.00),                       # Sur in
        (23.80, 59.00),
        (25.00, 57.00),                       # Gulf of Oman midline
        (25.20, 56.40),                       # Fujairah AE stays west
    ],
    ("OM", "Musandam"): [                     # the exclave past the
        (26.50, 56.05), (26.50, 56.55),       #   AE east coast
        (25.95, 56.45), (25.95, 56.05)],      #   (Khasab in)
    ("YE", None): [
        (16.25, 42.45),                       # Red Sea (SA edge N)
        (15.60, 42.30),                       # Kamaran in
        (14.50, 42.45),
        (13.75, 42.60),                       # Hanish islands in
        (13.00, 42.95),                       # Assab ER stays west
        (12.55, 43.25),
        (12.52, 43.42),                       # Bab-el-Mandeb: Perim
        (12.40, 43.55),                       #   in, Ras Siyyan DJ out
        (12.30, 44.50),                       # Gulf of Aden envelope
        (12.50, 45.20),                       # Aden in
        (13.50, 48.00),
        (14.80, 50.50),                       # Mukalla in
        (15.80, 52.40),
        (16.55, 52.95),                       # OM diagonal (own side)
        (17.70, 52.45),
        (18.95, 52.05),                       # the 19N/52E corner
        (17.20, 47.60),                       # SA edge (dead strip)
        (16.85, 46.30),
        (17.05, 45.30),
        (17.15, 44.30),                       # Saada in
        (16.75, 43.10),
        (16.30, 42.78),                       # south of SA's corner
    ],
    ("YE", "Socotra"): [
        (12.80, 53.20), (12.80, 54.60),
        (12.25, 54.60), (12.25, 53.20)],
    ("DJ", None): [
        (12.42, 43.00),
        (12.50, 43.35),                       # Ras Siyyan (vs Perim)
        (12.10, 43.47),
        (11.80, 43.52),                       # Obock in
        (11.50, 43.42),                       # Zeila SO stays south
        (11.47, 43.27),                       # Loyada (city in)
        (11.10, 42.92),
        (10.93, 42.65),                       # Ali Sabieh in
        (11.00, 42.30),
        (11.40, 41.85),                       # ET edge (conservative)
        (11.75, 41.80),
        (12.15, 42.00),
    ],
    ("ER", None): [
        (17.90, 38.62),                       # Ras Kasar (SD coast N)
        (18.10, 39.20),                       # Red Sea envelope
        (17.50, 40.20),                       #   (Dahlak in)
        (16.30, 41.20),
        (15.20, 42.00),
        (14.20, 42.40),
        (13.40, 42.58),                       # YE midline west side
        (13.00, 42.80),                       # Assab in
        (12.60, 43.10),                       # Doumeira conceded
        (12.75, 42.60),
        (13.20, 41.80),                       # ET edge (conservative)
        (13.80, 41.20),
        (14.20, 40.90),
        (14.45, 40.25),                       # Dallol ET stays south
        (14.55, 39.50),                       # Senafe in, Zalambessa
        (14.52, 38.35),                       #   ET out (unasserted)
        (14.60, 37.88),                       # Badme in (EEBC final)
        (14.27, 37.60),
        (14.25, 37.10),                       # the Tekeze reach
        (14.32, 36.60),                       # Humera ET south
        (15.10, 36.58),                       # Teseney in, Kassala
        (15.45, 36.55),                       #   SD west
        (16.00, 36.80),
        (16.50, 37.20),
        (17.00, 37.80),
        (17.50, 38.30),
    ],
    ("SO", None): [
        (11.42, 43.48),                       # Zeila in (DJ northwest)
        (10.90, 43.05),
        (10.60, 43.10),
        (9.40, 43.65),                        # the Somaliland/ET line
        (9.10, 45.00),                        #   (Jijiga ET west,
        (8.60, 46.80),                        #   Hargeisa SO east)
        (7.90, 47.95),                        # the 8N/48E apex
        (6.50, 46.55),                        # the apex-Ferfer line
        (5.15, 45.20),                        # Beledweyne SO in
        (4.52, 43.60),                        # the Ferfer-Dolo line
        (4.10, 42.25),
        (3.98, 41.95),                        # the KE tripoint region
        (1.50, 41.90),                        # the KE straight line
        (0.00, 41.78),                        #   (own side, strip)
        (-1.50, 41.70),
        (-1.58, 41.75),                       # Ras Kamboni region
        (-1.70, 42.00),
        (-1.20, 42.80),                       # Indian Ocean envelope
        (0.50, 43.60),                        #   (Kismayo in)
        (2.04, 45.60),                        # Mogadishu in
        (4.50, 48.20),
        (7.00, 50.20),
        (9.50, 51.60),
        (11.50, 51.50),                       # Cape Guardafui
        (12.10, 51.45),
        (11.90, 50.00),
        (11.60, 48.00),
        (11.30, 45.50),                       # Berbera in (Aden gulf
        (11.20, 44.00),                       #   midline)
    ],
    # --- Anchor-less island territories (round 4o).  Same class as
    # the Caribbean: zone1970 merged Indian/Mahe and Indian/Reunion
    # into Asia/Dubai, Mayotte/Comoros into Africa/Nairobi, the crown
    # dependencies into Europe/London, Arctic/Longyearbyen into
    # Europe/Berlin, and Christmas/Cocos into Asia/Bangkok and
    # Asia/Yangon — every one resolved to a foreign anchor before
    # these boxes.  Concessions documented per ring.
    ("SC", None): [                           # Seychelles inner
        (-4.0, 55.1), (-4.0, 56.0),           #   islands (Aldabra
        (-5.0, 56.0), (-5.0, 55.1)],          #   group conceded)
    ("RE", None): [                           # Reunion
        (-20.75, 55.10), (-20.75, 55.95),
        (-21.50, 55.95), (-21.50, 55.10)],
    ("YT", None): [                           # Mayotte (Anjouan KM
        (-12.55, 44.95), (-12.55, 45.40),     #   stays northwest)
        (-13.10, 45.40), (-13.10, 44.95)],
    ("KM", None): [                           # all three Comoros
        (-11.20, 43.10), (-11.20, 44.65),     #   (Mayotte east out)
        (-12.45, 44.65), (-12.45, 43.10)],
    ("IM", None): [                           # Isle of Man, fitted
        (54.46, -4.45),                       #   inside the GB ring's
        (54.44, -4.25),                       #   exclusion notch
        (54.12, -4.25),                       #   (Point of Ayre and
        (53.98, -4.55),                       #   the Calf in; 4-20 km
        (53.99, -4.95),                       #   water to the GB edge)
        (54.40, -4.95),
    ],
    ("GG", None): [                           # Guernsey + Alderney +
        (49.765, -2.75), (49.765, -2.12),     #   Sark + Herm (Cap de
        (49.38, -2.12), (49.38, -2.75)],      #   la Hague FR east)
    ("JE", None): [                           # Jersey (Ecrehous and
        (49.31, -2.30), (49.31, -1.97),       #   Minquiers reefs
        (49.13, -1.97), (49.13, -2.30)],      #   conceded; FR coast E)
    ("SJ", None): [                           # Svalbard + Bear Island
        (80.9, 9.0), (80.9, 34.0),            #   (Jan Mayen conceded;
        (74.0, 34.0), (74.0, 9.0)],           #   FJL RU stays east)
    ("CX", None): [                           # Christmas Island
        (-10.30, 105.45), (-10.30, 105.80),
        (-10.65, 105.80), (-10.65, 105.45)],
    ("CC", None): [                           # Cocos (Keeling)
        (-11.75, 96.75), (-11.75, 97.00),
        (-12.25, 97.00), (-12.25, 96.75)],
    # Brunei: zone1970 folds Asia/Brunei into the Asia/Kuching row,
    # so Brunei's whole territory anchor-resolved to Malaysia (Sabah,
    # 173 km) before these rings.  Two rings because Malaysia's
    # Limbang corridor splits the country and reaches Brunei Bay —
    # one polygon would claim it: the main block (Brunei-Muara /
    # Tutong / Belait, conservative Sarawak edges keeping Miri,
    # Marudi and Limbang Malaysian and the ~4.00 southern tongue
    # shortened) and Temburong as an admin-1 ring between the
    # Pandaruan and Trusan sides (Bangar in; Limbang and Lawas MY
    # out; Labuan MY stays offshore north).
    ("BN", None): [
        (4.59, 114.07),                       # coast at Sungai Tujoh
        (4.95, 114.30),                       # offshore envelope
        (5.08, 114.75),
        (5.10, 115.12),                       # off Muara (Labuan NE)
        (4.95, 115.06),                       # Brunei Bay (the Muara
        (4.88, 114.995),                      #   peninsula in)
        (4.84, 114.96),                       # BSB in, Limbang MY east
        (4.70, 114.83),
        (4.52, 114.78),
        (4.30, 114.70),
        (4.08, 114.58),                       # the southern tongue
        (4.25, 114.42),                       # Marudi MY south
        (4.40, 114.26),
        (4.52, 114.14),                       # Kuala Belait in,
    ],                                        #   Miri MY southwest
    ("BN", "Temburong"): [
        (4.82, 115.06),                       # the Pandaruan mouth
        (4.80, 115.18),
        (4.60, 115.22),                       # Trusan/Lawas MY east
        (4.42, 115.15),                       # (conservative south)
        (4.45, 115.05),
        (4.60, 115.03),                       # Limbang MY west
    ],
    # Vietnam: the CN border threads the Lao Cai/Hekou and Mong Cai/
    # Dongxing river twins, Lung Cu (the northernmost flag tower) and
    # the split Ban Gioc falls; the LA/KH edges are VN's own
    # conservative lines east of the LA/KH rings' conservative lines
    # (the documented dead-strip convention — Lao Bao and Moc Bai sit
    # inside the strip and stay anchor-resolved); the sea envelope
    # runs Tonkin (Bach Long Vi in, Hainan CN out) down the coast
    # (Ly Son, Phu Quy, Con Dao in) around the Ca Mau cape with
    # lobes for Tho Chu and Phu Quoc — the latter threaded INSIDE
    # Cambodia's wrap with a 4-6 km water gap.
    ("VN", None): [
        (22.40, 102.60),                      # CN edge (the Muong Nhe
        (22.50, 103.00),                      #   west wedge stays
        (22.505, 103.965),                    #   dead); Lao Cai VN /
        (22.70, 104.40),                      #   Hekou CN split
        (22.85, 104.80),                      # Ha Giang in (Thanh
        (23.10, 105.20),                      #   Thuy crossing dead)
        (23.375, 105.32),                     # Lung Cu flag tower
        (23.20, 105.55),
        (22.95, 105.85),
        (22.95, 106.35),
        (22.862, 106.735),                    # Ban Gioc falls (the VN
        (22.45, 106.58),                      #   viewpoint bank)
        (22.20, 106.70),
        (21.99, 106.71),                      # Dong Dang VN /
        (21.85, 107.00),                      #   Pingxiang CN
        (21.70, 107.35),
        (21.542, 107.97),                     # Mong Cai VN /
        (21.47, 108.07),                      #   Dongxing CN (Beilun)
        (21.10, 108.05),                      # Gulf of Tonkin midline
        (20.10, 107.95),                      # Bach Long Vi in
        (19.30, 107.50),
        (17.80, 107.90),                      # Hainan CN stays east
        (16.20, 108.90),
        (15.30, 109.40),                      # Ly Son in
        (13.50, 109.80),
        (12.00, 109.80),
        (10.40, 109.20),                      # Phu Quy in
        (8.40, 107.00),                       # Con Dao in
        (8.25, 104.95),
        (8.30, 104.55),                       # the Ca Mau cape
        (8.90, 103.70),
        (9.10, 103.30),                       # the Tho Chu lobe
        (9.60, 103.50),
        (10.00, 103.76),                      # the Phu Quoc lobe,
        (10.36, 103.82),                      #   inside Cambodia's
        (10.42, 104.02),                      #   wrap (4-6 km gaps)
        (10.41, 104.20),
        (10.46, 104.47),                      # Ha Tien VN in
        (10.52, 104.60),                      # KH edge (conservative,
        (10.68, 105.00),                      #   dead strip vs the KH
        (10.745, 105.12),                     #   ring): Chau Doc in
        (10.87, 105.35),
        (10.86, 105.80),
        (10.89, 106.02),
        (10.99, 106.22),                      # around the Parrot's
        (11.08, 106.23),                      #   Beak (Moc Bai in the
        (11.25, 106.08),                      #   strip), Tay Ninh in
        (11.45, 106.02),
        (11.60, 106.10),
        (11.85, 106.50),                      # Loc Ninh in
        (12.00, 106.60),
        (12.30, 107.12),                      # the Mondulkiri side
        (12.65, 107.52),
        (12.90, 107.65),
        (13.40, 107.70),
        (13.90, 107.68),                      # Pleiku in
        (14.40, 107.65),
        (14.68, 107.62),                      # LA edge (conservative):
        (15.05, 107.62),                      #   Kham Duc in
        (15.60, 107.50),
        (16.00, 107.25),                      # A Luoi in
        (16.45, 106.95),
        (16.68, 106.62),                      # Khe Sanh in (Lao Bao
        (16.90, 106.45),                      #   in the strip)
        (17.30, 106.35),                      # Dong Hoi in
        (17.70, 106.05),
        (18.00, 105.85),
        (18.40, 105.45),
        (18.75, 105.25),                      # Vinh in
        (19.20, 104.95),
        (19.60, 104.70),
        (20.00, 104.75),
        (20.40, 104.85),                      # Mai Chau in
        (20.75, 104.55),                      # (the Sam Neua wrap
        (21.00, 104.00),                      #   stays dead): Son La in
        (21.20, 103.30),
        (21.25, 102.90),                      # Dien Bien Phu in
        (21.50, 102.80),
        (21.80, 102.65),
        (22.10, 102.60),
        (22.30, 102.55),
    ],
    ("GR", "South Aegean"): [                 # Kastellorizo/Megisti:
        (36.175, 29.545), (36.175, 29.615),   #   2 km off Kas TR, so
        (36.12, 29.615), (36.12, 29.545)],    #   its nearest anchor is
                                              #   Antalya — ring it
    ("FI", None): [
        *_SE_FI,                              # Treriksroset -> the
        *_SE_FI_SEA[1:],                      #   Torne mouth; Bothnia
        (59.70, 20.50),                       # south of Aland
        (59.60, 22.00),                       # Gulf of Finland midline
        (59.70, 23.50),                       #   (Tallinn EE south)
        (59.85, 25.00),
        (60.02, 26.20),
        (60.15, 27.20),
        (60.30, 27.70),                       # the 1944 sea point
        (60.55, 27.80),                       # FI/RU (conservative:
        (60.85, 28.55),                       #   Vyborg RU east)
        (61.25, 29.90),
        (61.85, 31.10),
        (62.50, 31.40),
        (62.90, 31.25),                       # Ilomantsi FI west
        (63.35, 30.55),
        (63.90, 30.55),
        (64.30, 30.10),
        (64.70, 29.75),
        (65.10, 29.65),
        (65.50, 29.85),
        (66.15, 30.00),
        (66.45, 29.35),
        (66.90, 29.10),
        (67.40, 29.40),
        (67.80, 29.90),
        (68.15, 30.00),
        (68.30, 28.70),                       # Raja-Jooseppi reach
        (68.65, 28.50),
        *_FI_NO,                              # -> Treriksroset (closes)
    ],
    # --- Switzerland (round 4i): the FR chain, the Rhine/Lake
    # Constance midline with a tight Schaffhausen north-bank lobe
    # (the Jestetten DE salient stays west; Buesingen DE rides its
    # ("DE","Baden-Württemberg") square across the midline and the
    # Gailingen strip concedes), the Alpenrhein sharing the FL west
    # skirt with the ("LI",None) ring verbatim, the Graubuenden
    # crest, and the CH/IT chain.  Campione d'Italia is a HOLE.
    ("CH", None): [
        *_FR_CH,                              # Basel -> Mont Dolent
        *_CH_IT[1:],                          # -> Piz Lad
        *_CH_AT,                              # -> FL southeast corner
        *_LI_WEST[1:],                        # the FL skirt (LI shared)
        *_CH_AT_RHINE[1:],                    # -> the lake mouth
        *_CH_DE[1:],                          # -> Rheinfelden (Basel
    ],                                        #   closes via _FR_CH[0])
    # --- Iberia (round 4i).  Spain: the Pyrenees chains (Andorra left
    # as a dead pocket between _AD_SOUTH and the FR ring's _AD_NORTH),
    # the Mediterranean envelope with a Balearic lobe, the Gibraltar
    # isthmus cut at 36.158 (the Rock and Europa Point fall to the
    # Europe/Gibraltar anchor; La Linea and the whole Algeciras bay
    # west shore stay inside), the Strait kept north of the Morocco
    # ring, the shared La Raya chain, and the Atlantic/Biscay
    # envelope.  Ceuta and Melilla resolve by their zone1970 anchors
    # (outside every ring, same as before).
    ("ES", None): [
        *_PYRENEES_W,
        *_AD_SOUTH,
        *_PYRENEES_E[1:],                     # [0] repeats the tripoint
        (42.38, 3.38),                        # Cap de Creus offshore
        (42.20, 3.55),
        (41.70, 3.40),                        # Costa Brava offshore
        (41.25, 2.60),                        # Barcelona offshore
        (40.30, 3.50),                        # Balearic lobe north
        (40.25, 4.45),                        # Menorca east cap
        (39.60, 4.55),
        (39.30, 4.10),                        # lobe south (Mallorca in)
        (38.40, 2.60),
        (38.30, 1.10),                        # Ibiza/Formentera south
        (38.60, 0.45),                        # Cabo de la Nao offshore
        (37.90, -0.45),                       # Torrevieja offshore
        (37.30, -1.10),
        (36.55, -2.10),                       # Cabo de Gata offshore
        (36.45, -3.50),                       # Alboran edge (DZ/MA far
        (36.35, -4.60),                       #   south of this line)
        (36.25, -5.15),
        (36.18, -5.29),                       # Gibraltar cut: Med side
        (36.158, -5.333),                     # isthmus east (the Rock
        (36.158, -5.357),                     #   excluded south of
        (36.175, -5.39),                      #   36.158; La Linea in)
        (36.13, -5.435),                      # Algeciras bay west shore
        (36.04, -5.46),                       # Punta Carnero
        (35.97, -5.63),                       # Tarifa offshore (strait
        (36.00, -6.05),                       #   midline; MA ring S)
        (36.30, -6.55),                       # Cadiz offshore
        (36.70, -6.95),
        (37.00, -7.30),                       # Gulf of Cadiz
        *_ES_PT[::-1],                        # La Raya, mouth -> Minho
        (41.92, -8.94),                       # Rias Baixas offshore
        (42.10, -9.02),
        (42.40, -9.35),
        (42.80, -9.60),                       # Finisterre offshore
        (43.50, -9.60),
        (44.00, -7.90),                       # Bay of Biscay envelope
        (43.95, -6.00),
        (43.85, -4.50),
        (43.75, -3.20),
        (43.55, -2.20),
        (43.43, -1.90),                       # closes at the Bidasoa
    ],
    # Canary Islands: an exact admin-1 ring (the polygon threads
    # between the archipelago and the MA/EH coast edges, which pass
    # ~100 km east).  The Selvagens (PT, 30.1N) stay in the gap.
    ("ES", "Canary Islands"): [
        (29.60, -18.40), (29.60, -13.30), (28.60, -13.30),
        (27.90, -13.75), (27.55, -14.80), (27.55, -18.40)],
    # Llivia: the Spanish enclave inside France (Cerdanya).  Without
    # this square the nearest anchor is Europe/Andorra (37 km) — the
    # one case where the anchor fallback names a third country.  The
    # FR ring cuts a matching keyhole so no point is claimed twice.
    ("ES", "Catalonia"): [
        (42.486, 1.958), (42.486, 2.012),
        (42.444, 2.012), (42.444, 1.958)],
    # Portugal: the shared La Raya chain plus a generous Atlantic
    # envelope (Berlengas in; the Algarve edge stops at the Guadiana
    # mouth midline so the Huelva coast stays Spanish).
    ("PT", None): [
        *_ES_PT,                              # Minho -> Guadiana mouth
        (37.10, -7.46),                       # Algarve offshore
        (36.85, -7.90),
        (36.90, -8.60),
        (36.95, -9.05),                       # Cape St. Vincent
        (37.50, -9.30),                       # Atlantic offshore
        (38.40, -9.80),                       # Cabo da Roca offshore
        (39.50, -9.80),                       # Berlengas in
        (40.50, -9.40),
        (41.30, -9.20),
        (41.75, -9.00),                       # closes at the Minho
    ],
    ("PT", "Madeira"): [
        (33.25, -17.60), (33.25, -16.10),     # Porto Santo in; the
        (32.30, -16.10), (32.30, -17.60)],    #   Selvagens concede
    ("PT", "Azores"): [
        (39.90, -31.50), (39.90, -24.80),
        (36.70, -24.80), (36.70, -31.50)],
    # --- Central America (round 4p).  The isthmus anchors are one
    # per country, so every border region misresolves today: Tikal
    # and Melchor de Mencos GT -> Belize, Copan Ruinas HN and
    # Esquipulas GT -> El Salvador, Ocotal NI -> Honduras, La Cruz
    # CR -> Nicaragua, David/Bocas PA -> Costa Rica.  MX-facing
    # edges reuse the MX ring verbatim; every other land border is
    # one shared chain.  Concessions documented: Cocos Island (CR,
    # 500 km offshore), the Darien edge stays conservative inside
    # Panama (Colombia unringed).
    ("GT", None): [
        *_MX_GT,                              # tripoint -> Suchiate
        (14.30, -92.35),                      # Pacific offshore
        (13.70, -91.30),
        (13.42, -90.40),                      # Monterrico offshore
        (13.55, -90.16),
        *[(la, lo) for la, lo in reversed(_GT_SV)],   # Paz -> tripoint
        *_GT_HN[::-1][1:],                    # tripoint -> Motagua
        (15.92, -88.50),                      # Amatique Bay (P. Gorda
        (15.90, -88.80),                      #   BZ north, Livingston
        *_GT_BZ[:-1],                         #   in); Sarstoon -> N
    ],
    ("BZ", None): [
        *_MX_BZ[::-1],                        # tripoint -> Bacalar
        (18.20, -87.50),                      # Ambergris offshore
        (17.20, -87.35),                      # Lighthouse Reef in
        (16.40, -87.70),
        (16.20, -88.30),                      # Gulf of Honduras
        (15.92, -88.50),                      # shared bay verts (GT)
        (15.90, -88.80),
        *_GT_BZ[:-1],                         # Sarstoon -> tripoint
    ],
    ("SV", None): [
        *_SV_HN,                              # tripoint -> Goascoran
        *_SV_HN_FONSECA[1:],                  # Meanguera in
        (12.95, -87.82),                      # Fonseca mouth
        (12.95, -88.80),                      # Pacific offshore
        (13.15, -89.80),
        (13.45, -90.20),                      # Paz mouth offshore
        *[(la, lo) for la, lo in reversed(_GT_SV)][:-1],
    ],
    ("HN", None): [
        *_GT_HN,                              # Motagua -> tripoint
        *_SV_HN[1:],                          # tripoint -> Goascoran
        *_SV_HN_FONSECA[1:],                  # El Tigre in (ICJ 1992)
        (13.05, -87.55),                      # Fonseca south vs NI
        *_HN_NI,                              # -> Cabo Gracias a Dios
        (15.25, -82.90),                      # Caribbean (Miskito
        (16.00, -82.50),                      #   Cays NI stay south)
        (17.60, -83.60),                      # Swan Islands in
        (17.60, -84.20),
        (16.80, -85.50),                      # Guanaja in
        (16.55, -86.60),                      # Roatan in
        (16.35, -87.50),                      # Utila in
        (16.00, -87.95),                      # Puerto Cortes offshore
    ],
    ("NI", None): [
        *_HN_NI[::-1],                        # Cabo -> Fonseca
        (12.93, -87.72),                      # Punta Cosiguina in
        (12.70, -87.80),
        (12.30, -87.45),                      # Corinto offshore
        (11.40, -86.40),
        (11.05, -85.95),                      # San Juan del Sur off
        *_NI_CR,                              # Salinas -> the mouth
        (11.10, -83.35),                      # Caribbean offshore
        (12.00, -82.90),                      # Corn Islands in,
        (13.00, -82.60),                      #   San Andres CO out
        (14.55, -82.55),                      # Miskito Cays in
        (14.90, -82.90),
    ],
    ("CR", None): [
        *_NI_CR[::-1],                        # mouth -> Salinas Bay
        (10.80, -86.10),                      # Guanacaste offshore
        (9.50, -85.40),                       # Nicoya offshore
        (8.90, -84.20),                       # Quepos offshore
        (8.20, -83.70),                       # Osa/Corcovado offshore
        (8.00, -83.20),
        *_CR_PA[::-1],                        # Burica -> Sixaola
        (9.68, -82.50),                       # Caribbean (Bocas PA
        (10.10, -82.85),                      #   stays south-east)
        (10.60, -83.25),
        (10.85, -83.55),
    ],
    ("PA", None): [
        *_CR_PA,                              # Sixaola -> Burica
        (7.90, -82.70),                       # Chiriqui offshore
        (7.60, -82.30),
        (7.20, -81.95),                       # Coiba in
        (7.00, -81.20),
        (6.95, -80.30),                       # Azuero offshore
        (7.05, -78.60),                       # Gulf of Panama (the
        (7.10, -78.20),                       #   Pearl Islands in)
        (7.30, -77.80),                       # Pacific Darien end
        (7.60, -77.72),                       # Darien divide
        (8.05, -77.52),                       #   (conservative inside
        (8.45, -77.45),                       #   PA; CO unringed)
        (8.683, -77.365),                     # Cape Tiburon
        (9.00, -77.80),                       # San Blas offshore
        (9.65, -78.70),
        (9.80, -79.30),                       # Colon offshore
        (9.75, -80.50),
        (9.62, -82.00),                       # Bocas offshore
        (9.70, -82.38),                       # east of CR's envelope
    ],
    # --- Hispaniola (round 4p).  One anchor per country
    # (Port-au-Prince / Santo Domingo), so the whole border belt
    # misresolved: Dajabon, Jimani, Pedernales and Banica DO all ->
    # Haiti.  The shared chain threads the twin pairs (Dajabon /
    # Ouanaminthe at ~2 km, Pedernales / Anse-a-Pitres at ~1.5 km,
    # Jimani / Malpasse between the lakes).  Navassa (US-claimed)
    # stays outside both envelopes.
    ("DO", None): [
        *_DO_HT,                              # mouth -> Pedernales
        (17.80, -71.70),                      # Cabo Rojo offshore
        (17.40, -71.55),                      # Beata in
        (17.75, -70.80),
        (17.90, -70.00),                      # Barahona offshore
        (18.00, -68.90),
        (17.95, -68.58),                      # Saona in
        (18.35, -68.15),                      # Punta Cana offshore
        (19.05, -68.20),
        (19.60, -68.85),                      # Samana offshore
        (19.95, -69.55),
        (20.20, -70.50),                      # Puerto Plata offshore
        (20.05, -71.50),                      # Monte Cristi offshore
        (19.90, -71.76),
    ],
    # --- The Levant (round 4q).  Syria and Lebanon fix three anchor
    # misresolutions (Tyre LB -> Israel, Aleppo SY -> Turkey, Latakia
    # SY -> Cyprus); Israel and Palestine (West Bank + Gaza rings)
    # split the seam that the Jerusalem anchor swallowed (Ramallah /
    # Bethlehem / Hebron -> Israel before).  Contested ground follows
    # the campaign's conventions: the 1949 lines are the borders
    # drawn (the Green Line as one shared chain threading the Wadi
    # Ara / Baqa / Tayibe / Qalqilya twins), the GOLAN IS A DEAD
    # STRIP (neither ring claims it; anchors resolve), Jerusalem
    # city rides its tzdb zone (Asia/Jerusalem) inside the corridor
    # while Ramallah/Bethlehem resolve Palestinian, and Ghajar sits
    # on the Blue Line unclaimed.  SY keeps dead strips against the
    # conservative TR/IQ/JO ring edges with sub-km threads at the
    # Harem, Kobani, Ras al-Ayn, Amuda and Qamishli border pairs.
    ("SY", None): [
        (35.88, 35.93),                       # coast at the TR border
        (35.87, 36.10),                       # (Kessab unasserted)
        (36.03, 36.40),                       # Darkush in
        (36.155, 36.46),                      # Salqin in
        (36.215, 36.52),                      # Harem thread (~1 km)
        (36.225, 36.62),
        (36.25, 36.70),                       # Bab al-Hawa east
        (36.50, 36.71),
        (36.56, 36.76),                       # Afrin in
        (36.82, 36.86),                       # Meidan Ekbis in
        (36.62, 37.05),                       # A'zaz in
        (36.60, 37.40),
        (36.66, 37.90),
        (36.825, 38.01),                      # Jarabulus in
        (36.905, 38.36),                      # Kobani in
        (36.705, 38.956),                     # Tel Abyad in
        (36.78, 39.50),
        (36.83, 39.95),
        (36.835, 40.12),                      # Ras al-Ayn/Ceylanpinar
        (36.95, 40.55),                       #   conjoined pair dead
        (37.108, 40.93),                      # Amuda thread (~400 m)
        (37.06, 41.22),                       # Qamishli in
        (37.05, 41.60),
        (37.17, 42.00),                       # the NE duck-bill:
        (37.29, 42.18),                       #   al-Malikiyah and
        (37.23, 42.30),                       #   Ain Diwar in
        (36.60, 41.40),                       # SY/IQ (dead strip vs
        (35.20, 41.10),                       #   the IQ diagonal)
        (34.45, 40.97),                       # Abu Kamal in
        (34.20, 40.20),                       # the Euphrates line
        (33.60, 38.95),
        (33.45, 38.80),                       # JO/IQ tripoint north
        (33.00, 37.65),                       # the 1931 JO line
        (32.70, 36.90),                       #   (dead strip)
        (32.63, 36.35),
        (32.605, 36.08),                      # Deraa in (Ramtha JO S)
        (32.72, 36.00),                       # the Yarmouk rim
        (33.10, 35.80),                       # Quneitra in; the Golan
        (33.42, 35.95),                       #   west stays dead
        *_LB_SY[1:],                          # Hermon -> Arida coast
        (34.66, 35.80),                       # shared marine ray (LB)
        (34.80, 35.58),                       # Med envelope (Tartus,
        (35.30, 35.45),                       #   Latakia in; east of
        (35.75, 35.70),                       #   the Cyprus ring)
    ],
    ("LB", None): [
        *_LB_SY,                              # Hermon -> Arida (S->N)
        (34.66, 35.80),                       # shared marine ray (SY)
        (34.45, 35.70),
        (34.10, 35.40),                       # Beirut offshore
        (33.60, 35.10),
        (33.05, 34.95),                       # Tyre offshore
        *_IL_LB,                              # the Blue Line W->E
        *_LB_GOLAN[1:-1],                     # up to the Hermon crest
    ],
    ("IL", None): [
        *_IL_LB,                              # the Blue Line
        (33.18, 35.60),                       # the 1949 Golan line
        (32.95, 35.63),                       #   (the Golan itself is
        (32.85, 35.67),                       #   a dead strip; the
        (32.675, 35.69),                      #   Kinneret east shore
        (32.655, 35.60),                      #   and Hamat Gader in)
        (32.62, 35.553),                      # west of the JO river
        (32.45, 35.545),                      #   edge; Beit She'an in
        (32.42, 35.54),
        *_IL_WB,                              # the Green Line
        (31.45, 35.42),                       # Dead Sea west (Masada,
        (31.20, 35.42),                       #   Ein Gedi in)
        (31.00, 35.33),                       # the Arava (dead strip
        (30.50, 35.13),                       #   vs the JO edge)
        (29.80, 35.005),
        (29.535, 34.965),                     # Eilat in (Aqaba JO E)
        (29.50, 34.925),                      # gulf head (Taba EG W)
        (29.80, 34.815),                      # the 1906 line (dead
        (30.60, 34.535),                      #   strip vs the EG
        (31.15, 34.345),                      #   edge)
        *_GAZA_FENCE[::-1],                   # around the Gaza strip
        (31.65, 34.43),                       # Med envelope
        (32.00, 34.63),
        (32.55, 34.82),                       # Tel Aviv offshore
        (32.90, 34.93),                       # Haifa offshore
    ],
    ("PS", "West Bank"): [
        *_IL_WB,                              # the Green Line (NW ->
        (31.75, 35.50),                       #   Dead Sea); then the
        (32.00, 35.51),                       #   Jordan valley west
        (32.35, 35.53),                       #   of the river (Jericho
    ],                                        #   in, dead strip vs JO)
    ("PS", "Gaza Strip"): [
        *_GAZA_FENCE,                         # coast -> Kerem Shalom
        (31.24, 34.25),                       # border kink: Rafah
        (31.325, 34.218),                     #   city (31.29, 34.24)
        (31.46, 34.32),                       #   stays inside; ~500 m
        (31.62, 34.44),                       #   dead strip vs the EG
    ],                                        #   edge the whole way
    ("HT", None): [
        *_DO_HT,                              # mouth -> Anse-a-Pitres
        (17.95, -72.10),                      # south coast offshore
        (17.95, -73.00),
        (17.90, -73.80),                      # Ile-a-Vache in
        (18.00, -74.60),                      # Tiburon offshore
        (18.45, -74.78),                      # west cape (Navassa
        (18.70, -74.60),                      #   stays outside)
        (19.40, -73.60),                      # Gulf of Gonave inside
        (19.70, -73.60),                      #   (Gonave island in)
        (19.95, -73.55),                      # Mole-St-Nicolas in
        (20.25, -73.00),                      # Tortuga in
        (20.15, -72.40),
        (19.95, -71.90),                      # Cap-Haitien offshore
    ],
}

# Enclave holes: ring -> regions it does NOT claim even though the
# polygon contains them.  Cleaner than keyhole slits for enclaves far
# from the ring path (the ACT keyhole predates this and stays as-is).
# Every hole is claimed back by a matching ring or anchor: San Marino,
# the Vatican and Monaco by their own country mini-rings (tzdata
# merged their zones, so no anchor exists), Campione d'Italia by the
# ("IT","Lombardy") square, Llivia by the ("ES","Catalonia") square.
HOLES: dict[tuple[str, str | None], list[list[tuple[float, float]]]] = {
    ("IT", None): [
        [(43.995, 12.39), (43.995, 12.525),   # San Marino
         (43.885, 12.525), (43.885, 12.39)],
        [(41.909, 12.444), (41.909, 12.461),  # Vatican City
         (41.898, 12.461), (41.898, 12.444)],
    ],
    ("CH", None): [
        [(45.975, 8.955), (45.975, 8.99),     # Campione d'Italia
         (45.952, 8.99), (45.952, 8.955)],
    ],
    ("FR", None): [
        [(42.486, 1.958), (42.486, 2.012),    # Llivia (ES enclave)
         (42.444, 2.012), (42.444, 1.958)],
        [(43.7555, 7.4395),                   # Monaco: the inland edge
         (43.7415, 7.4252),                   #   threads Beausoleil /
         (43.7325, 7.4128),                   #   Monte Carlo (a true
         (43.7258, 7.4082),                   #   border-street pair),
         (43.7165, 7.4060),                   #   La Turbie and Cap
         (43.7215, 7.4230),                   #   d'Ail stay French;
         (43.7345, 7.4395),                   #   the seaward edge
         (43.7475, 7.4485)],                  #   covers its waters
    ],
}

_GRID_DEG = 2.0
_grid: dict[tuple[int, int], list[tuple[str, str]]] | None = None


def _cell(lat: float, lon: float) -> tuple[int, int]:
    return int(lat // _GRID_DEG), int(lon // _GRID_DEG)


def _build_grid():
    global _grid
    if _grid is not None:
        return _grid
    g: dict[tuple[int, int], list[tuple[str, str]]] = {}
    for key, ring in POLYGONS.items():
        lats = [p[0] for p in ring]
        lons = [p[1] for p in ring]
        c0 = _cell(min(lats), min(lons))
        c1 = _cell(max(lats), max(lons))
        for ci in range(c0[0], c1[0] + 1):
            for cj in range(c0[1], c1[1] + 1):
                g.setdefault((ci, cj), []).append(key)
    _grid = g
    return g


def _in_ring(lat: float, lon: float,
             ring: list[tuple[float, float]]) -> bool:
    """Even-odd ray cast in the (lon, lat) plane.  Planar arithmetic is
    adequate at admin-1 scales; none of the shipped rings crosses the
    antimeridian."""
    inside = False
    n = len(ring)
    for i in range(n):
        la1, lo1 = ring[i]
        la2, lo2 = ring[(i + 1) % n]
        if (la1 > lat) != (la2 > lat):
            x = lo1 + (lat - la1) / (la2 - la1) * (lo2 - lo1)
            if lon < x:
                inside = not inside
    return inside


def claims(lat: float, lon: float) -> list[tuple[str, str | None]]:
    """Every ring that claims the point, hole-aware (the structural
    no-overlap tests assert len <= 1; lookup returns the first)."""
    out = []
    for key in _build_grid().get(_cell(lat, lon), ()):
        if _in_ring(lat, lon, POLYGONS[key]):
            if any(_in_ring(lat, lon, h) for h in HOLES.get(key, ())):
                continue
            out.append(key)
    return out


def lookup(lat: float, lon: float) -> tuple[str, str] | None:
    """(country_code, subdivision) for a point inside a shipped ring,
    else None (caller falls back to nearest-anchor).  A point inside a
    ring's HOLES entry is NOT claimed by that ring (enclaves: San
    Marino, the Vatican, Campione, Llivia)."""
    cands = _build_grid().get(_cell(lat, lon))
    if not cands:
        return None
    for key in cands:
        if _in_ring(lat, lon, POLYGONS[key]):
            if any(_in_ring(lat, lon, h) for h in HOLES.get(key, ())):
                continue
            return key
    return None
