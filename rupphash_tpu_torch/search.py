"""Advanced search over scanned records.

Combines the three filter families the reference's advanced-search
dialog supports (gui/dialogs.rs:1680-1921):

  * filename regex (with substring fallback)
  * EXIF/derived-tag queries through the inverted index
    (search_index.py; built from cached features)
  * geo distance filters `DistanceFrom:NAME:RANGE` /
    `distancelonlat:LON:LAT:RANGE` against config locations, with a
    slow-path fallback reading GPS straight off the records when no
    index entry exists (dialogs.rs:1921)

all AND-composed.  Returns the matching FileRecords.
"""

from __future__ import annotations

import re

from . import search_index as si
from .utils import geo


def build_index(records, store=None) -> si.SearchIndex:
    """Index records by slot == list position, using cached features
    when available plus record-level fields."""
    ix = si.SearchIndex()
    for slot, rec in enumerate(records):
        feats = None
        if store is not None and rec.content_hash:
            feats = store.get_features(rec.content_hash)
        if feats:
            tags = si.features_to_tags(feats, quality=rec.pdq_quality)
        else:
            tags = {}
            if rec.resolution:
                tags["ImageWidth"], tags["ImageHeight"] = rec.resolution
            if rec.exif_timestamp:
                tags["Timestamp"] = rec.exif_timestamp
            if rec.pdq_quality is not None:
                tags["PdqQuality"] = rec.pdq_quality
            tags["Orientation"] = rec.orientation
        ix.insert(slot, tags)
    ix.finalize()
    return ix


def search_records(records, query: str, index: si.SearchIndex | None = None,
                   locations: dict | None = None, store=None):
    """AND-composed advanced search; returns matching records.

    Query terms may be EXIF criteria (`iso:>:400`), geo filters
    (`DistanceFrom:home:25`), or bare terms (filename regex/substring).
    """
    index = index if index is not None else build_index(records, store)
    candidates = set(range(len(records)))

    exif_terms = []
    for part in re.split(r"[\s;]+", query.strip()):
        if not part:
            continue
        # ValueError (unknown location name, malformed number)
        # propagates to the caller, which surfaces it as a failed search
        gf = geo.GeoDistanceFilter.parse(part, locations)
        if gf is not None:
            hits = {i for i in candidates
                    if records[i].gps_pos is not None
                    and gf.matches(*records[i].gps_pos)}
            candidates &= hits
            continue
        head = part.split(":", 1)[0]
        if si.resolve_tag_name(head) is not None and ":" in part:
            exif_terms.append(part)
            continue
        # bare term: filename regex, substring fallback
        try:
            rx = re.compile(part, re.IGNORECASE)
            match = lambda n: rx.search(n) is not None
        except re.error:
            low = part.lower()
            match = lambda n: low in n.lower()
        candidates &= {i for i in candidates
                       if match(records[i].path.name)}

    if exif_terms:
        candidates &= index.search(" ".join(exif_terms))
    return [records[i] for i in sorted(candidates)]
