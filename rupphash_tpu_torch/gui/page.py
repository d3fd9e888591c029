"""The single-page GUI frontend (vanilla HTML/JS/CSS, no build step).

Renders the reference GUI's panels (gui/app.rs:2067-4151): bottom
status bar, left virtualized group list, central image with drag pan,
right GPS panel (offline canvas map: markers, ordered path lines,
fit-to-bounds — gps_map.rs:44-243,332-393), histogram overlay, EXIF
overlay, slideshow timer, 3D LUT cycle (L), per-file transforms
(state.rs FileTransform), confirm-gated delete and ignore.

THIN-CLIENT CONTRACT (round-4): this script renders; it does not
decide.  Keymap->intent resolution, zoom/overlay/sidebar state
transitions, row encoding (M/L/C<n>/! markers + colors,
gui/app.rs:3316-3410), sort cycling, and confirm handling all run
server-side (gui/server.py resolve_key + snapshot "view"/"mk"/"cls")
where the pytest socket suite drives them — the reference's
equivalents are tested Rust (gui/dialogs.rs:22, gui/app.rs:3316-3410).
Browser-only residue, all presentation: drag-pan math, slippy-tile
drawing, prompt input fields with Tab completion, the slideshow
interval timer, fullscreen, image preloading, and stepping through
already-fetched advanced-search matches.
"""

PAGE = r"""<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>rupphash_tpu</title>
<style>
:root { --bg:#101318; --fg:#cdd3dd; --dim:#7a8494; --sel:#2a3550;
        --mark:#c678dd; --link:#61afef; --ident:#98c379; --pix:#e5c07b; }
* { box-sizing:border-box; margin:0; }
body { background:var(--bg); color:var(--fg);
       font:13px/1.45 system-ui,sans-serif; height:100vh; display:flex;
       flex-direction:column; overflow:hidden; }
#main { flex:1; display:flex; min-height:0; }
#list { width:30%; overflow-y:auto; border-right:1px solid #222a36;
        user-select:none; position:relative; }
#listpad { position:relative; width:100%; }
#listwin { position:absolute; left:0; right:0; }
#center { flex:1; position:relative; background:#090b0e; min-width:0;
          overflow:hidden; }
#bg { position:absolute; inset:-4%; width:108%; height:108%;
      object-fit:cover; filter:blur(28px) brightness(0.35)
      saturate(1.15); display:none; }
#img { position:absolute; transform-origin:0 0; image-rendering:auto;
       cursor:grab; z-index:1; }
#side { width:24%; border-left:1px solid #222a36; display:flex;
        flex-direction:column; min-width:0; }
#map { width:100%; height:55%; background:#0c1016; }
#exif { flex:1; overflow-y:auto; padding:6px 8px; font-size:12px;
        white-space:pre-wrap; color:var(--dim); display:none; }
#status { height:24px; background:#161b24; border-top:1px solid #222a36;
          display:flex; align-items:center; padding:0 10px; gap:16px;
          font-size:12px; color:var(--dim); }
.ghdr { padding:0 8px; color:var(--dim); background:#151a22;
        font-weight:600; height:21px; line-height:21px;
        white-space:nowrap; overflow:hidden; }
.ghdr .lq { color:#e06c75; }
.row { padding:0 8px; cursor:pointer; display:flex; gap:6px;
       height:21px; line-height:21px; white-space:nowrap;
       overflow:hidden; text-overflow:ellipsis; }
.row.sel { background:var(--sel); }
.row.peer { background:#2a2a1e; }
.row .mk { width:3em; color:var(--dim); flex:none; font-family:monospace; }
.row.marked { color:var(--mark); }
.row.hardlink { color:var(--link); }
.row.identical { color:var(--ident); }
.row.pixid { color:var(--pix); }
.row .meta { margin-left:auto; color:var(--dim); flex:none; }
#hist { position:absolute; right:10px; top:10px; background:#0009;
        display:none; }
#palette { position:absolute; left:10px; bottom:10px; display:none;
           gap:0; height:18px; }
#palette div { width:34px; height:18px; }
#prompt { position:absolute; left:50%; top:40%;
          transform:translateX(-50%); background:#1c2330; padding:12px;
          border:1px solid #39445a; display:none; z-index:5; }
#prompt input { width:320px; background:#0d1117; color:var(--fg);
                border:1px solid #39445a; padding:4px; }
#confirm { position:absolute; left:50%; top:40%;
           transform:translateX(-50%); background:#30222a; padding:14px;
           border:1px solid #7a3a4a; display:none; z-index:5; }
#help { position:absolute; inset:10% 20%; background:#141a24ee;
        border:1px solid #39445a; padding:16px; overflow-y:auto;
        display:none; z-index:6; font-size:12px; column-count:2; }
#spin { position:absolute; left:50%; top:50%; color:var(--dim);
        transform:translate(-50%,-50%); display:none; }
</style></head><body>
<div id="main">
  <div id="list"><div id="listpad"><div id="listwin"></div></div></div>
  <div id="center">
    <img id="bg"><img id="img"><div id="spin">loading…</div>
    <canvas id="hist" width="256" height="110"></canvas>
    <div id="palette"></div>
    <div id="prompt"><div id="plabel"></div><input id="pinput"></div>
    <div id="confirm"></div>
    <div id="help"></div>
  </div>
  <div id="side"><canvas id="map"></canvas><div id="exif"></div></div>
</div>
<div id="status"><span id="st-pos"></span><span id="st-file"></span>
  <span id="st-marked"></span><span id="st-zoom"></span>
  <span id="st-msg" style="margin-left:auto"></span></div>
<script>
'use strict';
// This script is RENDERING ONLY: every state decision (keymap ->
// intent, zoom cycles, overlay modes, row encoding, sort cycling,
// confirm handling) happens server-side (gui/server.py resolve_key /
// snapshot) where pytest drives it over sockets.  What stays here is
// presentation: pan/drag math, tile drawing, prompt input fields, the
// slideshow interval timer, fullscreen, and stepping through
// already-fetched advanced-search matches.
let S = null;            // server snapshot (incl. S.view state)
let pan = {x:0, y:0}, drag = null;
let slideTimer = null;
let scanPoll = null, statusTimer = null, lastStatus = '';
let lastSun = null;   // {gi, fi, az} for the map sun indicator
let imgNatural = [0, 0];
const V = () => (S && S.view) || {};   // server-side view state

const $ = id => document.getElementById(id);
const esc = t => String(t).replace(/[&<>"']/g,
  c => ({'&':'&amp;','<':'&lt;','>':'&gt;','"':'&quot;',
         "'":'&#39;'}[c]));

const TOKEN = '__SESSION_TOKEN__';  // injected per session (CSRF gate)

async function intent(name, arg) {
  const r = await fetch('/api/intent', {method:'POST',
    headers:{'Content-Type':'application/json',
             'X-Session-Token': TOKEN},
    body:JSON.stringify({intent:name, arg:arg===undefined?null:arg})});
  S = await r.json();
  render();
  if (S.quit) {
    clearTimeout(statusTimer);
    $('st-msg').textContent = 'session ended';
  }
}

async function refresh() {
  const rev = S ? S.rev : -1;
  const r = await (await fetch('/api/state?rev=' + rev)).json();
  if (r.unchanged) {
    if (S && S.scanning) {
      clearTimeout(scanPoll);
      scanPoll = setTimeout(refresh, 500);
    }
    return;
  }
  S = r;
  render();
}

function fmtTime(mtime) {
  if (!mtime) return '';
  if (S && S.relative_times) {       // t toggle (phdupes.rs
    let d = Date.now()/1000 - mtime; // --relative-times)
    const u = [[31536000,'y'],[2592000,'mo'],[86400,'d'],
               [3600,'h'],[60,'m']];
    for (const [s2, n2] of u)
      if (d >= s2) return Math.floor(d/s2) + n2 + ' ago';
    return 'now';
  }
  const dt = new Date(mtime*1000);
  const p2 = v => String(v).padStart(2, '0');
  return `${dt.getFullYear()}-${p2(dt.getMonth()+1)}-` +
         `${p2(dt.getDate())} ${p2(dt.getHours())}:` +
         `${p2(dt.getMinutes())}`;
}

function fmtSize(n) {
  const u = ['B','KiB','MiB','GiB']; let i = 0;
  while (n >= 1024 && i < 3) { n /= 1024; i++; }
  return n.toFixed(i ? 1 : 0) + ' ' + u[i];
}

const RH = 21;           // fixed row height (virtualized list)
let dispRows = [];       // [{hdr, gi} | {gi, fi, f}]
let cursorRow = 0;

function buildRows() {
  dispRows = [];
  cursorRow = 0;
  S.groups.forEach((g, gi) => {
    dispRows.push({hdr: true, gi, g});
    g.files.forEach((f, fi) => {
      if (gi === S.cursor[0] && fi === S.cursor[1])
        cursorRow = dispRows.length;
      dispRows.push({gi, fi, f});
    });
  });
}

function renderList() {
  // windowed rendering over fixed-height rows (the reference's
  // virtualized list with cached y offsets, gui/app.rs:3080-3260)
  const list = $('list'), pad = $('listpad'), win = $('listwin');
  pad.style.height = (dispRows.length * RH) + 'px';
  const first = Math.max(0, Math.floor(list.scrollTop / RH) - 10);
  const last = Math.min(dispRows.length,
                        first + Math.ceil(list.clientHeight / RH) + 20);
  win.style.top = (first * RH) + 'px';
  win.textContent = '';
  for (let i = first; i < last; i++) {
    const r = dispRows[i];
    const d = document.createElement('div');
    if (r.hdr) {
      d.className = 'ghdr';
      d.innerHTML = esc(r.g.header) +       // server-computed header
        (r.g.low_quality ?
         ' <span class="lq">[low quality: exact match only]</span>'
         : '');
    } else {
      const {gi, fi, f} = r;
      // row class + marker column come pre-encoded from the server
      // (gui/app.rs:3316-3410 semantics, pytest-covered there)
      d.className = f.cls;
      const res = f.res ? f.res[0] + 'x' + f.res[1] : '?';
      // P cycles shown path depth (reference sidebar depth toggle)
      const pathDepth = V().path_depth || 0;
      let shown = f.name;
      if (pathDepth === 2) shown = f.path;
      else if (pathDepth === 1) {
        const parts = f.path.split('/');
        shown = parts.slice(-2).join('/');
      }
      d.innerHTML = `<span class="mk">${esc(f.mk)}</span>` +
        `<span>${esc(shown)}</span>` +
        `<span class="meta">${esc(fmtTime(f.mtime))} · ${res} · ` +
        `${fmtSize(f.size)}</span>`;
      d.title = f.path;
      d.onclick = () => selectRow(gi, fi);
      d.oncontextmenu = ev2 => { ev2.preventDefault();
                                 ctxMenu(ev2, gi, fi, f); };
    }
    win.appendChild(d);
  }
}

function scrollCursorIntoView() {
  const list = $('list');
  const y = cursorRow * RH;
  if (y < list.scrollTop || y + RH > list.scrollTop + list.clientHeight)
    list.scrollTop = Math.max(0, y - list.clientHeight / 2);
}

function render() {
  if (!S) return;
  buildRows();
  scrollCursorIntoView();
  renderList();
  const cur = current();
  if (S.scanning) {
    const [d, t] = S.scanning;
    document.title = `Scanning… ${d}/${t} - rupphash_tpu`;
    $('st-pos').textContent = `Scanning… ${d}/${t}`;
    clearTimeout(scanPoll);           // one chained poll, not N chains
    scanPoll = setTimeout(refresh, 500);
  } else {
    document.title = 'rupphash_tpu';
    $('st-pos').textContent = S.groups.length ?
      `group ${S.cursor[0]+1}/${S.groups.length}` : 'no groups';
  }
  $('st-file').textContent = cur ? cur.path : '';
  $('st-marked').textContent = S.marked ? `${S.marked} marked` : '';
  const statusKey = S.rev + '|' + (S.status || '');
  if (statusKey !== lastStatus) {        // rev-keyed: repeated
    lastStatus = statusKey;              // identical texts re-display
    $('st-msg').textContent = S.status || '';
    clearTimeout(statusTimer);           // 2 s status timeout
    if (S.status)                        // (gui/app.rs:2152-2157)
      statusTimer = setTimeout(
        () => { $('st-msg').textContent = ''; }, 2000);
  }
  $('st-zoom').textContent = V().zoom_mode || 'fit';
  if (S.pending_confirm) {
    const c = $('confirm');
    c.style.display = 'block';
    const tail = '?  y = yes, any other = no';
    c.textContent = {
      'delete': `Delete ${S.marked} marked file(s)` +
                (S.use_trash ? ' to trash' : '') + tail,
      'delete-one': 'Delete current file' +
                    (S.use_trash ? ' to trash' : '') + tail,
      'move': `Move ${S.marked} marked file(s)` + tail,
    }[S.pending_confirm] || ('Ignore whole group' + tail);
  } else $('confirm').style.display = 'none';
  loadImage();
  drawMap();
  // view-driven overlays and panels (server decides, this renders)
  const vw = V();
  $('list').style.width = [20, 30, 40, 50][vw.side_w ?? 1] + '%';
  if (vw.help_on) {
    $('help').textContent = HELP;
    $('help').style.display = 'block';
  } else $('help').style.display = 'none';
  if (vw.hist_mode) loadAnalysis();
  else { $('hist').style.display = 'none';
         $('palette').style.display = 'none'; }
  if (vw.exif_on) loadExif();
  else $('exif').style.display = 'none';
  syncSlideshow();
}

function syncSlideshow() {
  // the decision (on/off) is server view state; only the interval
  // timer lives in the browser
  const on = !!V().slideshow_on;
  if (on && !slideTimer) {
    const iv = (S.slideshow || 3) * 1000;
    slideTimer = setInterval(() => {
      if ($('prompt').style.display !== 'block') intent('next_item');
    }, iv);
  } else if (!on && slideTimer) {
    clearInterval(slideTimer);
    slideTimer = null;
  }
}

function current() {
  if (!S || !S.groups.length) return null;
  const g = S.groups[S.cursor[0]];
  return g ? g.files[S.cursor[1]] : null;
}

async function selectRow(gi, fi) {
  await intent('select', [gi, fi]);
}

let imgSeq = 0;
let imgShownUrl = null;
function loadImage() {
  const cur = current();
  const img = $('img');
  if (!cur) { img.src = ''; imgShownUrl = null; return; }
  const url = `/api/image?g=${S.cursor[0]}&f=${S.cursor[1]}&s=2048` +
              `&v=${encodeURIComponent(cur.path + cur.mtime +
                                       (cur.tf || ''))}`;
  // every render calls loadImage (marks, sort, rev bumps, watcher
  // ticks): if the same image is already shown, keep it — reloading
  // would flash the spinner and reset the user's pan position
  if (url === imgShownUrl) return;
  const seq = ++imgSeq;
  const curName = cur.name;
  const sp = $('spin');
  sp.style.display = 'block';
  sp.style.color = '';
  sp.textContent = 'loading…';
  const pre = new Image();
  pre.onload = () => {
    if (seq !== imgSeq) return;
    imgNatural = [pre.naturalWidth, pre.naturalHeight];
    img.src = pre.src;
    imgShownUrl = url;
    const bg = $('bg');
    bg.src = pre.src;                 // frosted blur backdrop
    bg.style.display = 'block';
    pan = {x:0, y:0};
    layoutImage();
    $('spin').style.display = 'none';
    preloadNeighbors();               // perform_preload analogue
  };
  pre.onerror = () => { if (seq === imgSeq) {
    // failed-image card (gui/app.rs failed_images analogue)
    $('bg').style.display = 'none';
    $('img').src = '';
    imgShownUrl = null;
    const sp = $('spin');
    sp.style.display = 'block';
    sp.style.color = '#e06c75';
    sp.textContent = 'decode failed: ' + curName;
  }};
  pre.src = url;
}

function layoutImage() {
  const c = $('center'), img = $('img');
  const cw = c.clientWidth, ch = c.clientHeight;
  const [iw, ih] = imgNatural;
  if (!iw) return;
  // zoom mode/relativity are server-side view state (W/Z/z keys cycle
  // them in gui/server.py resolve_key); this is just the layout math
  const zoomMode = V().zoom_mode || 'fit';
  let scale;
  if (zoomMode === 'fit') scale = Math.min(cw/iw, ch/ih, 2); // cap 2x
  else if (zoomMode === 'fitw') scale = cw/iw;
  else if (zoomMode === 'fith') scale = ch/ih;
  else {
    scale = {x1:1, x2:2, x4:4, x8:8}[zoomMode] || 1;
    // X: relative zoom scales from the fitted size instead of 1:1
    // pixels (gui/image.rs zoom-type toggle)
    if (V().zoom_rel) scale *= Math.min(cw/iw, ch/ih);
  }
  const w = iw*scale, h = ih*scale;
  let x = (cw-w)/2 + pan.x, y = (ch-h)/2 + pan.y;
  if (w <= cw) { x = (cw-w)/2; pan.x = 0; }
  else x = Math.min(0, Math.max(cw-w, x));
  if (h <= ch) { y = (ch-h)/2; pan.y = 0; }
  else y = Math.min(0, Math.max(ch-h, y));
  img.style.width = w+'px'; img.style.height = h+'px';
  img.style.left = x+'px'; img.style.top = y+'px';
  img.style.imageRendering = scale >= 2 ? 'pixelated' : 'auto';
  $('st-zoom').textContent = zoomMode + (V().zoom_rel ? ' rel ' : ' ') +
    Math.round(scale*100) + '%';
}

// slippy-tile cache: url -> {img, ok, failed}; loads trigger one
// coalesced redraw; failures leave the offline canvas visible
// (gps_map.rs:14-42 providers via [map_providers]/selected_provider)
const tileCache = new Map();
let tileRedraw = null;
function tileFor(url) {
  let t = tileCache.get(url);
  if (!t) {
    if (tileCache.size > 256) {
      tileCache.delete(tileCache.keys().next().value);
    }
    t = {img: new Image(), ok: false};
    t.img.onload = () => {
      t.ok = true;
      clearTimeout(tileRedraw);
      tileRedraw = setTimeout(drawMap, 60);
    };
    t.img.src = url;
    tileCache.set(url, t);
  }
  return t;
}

function drawMap() {
  const cv = $('map');
  cv.width = cv.clientWidth; cv.height = cv.clientHeight;
  const ctx = cv.getContext('2d');
  ctx.fillStyle = '#0c1016'; ctx.fillRect(0, 0, cv.width, cv.height);
  mapDistBox = null;  // reset on EVERY draw: the early returns below
                      // must not leave a stale invisible click target
  if (!V().map_mode) return;  // N: off -> markers -> markers+paths
  const md = S.map || {markers: [], order: []};
  if (!md.markers.length) {
    ctx.fillStyle = '#39445a';
    ctx.fillText('no GPS markers in group', 10, 20);
    return;
  }
  const lats = md.markers.map(m => m.lat);
  const lons = md.markers.map(m => m.lon);
  const pad = 0.15;
  let la0 = Math.min(...lats), la1 = Math.max(...lats);
  let lo0 = Math.min(...lons), lo1 = Math.max(...lons);
  const dla = Math.max(la1-la0, 0.002), dlo = Math.max(lo1-lo0, 0.002);
  la0 -= dla*pad; la1 += dla*pad; lo0 -= dlo*pad; lo1 += dlo*pad;
  let px = m => [(m.lon-lo0)/(lo1-lo0)*cv.width,
                 (la1-m.lat)/(la1-la0)*cv.height];
  if (md.tile_url) {
    // web-mercator fit + tile layer under the markers
    const d = Math.PI / 180;
    const merc = m => [(m.lon + 180) / 360,
      (1 - Math.log(Math.tan(m.lat*d) + 1/Math.cos(m.lat*d))
           / Math.PI) / 2];
    // A: zoom on the selected file's marker instead of fitting all
    const sel = V().map_focus && S ?
      md.markers.find(m => m.file === S.cursor[1]) : null;
    const ws = (sel ? [sel] : md.markers).map(merc);
    const mx0 = Math.min(...ws.map(w => w[0])),
          mx1 = Math.max(...ws.map(w => w[0]));
    const my0 = Math.min(...ws.map(w => w[1])),
          my1 = Math.max(...ws.map(w => w[1]));
    const dx = Math.max(mx1-mx0, 1e-7), dy = Math.max(my1-my0, 1e-7);
    let z = Math.floor(Math.log2(Math.min(
      cv.width / (dx * 256 * 1.4), cv.height / (dy * 256 * 1.4))));
    z = Math.max(1, Math.min(17, sel ? 16 : z));
    const sc = 256 * Math.pow(2, z), n = Math.pow(2, z);
    const ox = (mx0+mx1)/2 * sc - cv.width/2;
    const oy = (my0+my1)/2 * sc - cv.height/2;
    px = m => { const w = merc(m);
                return [w[0]*sc - ox, w[1]*sc - oy]; };
    for (let ty = Math.floor(oy/256);
         ty <= Math.floor((oy+cv.height)/256); ty++) {
      if (ty < 0 || ty >= n) continue;
      for (let tx = Math.floor(ox/256);
           tx <= Math.floor((ox+cv.width)/256); tx++) {
        const wx = ((tx % n) + n) % n;  // antimeridian wrap
        const url = md.tile_url.replace('{z}', z)
          .replace('{x}', wx).replace('{y}', ty);
        const t = tileFor(url);
        if (t.ok) ctx.drawImage(t.img, tx*256 - ox, ty*256 - oy);
      }
    }
  } else {
    // offline fallback: graticule on the dark canvas
    ctx.strokeStyle = '#1b2230';
    for (let i = 1; i < 6; i++) {
      ctx.beginPath(); ctx.moveTo(cv.width*i/6, 0);
      ctx.lineTo(cv.width*i/6, cv.height); ctx.stroke();
      ctx.beginPath(); ctx.moveTo(0, cv.height*i/6);
      ctx.lineTo(cv.width, cv.height*i/6); ctx.stroke();
    }
  }
  // ordered path lines (gps_map.rs marker plugin)
  if (V().map_mode >= 2 && md.order.length > 1) {
    ctx.strokeStyle = '#61afef88'; ctx.lineWidth = 1.5;
    ctx.beginPath();
    md.order.forEach((oi, k) => {
      const [x, y] = px(md.markers[oi]);
      k ? ctx.lineTo(x, y) : ctx.moveTo(x, y);
    });
    ctx.stroke();
    // distance labels at segment midpoints (gps_map.rs:1070-1102)
    if (md.order.length <= 9) {
      const hav = (a, b) => {
        const r = 6371, d = Math.PI / 180;
        const dp = (b.lat - a.lat) * d, dl = (b.lon - a.lon) * d;
        const h = Math.sin(dp/2)**2 + Math.cos(a.lat*d) *
                  Math.cos(b.lat*d) * Math.sin(dl/2)**2;
        return 2 * r * Math.asin(Math.sqrt(h));
      };
      ctx.fillStyle = '#7a8494'; ctx.font = '10px system-ui';
      for (let k = 1; k < md.order.length; k++) {
        const a = md.markers[md.order[k-1]],
              b = md.markers[md.order[k]];
        const km = hav(a, b);
        const [x1, y1] = px(a), [x2, y2] = px(b);
        const label = km >= 1 ? km.toFixed(1) + ' km'
                              : (km * 1000).toFixed(0) + ' m';
        ctx.fillText(label, (x1+x2)/2 + 4, (y1+y2)/2 - 4);
      }
    }
  }
  md.markers.forEach((m, i) => {
    const [x, y] = px(m);
    const sel = m.file === S.cursor[1];
    ctx.fillStyle = sel ? '#e5c07b' : '#c678dd';
    ctx.beginPath(); ctx.arc(x, y, sel ? 6 : 4, 0, 7); ctx.fill();
    // sun-direction ray at the selected marker
    // (gps_map.rs:656-1069 indicator)
    if (sel && lastSun && lastSun.gi === S.cursor[0] &&
        lastSun.fi === m.file) {
      const a = (lastSun.az - 90) * Math.PI / 180;  // az 0 = north/up
      ctx.strokeStyle = '#e5c07b'; ctx.lineWidth = 2;
      ctx.beginPath(); ctx.moveTo(x, y);
      ctx.lineTo(x + 18 * Math.cos(a), y + 18 * Math.sin(a));
      ctx.stroke();
    }
  });
  // config [locations] markers (the reference's location selector,
  // gui/app.rs:3885-3912) — green diamonds, selected one highlighted
  (md.locations || []).forEach(L => {
    const [x, y] = px(L);
    if (x < -20 || y < -20 || x > cv.width+20 || y > cv.height+20)
      return;
    const sel = L.name === md.selected_location;
    ctx.fillStyle = sel ? '#98c379' : '#98c37977';
    ctx.beginPath();
    ctx.moveTo(x, y-6); ctx.lineTo(x+5, y); ctx.lineTo(x, y+6);
    ctx.lineTo(x-5, y); ctx.closePath(); ctx.fill();
    ctx.fillStyle = '#98c379';
    ctx.fillText(L.name, x + 7, y + 3);
  });
  // distance/bearing readout (gui/app.rs:918-960; b cycles the
  // location, B or a click on the text toggles the direction —
  // the click target box is remembered for the canvas handler)
  if (md.distance) {
    ctx.fillStyle = '#e5c07b'; ctx.font = '11px system-ui';
    ctx.fillText(md.distance, 8, 14);
    mapDistBox = [0, 0, 16 + ctx.measureText(md.distance).width, 20];
  }
  ctx.fillStyle = '#7a8494';
  ctx.fillText(`${md.markers.length} marker(s)`, 8, cv.height-8);
}

let mapDistBox = null;  // [x, y, w, h] of the distance readout
$('map').addEventListener('click', ev => {
  // click-to-toggle direction (gui/app.rs:2660-2671) — pure event
  // forwarding, the server owns the state
  if (!mapDistBox) return;
  const r = $('map').getBoundingClientRect();
  const x = ev.clientX - r.left, y = ev.clientY - r.top;
  if (x >= mapDistBox[0] && x <= mapDistBox[0] + mapDistBox[2] &&
      y >= mapDistBox[1] && y <= mapDistBox[1] + mapDistBox[3])
    intent('map_direction');
});

let histSeq = 0, exifSeq = 0;   // per-panel so one panel's fetch never supersedes the other's
async function loadAnalysis() {
  const seq = ++histSeq;
  const r = await fetch(`/api/analysis?g=${S.cursor[0]}&f=${S.cursor[1]}`);
  if (!r.ok || seq !== histSeq) return;  // a newer histogram request superseded us
  const a = await r.json();
  const cv = $('hist'); cv.style.display = 'block';
  const ctx = cv.getContext('2d');
  ctx.clearRect(0, 0, 256, 110);
  ctx.fillStyle = '#0009'; ctx.fillRect(0, 0, 256, 110);
  const series = V().hist_mode === 1
    ? [['#cdd3dd', a.luma]]
    : [['#cdd3dd', a.okl], ['#98c379', a.oka], ['#61afef', a.okb]];
  for (const [color, h] of series) {
    const mx = Math.max(...h, 1);
    ctx.strokeStyle = color; ctx.beginPath();
    h.forEach((v, i) => {
      const y = 105 - v/mx*95;
      i ? ctx.lineTo(i, y) : ctx.moveTo(i, y);
    });
    ctx.stroke();
  }
  const pal = $('palette');
  pal.style.display = 'flex'; pal.textContent = '';
  (a.palette || []).forEach(rgb => {
    const d = document.createElement('div');
    d.style.background = `rgb(${rgb[0]},${rgb[1]},${rgb[2]})`;
    pal.appendChild(d);
  });
}

async function loadExif() {
  const seq = ++exifSeq;
  const reqGi = S.cursor[0], reqFi = S.cursor[1];
  const r = await fetch(`/api/exif?g=${reqGi}&f=${reqFi}`);
  if (seq !== exifSeq) return;   // a newer EXIF request superseded us
  const e = $('exif');
  e.style.display = 'block';
  if (!r.ok) { e.textContent = 'EXIF unavailable'; return; }
  const x = await r.json();
  let t = '';
  if (x.width) t += `Dimensions  ${x.width} x ${x.height}\n`;
  if (x.gps) {
    if (S.decimal_coords === false) {
      const dms = (v, pos, neg) => {
        const h = v >= 0 ? pos : neg, a = Math.abs(v);
        const d = Math.floor(a), m = Math.floor((a-d)*60);
        const sec = ((a-d)*3600 - m*60).toFixed(1);
        return `${d}°${m}'${sec}\"${h}`;
      };
      t += `GPS         ${dms(x.gps[0],'N','S')} ` +
           `${dms(x.gps[1],'E','W')}\n`;
    } else {
      t += `GPS         ${x.gps[0].toFixed(5)}, ` +
           `${x.gps[1].toFixed(5)}\n`;
    }
  }
  if (x.altitude != null) t += `Altitude    ${x.altitude.toFixed(1)} m\n`;
  if (x.timestamp) t += `Taken       ` +
    new Date(x.timestamp*1000).toISOString() + `\n`;
  if (x.sun && x.sun.sun_altitude !== undefined) {
    t += `Sun         alt ${x.sun.sun_altitude}°  ` +
         `az ${x.sun.sun_azimuth}°\n`;
    lastSun = {gi: reqGi, fi: reqFi,   // the REQUESTED file's sun —
               az: x.sun.sun_azimuth}; // not whatever is now selected
    drawMap();
  }
  if (x.location && x.location.country)
    t += `Location    ${x.location.country}\n`;
  if (x.location && x.location.timezone)
    t += `Timezone    ${x.location.timezone}\n`;
  if (x.pdq_quality != null)
    t += `PDQ quality ${x.pdq_quality}/100\n`;
  t += '\n';
  const pref = x.preferred || [];
  const entries = Object.entries(x.tags || {});
  entries.sort((a, b) => {
    const ia = pref.indexOf(a[0]), ib = pref.indexOf(b[0]);
    const ra = ia < 0 ? pref.length : ia, rb = ib < 0 ? pref.length : ib;
    return ra - rb || a[0].localeCompare(b[0]);
  });
  for (const [k, v] of entries) t += `${k}  ${v}\n`;
  e.textContent = t;
}

function preloadNeighbors() {   // gui/app.rs:1686 perform_preload
  if (!S || !S.groups.length) return;
  const PRELOAD = Math.max(1, Math.min(S.preload_count || 8, 16));
  const flat = [];
  S.groups.forEach((g, gi) => g.files.forEach((f, fi) =>
    flat.push([gi, fi, f])));
  const at = flat.findIndex(([gi, fi]) =>
    gi === S.cursor[0] && fi === S.cursor[1]);
  for (let d = -PRELOAD; d <= PRELOAD; d++) {
    const i = at + d;
    if (d === 0 || i < 0 || i >= flat.length) continue;
    const [gi, fi, f] = flat[i];
    new Image().src =
      `/api/image?g=${gi}&f=${fi}&s=2048&v=` +
      encodeURIComponent(f.path + f.mtime);
  }
}

let advMatches = [], advAt = -1;
async function advSearch(q) {
  const r = await fetch('/api/search?q=' + encodeURIComponent(q));
  if (!r.ok) return;
  advMatches = (await r.json()).matches || [];
  advAt = -1;
  $('st-msg').textContent = `${advMatches.length} match(es)`;
  if (advMatches.length) advStep(1);
}
async function advStep(dir) {
  if (!advMatches.length) return;
  advAt = (advAt + dir + advMatches.length) % advMatches.length;
  const [gi, fi] = advMatches[advAt];
  await selectRow(gi, fi);
  $('st-msg').textContent =
    `match ${advAt+1}/${advMatches.length}`;
}

// ---------------- prompts --------------------------------------------
let promptCb = null, promptPaths = false;
function prompt2(label, cb, preset, paths) {
  $('plabel').textContent = label;
  const inp = $('pinput');
  inp.value = preset || '';
  $('prompt').style.display = 'block';
  inp.focus();
  promptCb = cb;
  promptPaths = !!paths;
}
$('pinput').addEventListener('keydown', async ev => {
  ev.stopPropagation();
  if (ev.key === 'Enter') {
    const v = $('pinput').value;
    $('prompt').style.display = 'none';
    if (promptCb) promptCb(v);
  } else if (ev.key === 'Escape') {
    $('prompt').style.display = 'none';
  } else if (ev.key === 'Tab' && promptPaths) {
    ev.preventDefault();  // Tab path completion (ui.rs:102-432)
    const inp = $('pinput');
    const r = await fetch('/api/complete?prefix=' +
                          encodeURIComponent(inp.value));
    const c = (await r.json()).completions || [];
    if (c.length === 1) inp.value = c[0];
    else if (c.length > 1) {
      let common = c[0];
      for (const x of c)
        while (!x.startsWith(common))
          common = common.slice(0, -1);
      if (common.length > inp.value.length) inp.value = common;
      $('st-msg').textContent = c.slice(0, 8).map(
        x => x.split('/').filter(Boolean).pop()).join('  ');
    }
  }
});

const HELP = `rupphash_tpu viewer keys
↑/↓ or j/k   next / previous file
←/→          previous / next group   ]/[  next/prev distance band
PgUp/PgDn    page      Home/End  first / last
Space        mark      g  mark group    u  unmark all
d            delete marked (confirm y/n)
x / X        ignore file / group
m            move marked to target dir   c  set move target
C            change viewed directory (view mode)
r            rename current file
/            filename regex search   n/p next/prev match
f            advanced search (EXIF/geo/regex)   F  fullscreen
s            cycle sort order        t  relative times
W            zoom fit cycle  Z  1:1/2x/4x/8x cycle
z            zoom levels absolute (1:1 px) vs relative to fit
I            histogram off/luma/Oklab   E  EXIF overlay
N            map off/markers/paths      G  sun via GPS-UTC/camera clock
A            map: fit all markers vs zoom on selected
b / B        cycle map location / toggle distance direction
P            sidebar path depth   < / >  sidebar width
.            go up one directory (view mode)
L            cycle 3D LUT
R / H / V    rotate 90° cw / flip horizontal / vertical
0            reset transform   Delete  delete current file (confirm)
right-click  row menu: rename / copy path / delete
T            slideshow    ?  this help    Q  quit`;

// right-click context menu on list rows (gui/app.rs context menu:
// Rename / Copy full path / Delete)
let ctxEl = null;
function closeCtx() { if (ctxEl) { ctxEl.remove(); ctxEl = null; } }
function ctxMenu(ev, gi, fi, f) {
  closeCtx();
  selectRow(gi, fi);
  const m = document.createElement('div');
  m.style.cssText = 'position:fixed;z-index:40;background:#141a24;' +
    'border:1px solid #2a3344;border-radius:4px;padding:4px 0;' +
    `left:${ev.clientX}px;top:${ev.clientY}px;min-width:150px`;
  const items = [
    ['Rename', () => prompt2('Rename to:',
                             v => intent('submit_rename', v), f.name)],
    ['Copy full path', () => {
      if (navigator.clipboard)
        navigator.clipboard.writeText(f.path).catch(() => {});
    }],
    ['Delete', () => intent('delete_immediate')],
  ];
  for (const [label, act] of items) {
    const it = document.createElement('div');
    it.textContent = label;
    it.style.cssText = 'padding:4px 14px;cursor:pointer';
    it.onmouseenter = () => it.style.background = '#1d2636';
    it.onmouseleave = () => it.style.background = '';
    it.onclick = () => { closeCtx(); act(); };
    m.appendChild(it);
  }
  document.body.appendChild(m);
  ctxEl = m;
}
document.addEventListener('click', closeCtx);

// Thin keymap forwarder: the server decides what every key DOES
// (gui/server.py resolve_key, pytest-covered); this handler only
// forwards the raw key and performs the returned rendering ops.
async function sendKey(k) {
  const r = await fetch('/api/key', {method:'POST',
    headers:{'Content-Type':'application/json',
             'X-Session-Token': TOKEN},
    body: JSON.stringify({key: k})});
  const resp = await r.json();
  if (resp.snapshot) { S = resp.snapshot; render(); }
  if (S && S.quit) {
    clearTimeout(statusTimer);
    $('st-msg').textContent = 'session ended';
  }
  const ui = resp.ui;
  if (!ui) return;
  if (ui.op === 'fullscreen') {
    document.fullscreenElement ? document.exitFullscreen()
      : document.documentElement.requestFullscreen();
  } else if (ui.op === 'search_step') {
    // stepping an already-fetched advanced-search list is client
    // render state; with none loaded, fall back to the search intents
    if (advMatches.length) await advStep(ui.dir);
    else await intent(ui.dir > 0 ? 'next_search' : 'prev_search');
  } else if (ui.op === 'prompt') {
    if (ui.reset_adv) advMatches = [];
    if (ui.kind === 'adv') prompt2(ui.label, v => advSearch(v));
    else prompt2(ui.label, v => intent(ui.intent, v), ui.preset,
                 ui.paths);
  }
}

document.addEventListener('keydown', async ev => {
  if (ev.target.tagName === 'INPUT') return;
  if (['Shift','Control','Alt','Meta','CapsLock'].includes(ev.key))
    return;                      // pure modifiers never act
  if ([' ','ArrowDown','ArrowUp','ArrowLeft','ArrowRight','PageDown',
       'PageUp','Home','End','/'].includes(ev.key))
    ev.preventDefault();         // keep the page from scrolling
  await sendKey(ev.key);
});

// drag pan (gui/image.rs:2430-2557 whole-area drag sense)
$('center').addEventListener('mousedown', ev => {
  drag = {x: ev.clientX, y: ev.clientY, px: pan.x, py: pan.y};
});
window.addEventListener('mousemove', ev => {
  if (!drag) return;
  pan.x = drag.px + (ev.clientX - drag.x);
  pan.y = drag.py + (ev.clientY - drag.y);
  layoutImage();
});
window.addEventListener('mouseup', () => drag = null);
window.addEventListener('resize', () => {
  layoutImage(); drawMap(); renderList();
});
$('list').addEventListener('scroll', () => renderList());

refresh();
// steady background poll; the rev short-circuit makes misses ~60 bytes
// (picks up watcher events and cross-client mutations)
setInterval(refresh, 2000);
</script></body></html>
"""
