"""Web-native GUI viewer.

The reference's GUI is an egui/wgpu desktop app (gui/app.rs, 4160 LoC).
A TPU deployment is a headless server, so this build re-designs the
same surface as a local web app: a zero-dependency HTTP server
(gui/server.py) exposes the shared AppState (state.py) — the exact
session-state layer the TUI drives — plus the image engine
(gui/imaging.py: EXIF orientation, HDR->SDR finishing, 3D LUTs,
zoom-source downscales), histograms/palette, EXIF overlays and the GPS
map model; a single-page frontend (gui/page.py) renders the reference's
panels (virtualized group list, central image with zoom/pan cycles,
GPS map with ordered path lines, histogram/EXIF overlays, status bar)
and maps the reference's key bindings onto AppState intents.
"""
