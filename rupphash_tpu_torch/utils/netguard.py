"""Shared HTTP-surface guards for the local web GUI and the serve API.

Two browser-borne attack classes apply to loopback/LAN HTTP services:

* **DNS rebinding**: a hostile page points its own DNS name at the
  service's IP and becomes same-origin with it, reading responses.
  Browsers always send the name they connected by in `Host`, so
  requiring an IP literal / localhost (plus an explicit allowlist for
  named deployments) closes the vector for every endpoint.
* **Cross-origin "simple" POSTs (CSRF)**: any webpage can fire
  form-encoded POSTs at the service without a preflight.  It cannot
  read the response, but it can MUTATE.  Browsers attach an `Origin`
  header to every cross-origin (and most same-origin) POST, while
  curl/SDK clients do not — so rejecting Origin-bearing mutation
  requests blocks browsers without breaking programmatic clients.
"""

from __future__ import annotations

import ipaddress


def host_allowed(host: str, extra_names: tuple[str, ...] = ()) -> bool:
    """True when the Host header names this service directly: an IP
    literal, localhost, or an explicitly allowlisted deployment name
    (GUI: gui/server.py round-3 gate; serve: --allow-host)."""
    name = host.rsplit(":", 1)[0] if host.count(":") <= 1 else host
    if name.startswith("[") and "]" in name:
        name = name[1:name.index("]")]
    low = name.lower()
    if low in ("localhost", ""):
        return True
    if low in tuple(n.lower() for n in extra_names):
        return True
    try:
        ipaddress.ip_address(name)
        return True
    except ValueError:
        return False
