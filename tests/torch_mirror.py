"""Running one scenario on both packages for the port's tests.

A scenario is a function run(m, *args) where `m` holds one package's
modules (`load`).  `same` runs it on the package a case was given and
on the other one, each over its own copy of any directory argument,
and requires equal results (`plain` makes them package-neutral).  The
port's copies of host code are held to exact equality this way."""
import dataclasses
import importlib
from pathlib import Path
from types import SimpleNamespace

import numpy as np

PKGS = ("rupphash_tpu", "rupphash_tpu_torch")
MODULES = {"state": "state", "engine": "grouping.engine",
           "view": "pipeline.view", "tui": "tui", "search": "search",
           "si": "search_index", "palette": "pipeline.palette",
           "hdr": "pipeline.hdr", "animated": "pipeline.animated",
           "store": "cache.store", "fileops": "utils.fileops",
           "server": "gui.server", "imaging": "gui.imaging",
           "lut": "gui.lut", "watcher": "gui.watcher",
           "config": "cache.config"}


def load(pkg: str) -> SimpleNamespace:
    mods = {k: importlib.import_module(f"{pkg}.{v}")
            for k, v in MODULES.items()}
    return SimpleNamespace(pkg=pkg, **mods)


def plain(x, root: str | None = None):
    """A package-neutral value: records become dicts, arrays their dtype,
    shape and bytes, sets sorted lists, paths strings; `root` inside a
    string becomes ROOT."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return {f.name: plain(getattr(x, f.name), root)
                for f in dataclasses.fields(x)}
    if isinstance(x, np.ndarray):
        return (str(x.dtype), x.shape, x.tobytes())
    if isinstance(x, np.generic):
        return plain(np.asarray(x), root)
    if isinstance(x, (list, tuple)):
        return [plain(v, root) for v in x]
    if isinstance(x, (set, frozenset)):
        return sorted(plain(v, root) for v in x)
    if isinstance(x, dict):
        return {k: plain(v, root) for k, v in x.items()}
    if isinstance(x, Path):
        x = str(x)
    if isinstance(x, str):
        return x.replace(root, "ROOT") if root else x
    if isinstance(x, bytes) and root:
        return x.replace(root.encode(), b"ROOT")
    if hasattr(type(x), "__slots__") and type(x).__slots__:   # hdr.Cicp
        return {k: plain(getattr(x, k), root) for k in type(x).__slots__}
    return x


def same(run, m, *args):
    """run(m, *args) and run(<the other package>, *args) give one result
    (equal under `plain`); the first is returned for the case's own
    checks.  A Path argument is a directory: each package gets its own
    subdirectory, and that path reads ROOT in the comparison."""
    partner = load(PKGS[1 - PKGS.index(m.pkg)])
    results = []
    for mm in (m, partner):
        margs = [a / mm.pkg if isinstance(a, Path) else a for a in args]
        roots = [a for a in margs if isinstance(a, Path)]
        for a in roots:
            a.mkdir(parents=True, exist_ok=True)
        got = run(mm, *margs)
        results.append((got, plain(got, str(roots[0]) if roots else None)))
    assert results[0][1] == results[1][1]
    return results[0][0]
