"""Builds the port's host C++ libraries (native/*.cpp) atomically.

g++ writes each library into build/rupphash_tpu_torch/native/ beside the
package (not next to its source) under a name of its own process, and
`os.replace` then puts the finished file in place.  A file lock in the
build directory serialises concurrent builds (parallel test workers,
spawned decode workers), so no process ever loads a half-written
library.  A library older than its source or any of its headers is
rebuilt.
"""

from __future__ import annotations

import fcntl
import os
import subprocess
from pathlib import Path

BUILD_DIR = (Path(__file__).resolve().parents[2] / "build"
             / "rupphash_tpu_torch" / "native")


def _fresh(so: Path, sources: list[Path]) -> bool:
    try:
        return so.stat().st_mtime >= max(p.stat().st_mtime for p in sources)
    except FileNotFoundError:
        return False


def ensure(src: Path, name: str, variants: list[list[str]],
           ldflags: list[str] = (), deps: list[Path] = ()) -> Path | None:
    """Path of the built library `name` for `src`, building it when
    missing or stale; None when no g++ variant compiles it.  Each entry
    of `variants` is a list of compiler flags, tried in order."""
    so = BUILD_DIR / name
    sources = [src, *deps]
    if _fresh(so, sources):
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / f"{name}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if _fresh(so, sources):   # another process built it meanwhile
            return so
        tmp = BUILD_DIR / f"{name}.{os.getpid()}.tmp"
        try:
            for flags in variants:
                cmd = ["g++", *flags, "-shared", "-fPIC", "-std=c++17",
                       str(src), "-o", str(tmp), *ldflags]
                try:
                    subprocess.run(cmd, check=True, capture_output=True,
                                   timeout=120)
                except FileNotFoundError:
                    return None
                except subprocess.SubprocessError:
                    continue
                os.replace(tmp, so)
                return so
            return None
        finally:
            tmp.unlink(missing_ok=True)
