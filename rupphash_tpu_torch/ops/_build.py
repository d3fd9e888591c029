"""Builds and loads the port's CUDA kernels (csrc/*.cu).

Each source compiles with its own nvcc process, all started together,
and the objects link into one shared library with a plain C interface,
loaded through ctypes.  The build happens at first use, into
build/rupphash_tpu_torch/ beside the package, and again whenever the
sources or the flags change (the file name carries their hash).  Every
C entry point returns cudaGetLastError() after its launch; `check`
turns a nonzero code into an exception, since a refused launch never
runs and a later synchronize would not report it.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import NamedTuple

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "rupphash_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "rupp_pdq_hash": [_P, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P],
    "rupp_pdq_coeffs": [_P, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P],
    "rupp_hamming_rowcount": [_P, _P, _P, _I, _P, _I, _I, _I, _I, _I, _P,
                              _P],
    "rupp_hamming_extract": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                             _P, _P, _P],
    "rupp_hamming_rowcount_mma": [_P, _P, _P, _I, _P, _I, _I, _I, _I, _I, _P,
                                  _P],
    "rupp_restack": [_P, _I, _I, _I, _P, _P],
}


class KernelBuildError(RuntimeError):
    pass


class Library(NamedTuple):
    lib: ctypes.CDLL
    path: Path
    build_seconds: float   # 0.0 when an up-to-date build was found


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [str(Path(cuda_home) / "bin" / "nvcc")] if cuda_home else []
    candidates += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in candidates:
        if c and Path(c).is_file():
            return c
    raise KernelBuildError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _digest(sources: list[Path]) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sources:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


_BUILD_LOCK = threading.Lock()
_COUNT_LOCK = threading.Lock()


@functools.cache
def load() -> Library:
    """Build (if needed) and load the kernel library; raises
    KernelBuildError when nvcc is missing or the build fails.  Threads
    that ask first at the same time (the HTTP service hashes on one
    thread per request) build once: the others wait and load the file."""
    with _BUILD_LOCK:
        return _build_and_load()


def _build_and_load() -> Library:
    sources = _sources()
    so = BUILD_DIR / f"librupphash_cuda_{_digest(sources)}.so"
    seconds = 0.0
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        objs = [so.with_name(f"{so.stem}.{p.stem}.{os.getpid()}.o")
                for p in sources if p.suffix == ".cu"]
        t0 = time.perf_counter()
        try:
            procs = [subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, "-c", "-o", str(o), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
                for o, src in zip(objs, (p for p in sources
                                         if p.suffix == ".cu"))]
            errs = [proc.communicate()[1] for proc in procs]
            failed = [(proc.args[-1], proc.returncode, err)
                      for proc, err in zip(procs, errs) if proc.returncode]
            if failed:
                raise KernelBuildError("nvcc failed:\n" + "\n".join(
                    f"{src} ({rc}):\n{err}" for src, rc, err in failed))
            link = subprocess.run(
                [_nvcc(), *NVCC_FLAGS, "-shared", "-o", str(tmp),
                 *map(str, objs)], capture_output=True, text=True)
            if link.returncode != 0:
                raise KernelBuildError(
                    f"nvcc link failed ({link.returncode}):\n{link.stderr}")
            os.replace(tmp, so)   # atomic: concurrent builders never load a partial file
        finally:
            tmp.unlink(missing_ok=True)
            for o in objs:
                o.unlink(missing_ok=True)
        seconds = time.perf_counter() - t0
    lib = ctypes.CDLL(str(so))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.rupp_cuda_error_string.argtypes = [ctypes.c_int]
    lib.rupp_cuda_error_string.restype = ctypes.c_char_p
    return Library(lib, so, seconds)


def count_launch(wrapper):
    """Add one to a kernel wrapper's launch count; a lock makes the
    read-modify-write safe when wrappers launch from several threads."""
    with _COUNT_LOCK:
        wrapper.launches += 1


def check(err: int, what: str):
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        msg = load().lib.rupp_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def stream_ptr(tensor) -> int:
    """Raw handle of PyTorch's current stream on the tensor's device."""
    import torch

    return torch.cuda.current_stream(tensor.device).cuda_stream


def launch(wrapper, kernel: str, entry: str, on, *args):
    """Launch through the C entry point `entry`: `args`, then the current
    stream of `on`'s device, with that device made current for the call.
    The entry points read the device from the runtime (its SM count and
    the kernel's shared-memory attribute), so without it a tensor on
    cuda:1 while cuda:0 is current would be launched on cuda:1's stream
    with cuda:0's settings.  Raises on a CUDA error, then adds one to
    `wrapper`'s launch count."""
    import torch

    with torch.cuda.device(on.device):
        err = getattr(load().lib, entry)(*args, stream_ptr(on))
    check(err, kernel)
    count_launch(wrapper)
