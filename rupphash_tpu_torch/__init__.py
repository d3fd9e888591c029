"""rupphash_tpu_torch: the duplicate-image engine on PyTorch and CUDA.

A port of `rupphash_tpu` (JAX) that runs on an NVIDIA Hopper card, with
hand-written CUDA kernels for the device work of the duplicate scan:

* PDQ hashing of u8 luma batches, fused into one kernel per image
  (ops/pdq_cuda.py, csrc/pdq.cu);
* the all-pairs Hamming count sweep and hot-row extraction of the
  grouping engine (ops/hamming_cuda.py, csrc/hamming.cu).

Every kernel has a plain PyTorch version beside it, which CPU tensors
take.  The host data plane (walk, decode, EXIF, cache) and the PDQ
golden are reused from `rupphash_tpu`'s jax-free modules, and the
cache format is shared, so the two packages read each other's caches.
"""

from rupphash_tpu import PDQ_ALGO_VERSION, __version__

__all__ = ["PDQ_ALGO_VERSION", "__version__"]
