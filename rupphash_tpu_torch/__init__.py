"""rupphash_tpu_torch: the duplicate-image engine on PyTorch and CUDA.

A port of `rupphash_tpu` (JAX) that runs on an NVIDIA Hopper card, with
hand-written CUDA kernels for the device work of the duplicate scan:

* PDQ hashing of u8 luma batches, fused into one kernel per image
  (ops/pdq_cuda.py, csrc/pdq.cu);
* the all-pairs Hamming count sweep on the int8 tensor cores and the
  hot-row extraction of the grouping engine (ops/hamming_cuda.py,
  csrc/hamming.cu).

Every kernel has a plain PyTorch version beside it, which CPU tensors
take.  The package stands alone: its host data plane (walk, decode,
EXIF, cache, native codecs) and the PDQ golden are its own copies of
the JAX package's jax-free modules, under the same sub-paths.  The
cache format and the version constants below are the JAX package's, so
the two packages read each other's caches and index files.
"""

__version__ = "0.1.0"

PDQ_ALGO_VERSION = 2  # cache-invalidation version byte, as the JAX package's

__all__ = ["PDQ_ALGO_VERSION", "__version__"]
