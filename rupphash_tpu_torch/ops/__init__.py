"""Hash kernels: PDQ and Hamming edge search, CUDA kernels with plain
PyTorch versions beside them."""
