"""Benchmark of rupphash_tpu_torch on one CUDA card (see BENCHMARK.json)."""
