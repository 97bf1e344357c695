"""The benchmark of the PyTorch and CUDA port (`lookoncetohear_tpu_torch`):
one command runs one cell of `BENCHMARK.json` once (see README.md)."""
