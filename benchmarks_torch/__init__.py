"""Benchmarks of the PyTorch/CUDA port (``src/repro_torch``); each needs a
CUDA device."""
