"""Hand-written CUDA wire kernels for Hopper (``csrc/``), their ctypes
binding (``quant_pack.py``), plain PyTorch versions (``ref.py``) and the
dispatch layer with launch counters (``ops.py``)."""
