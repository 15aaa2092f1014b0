"""Hand-written CUDA kernels for Hopper (sources in ``csrc/``), each with its
plain PyTorch version (``ref.py``) and a wrapper that dispatches on the
tensor's device (``ops.py``). ``build`` compiles and binds them."""
