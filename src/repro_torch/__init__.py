"""DGL-KE training in PyTorch on an NVIDIA H100: the port of the JAX package
``repro``, module for module (``repro/X/y.py`` <-> ``repro_torch/X/y.py``).

It imports torch and numpy, never jax and nothing of ``repro``. Its entry
points run on the GPU unless the caller passes ``device="cpu"``; the kernels
on the path are hand-written CUDA (``csrc/``), each with a plain PyTorch
version that the CPU path runs.
"""
