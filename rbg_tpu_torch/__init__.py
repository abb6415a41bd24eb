"""PyTorch/CUDA port of the rbg_tpu data plane.

The JAX package ``rbg_tpu`` stays the reference; this package holds the
same serving path (paged-KV engine, llama-family model, attention ops) in
PyTorch, with the two attention kernels of that path written by hand in
CUDA C++ for Hopper (``csrc/``). It imports torch and numpy, never JAX and
never ``rbg_tpu``.
"""
