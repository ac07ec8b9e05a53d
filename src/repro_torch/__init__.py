"""PyTorch/CUDA port of the video-monitoring-queries engine.

A second package beside the JAX reference (``src/repro``), with the same
subpackages and the same module and function names.  It imports torch
and numpy only — never jax, never ``repro`` — and its Pallas kernels are
replaced by hand-written CUDA kernels for Hopper (``kernels/csrc``).
"""
