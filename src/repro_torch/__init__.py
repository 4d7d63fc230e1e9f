"""PyTorch/CUDA port of the graph load-balancing engine.

The JAX package ``repro`` is the reference; this package mirrors its
module layout, imports neither ``jax`` nor ``repro``, and runs its relax
kernels as hand-written CUDA for the H100 (``kernels/csrc``).  Every entry
point takes ``device=`` (default ``"cuda"``); CPU tensors take the plain
PyTorch versions of the kernels.
"""
