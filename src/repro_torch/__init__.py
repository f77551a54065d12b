"""repro_torch: the PyTorch/CUDA port of ``repro``'s MTTKRP/CP-ALS path.

Mirrors ``src/repro/``'s layout and public names module for module; the
JAX package stays the reference the port is tested against.  This package
imports ``torch`` and numpy, never ``jax`` and nothing of ``repro``.
"""
