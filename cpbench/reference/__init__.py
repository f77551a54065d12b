"""The plain side of the benchmark: data synthesis and a float64 CP-ALS.

Imports ``torch`` alone: neither ``jax``, nor the JAX package ``repro``,
nor anything of the port ``repro_torch``.
"""
