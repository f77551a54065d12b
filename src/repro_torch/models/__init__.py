"""LM substrate: composable blocks + the Model facade.

Port of ``repro.models`` for the families whose layers are all attention:
``dense`` and ``vlm`` (text-only, with M-RoPE).  The MoE, SSM, hybrid and
enc-dec families raise ``NotImplementedError`` where a model of theirs
would be built.
"""

from .model import Model, build_model, cross_entropy

__all__ = ["Model", "build_model", "cross_entropy"]
