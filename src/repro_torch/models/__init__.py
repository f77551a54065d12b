"""LM substrate: composable blocks + the Model facade.

Port of ``repro.models`` for every family the reference builds: ``dense``,
``vlm`` (text-only, with M-RoPE), ``moe`` (capacity-dispatched experts),
``ssm`` (Mamba-1), ``hybrid`` (RG-LRU with local attention) and ``encdec``
(Whisper with a stubbed frontend).  Only the sharded LM raises: a MoE
layer or a sharding constraint on a mesh of more than one rank.
"""

from .model import Model, build_model, cross_entropy

__all__ = ["Model", "build_model", "cross_entropy"]
