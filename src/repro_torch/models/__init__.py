"""LM substrate: composable blocks + the Model facade.

Port of ``repro.models`` for every family the reference builds: ``dense``,
``vlm`` (text-only, with M-RoPE), ``moe`` (capacity-dispatched experts),
``ssm`` (Mamba-1), ``hybrid`` (RG-LRU with local attention) and ``encdec``
(Whisper with a stubbed frontend).  On a mesh every family runs data
parallel and the attention/FFN families tensor and sequence parallel;
the MoE, SSM, RG-LRU and enc-dec layers raise on a model axis above 1.
"""

from .model import Model, build_model, cross_entropy

__all__ = ["Model", "build_model", "cross_entropy"]
