"""Qwen2-VL-7B backbone [arXiv:2409.12191; hf].

VLM: the vision frontend (dynamic-resolution ViT) is a STUB per the brief --
input_specs() provides token ids plus the 3-channel M-RoPE position ids the
frontend would emit.  The backbone implements M-RoPE for real (head_dim 128,
half-dim split 16/24/24 over temporal/height/width position streams).
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-7b",
    family="vlm",
    n_layers=28,
    d_model=3584,
    n_heads=28,
    n_kv_heads=4,
    d_ff=18944,
    vocab=152064,
    head_dim=128,
    rope_theta=1.0e6,
    mrope_sections=(16, 24, 24),
    norm="rmsnorm",
    act="swiglu",
    source="[arXiv:2409.12191; hf]",
)
