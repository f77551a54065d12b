"""Qwen3-8B [hf:Qwen/Qwen3-8B; hf].  Dense GQA kv=8 with per-head QK-RMSNorm."""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-8b",
    family="dense",
    n_layers=36,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=12288,
    vocab=151936,
    head_dim=128,
    rope_theta=1.0e6,
    qk_norm=True,
    norm="rmsnorm",
    act="swiglu",
    source="[hf:Qwen/Qwen3-8B; hf]",
)
