"""DeepSeek-Coder-33B [arXiv:2401.14196; hf].  Llama-arch dense, GQA kv=8."""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-coder-33b",
    family="dense",
    n_layers=62,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=19200,
    vocab=32256,
    head_dim=128,
    rope_theta=1.0e5,
    norm="rmsnorm",
    act="swiglu",
    source="[arXiv:2401.14196; hf]",
)
