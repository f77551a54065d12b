"""OLMo-1B [arXiv:2402.00838; hf].

Non-parametric LayerNorm (no scale/bias), SwiGLU, RoPE, tied embeddings.
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="olmo-1b",
    family="dense",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=8192,
    vocab=50304,
    head_dim=128,
    rope_theta=1.0e4,
    norm="layernorm_np",
    act="swiglu",
    tie_embeddings=True,
    source="[arXiv:2402.00838; hf]",
)
