"""H2O-Danube-3-4B [arXiv:2401.16818; unverified].

Llama+Mistral mix: dense GQA kv=8 with sliding-window attention (window 4096,
ring-buffer decode cache) -- the SWA bound makes this arch eligible for the
long_500k shape.
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="h2o-danube-3-4b",
    family="dense",
    n_layers=24,
    d_model=3840,
    n_heads=32,
    n_kv_heads=8,
    d_ff=10240,
    vocab=32000,
    head_dim=120,          # 3840 / 32
    rope_theta=1.0e4,
    sliding_window=4096,
    norm="rmsnorm",
    act="swiglu",
    source="[arXiv:2401.16818; unverified]",
)
