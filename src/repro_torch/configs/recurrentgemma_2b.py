"""RecurrentGemma-2B (Griffin) [arXiv:2402.19427; hf].

Hybrid: RG-LRU recurrent blocks + local attention, pattern (rec, rec, attn)
repeating over 26 layers.  MQA (kv=1), head_dim 256, GeGLU MLP, local window
2048.  Recurrent state is O(1) in sequence length -> long_500k eligible.
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    n_layers=26,
    d_model=2560,
    n_heads=10,
    n_kv_heads=1,
    d_ff=7680,
    vocab=256000,
    head_dim=256,
    rope_theta=1.0e4,
    norm="rmsnorm",
    act="geglu",
    block_pattern=("rec", "rec", "attn"),
    local_window=2048,
    lru_width=2560,
    scan_layers=False,     # heterogeneous pattern: loop
    source="[arXiv:2402.19427; hf]",
)
