"""Qwen1.5/2-MoE-A2.7B [hf:Qwen/Qwen1.5-MoE-A2.7B; hf].

Fine-grained MoE: 60 routed experts top-4 (padded to 64 for EP divisibility
over the 16-way model axis; the router emits -inf for pads) plus a shared
expert of width 4x1408 = 5632 that every token uses.
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,             # per-expert (fine-grained)
    vocab=151936,
    head_dim=128,
    rope_theta=1.0e6,
    norm="rmsnorm",
    act="swiglu",
    n_experts=60,
    n_experts_per_tok=4,
    d_ff_expert=1408,
    d_ff_shared=5632,
    source="[hf:Qwen/Qwen1.5-MoE-A2.7B; hf]",
)
