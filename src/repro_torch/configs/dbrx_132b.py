"""DBRX-132B [hf:databricks/dbrx-base; unverified].

Fine-grained MoE: 16 experts, top-4 routing, every layer MoE (no dense FFN).
GQA kv=8, head_dim 128, LayerNorm.
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="dbrx-132b",
    family="moe",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=10752,            # per-expert FFN width
    vocab=100352,
    head_dim=128,
    rope_theta=5.0e5,
    norm="layernorm",
    act="swiglu",
    n_experts=16,
    n_experts_per_tok=4,
    d_ff_expert=10752,
    source="[hf:databricks/dbrx-base; unverified]",
)
