"""Falcon-Mamba-7B [arXiv:2410.05355; unverified].

Attention-free Mamba-1 stack: 64 layers of (in_proj -> causal conv4 -> SiLU ->
selective SSM (d_state 16) -> gate -> out_proj), d_inner = 2*d = 8192,
dt_rank = d/16 = 256.  The selective scan is a chunked associative scan
(TPU-native parallel scan; chunking bounds the (B, S_c, d_inner, d_state)
discretized-state intermediate).  O(1) decode state -> long_500k eligible.
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="falcon-mamba-7b",
    family="ssm",
    n_layers=64,
    d_model=4096,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab=65024,
    ssm_state=16,
    ssm_conv=4,
    dt_rank=256,
    expand=2,
    norm="rmsnorm",
    source="[arXiv:2410.05355; unverified]",
)
