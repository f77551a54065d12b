"""Whisper-base backbone [arXiv:2212.04356; unverified].

Encoder-decoder; the conv1d audio frontend is a STUB per the brief --
input_specs() provides precomputed frame embeddings (B, S, d_model) for the
encoder plus decoder token ids.  Bidirectional encoder self-attention,
causal decoder self-attention + cross-attention, GELU MLP, LayerNorm,
sinusoidal (enc) / learned (dec) absolute positions.
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-base",
    family="encdec",
    n_layers=12,           # 6 encoder + 6 decoder
    enc_layers=6,
    dec_layers=6,
    d_model=512,
    n_heads=8,
    n_kv_heads=8,
    d_ff=2048,
    vocab=51865,
    head_dim=64,
    norm="layernorm",
    act="gelu",
    scan_layers=False,     # shallow heterogeneous stack: loop
    source="[arXiv:2212.04356; unverified]",
)
