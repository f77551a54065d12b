"""Whisper-style encoder-decoder backbone (whisper-base).

Port of ``repro.models.encdec``.  The conv1d audio frontend is a stub, as
in the reference: the encoder consumes precomputed frame embeddings
(B, S_enc, d).  Encoder: + sinusoidal positions, pre-LN bidirectional
self-attention + GELU MLP.  Decoder: learned positions, causal
self-attention + cross-attention + MLP.  Serving computes the
cross-attention K/V once from the encoder output and caches the decoder's
self-attention K/V step by step; the cache's length is a host int, as
:class:`.transformer.DecodeCache`'s.  Training runs each encoder and
decoder layer under :func:`.transformer._remat`, as the reference wraps it
in ``jax.checkpoint``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.launch import mesh as meshlib

from . import attention as attn
from .common import (
    ParamDef,
    mask_vocab_pad,
    norm_apply,
    norm_defs,
    sinusoid_positions,
    torch_dtype,
    vocab_padded,
)
from .ffn import ffn_apply, ffn_defs
from .transformer import _remat

Tensor = torch.Tensor

MAX_POSITIONS = 32_768  # learned decoder position table bound (covers decode_32k)


def _enc_layer_defs(cfg: ModelConfig) -> dict:
    return {
        "ln1": norm_defs(cfg.norm, cfg.d_model),
        "attn": attn.attn_defs(cfg),
        "ln2": norm_defs(cfg.norm, cfg.d_model),
        "mlp": ffn_defs(cfg),
    }


def _dec_layer_defs(cfg: ModelConfig) -> dict:
    return {
        "ln1": norm_defs(cfg.norm, cfg.d_model),
        "self_attn": attn.attn_defs(cfg),
        "lnx": norm_defs(cfg.norm, cfg.d_model),
        "cross_attn": attn.attn_defs(cfg, cross=True),
        "ln2": norm_defs(cfg.norm, cfg.d_model),
        "mlp": ffn_defs(cfg),
    }


def encdec_defs(cfg: ModelConfig) -> dict:
    v_pad = vocab_padded(cfg.vocab)  # 51865 -> 51968 for even TP shards
    return {
        "embed": ParamDef((v_pad, cfg.d_model), ("tp", None), "small"),
        "pos_embed": ParamDef((MAX_POSITIONS, cfg.d_model), (None, None), "small"),
        "enc_layers": [_enc_layer_defs(cfg) for _ in range(cfg.enc_layers)],
        "enc_norm": norm_defs(cfg.norm, cfg.d_model),
        "dec_layers": [_dec_layer_defs(cfg) for _ in range(cfg.dec_layers)],
        "dec_norm": norm_defs(cfg.norm, cfg.d_model),
        "head": ParamDef((cfg.d_model, v_pad), ("fsdp", "tp")),
    }


def _positions(b: int, s: int, device) -> Tensor:
    return torch.arange(s, dtype=torch.int32, device=device).expand(b, s)


def encode(params: dict, cfg: ModelConfig, frames: Tensor) -> Tensor:
    """frames: (B, S_enc, d) stubbed frontend output -> encoder states."""
    meshlib.require_local_tp("the enc-dec model")
    dt = torch_dtype(cfg.compute_dtype)
    b, s, _ = frames.shape
    h = frames.to(dt) + sinusoid_positions(s, cfg.d_model, frames.device).to(dt)[None]
    h = meshlib.constraint(h, "dp", None, None)
    positions = _positions(b, s, frames.device)
    for lp in params["enc_layers"]:
        h = _remat(cfg, _enc_layer, lp, cfg, h, positions)
    return norm_apply(cfg.norm, h, params["enc_norm"])


def _enc_layer(lp: dict, cfg: ModelConfig, h: Tensor, positions: Tensor) -> Tensor:
    x = norm_apply(cfg.norm, h, lp["ln1"])
    h = h + attn.attn_sequence(lp["attn"], cfg, x, positions, causal=False,
                               q_chunk=cfg.seq_chunk)
    x2 = norm_apply(cfg.norm, h, lp["ln2"])
    return h + ffn_apply(lp["mlp"], cfg, x2)


def decode_train(params: dict, cfg: ModelConfig, tokens: Tensor, enc_out: Tensor) -> Tensor:
    """Teacher-forced decoder pass -> logits (B, S_dec, V)."""
    meshlib.require_local_tp("the enc-dec model")
    dt = torch_dtype(cfg.compute_dtype)
    b, s = tokens.shape
    h = F.embedding(tokens, params["embed"]).to(dt) + params["pos_embed"][:s].to(dt)[None]
    h = meshlib.constraint(h, "dp", None, None)
    positions = _positions(b, s, tokens.device)
    for lp in params["dec_layers"]:
        h = _remat(cfg, _dec_train_layer, lp, cfg, h, positions, enc_out)
    h = norm_apply(cfg.norm, h, params["dec_norm"])
    logits = mask_vocab_pad(h @ params["head"].to(dt), cfg.vocab)
    return meshlib.constraint(logits, "dp", None, "tp")


def _dec_train_layer(lp: dict, cfg: ModelConfig, h: Tensor, positions: Tensor,
                     enc_out: Tensor) -> Tensor:
    x = norm_apply(cfg.norm, h, lp["ln1"])
    h = h + attn.attn_sequence(lp["self_attn"], cfg, x, positions, causal=True,
                               q_chunk=cfg.seq_chunk)
    xx = norm_apply(cfg.norm, h, lp["lnx"])
    kv = attn.cross_attn_kv(lp["cross_attn"], cfg, enc_out)
    h = h + attn.cross_attn(lp["cross_attn"], cfg, xx, kv)
    x2 = norm_apply(cfg.norm, h, lp["ln2"])
    return h + ffn_apply(lp["mlp"], cfg, x2)


class EncDecCache(NamedTuple):
    self_kv: list  # per-dec-layer attention.KVCache
    cross_kv: list  # per-dec-layer (k, v) from the encoder output
    length: int


def init_encdec_cache(
    params: dict, cfg: ModelConfig, enc_out: Tensor, max_len: int, dtype
) -> EncDecCache:
    b = enc_out.shape[0]
    self_kv = [attn.init_kv_cache(cfg, b, max_len, dtype, enc_out.device)
               for _ in params["dec_layers"]]
    cross_kv = [attn.cross_attn_kv(lp["cross_attn"], cfg, enc_out) for lp in params["dec_layers"]]
    return EncDecCache(self_kv, cross_kv, 0)


def decode_step(
    params: dict, cfg: ModelConfig, tokens: Tensor, cache: EncDecCache
) -> tuple[Tensor, EncDecCache]:
    """One decode step.  tokens: (B, 1).  The self-attention caches take the
    new row in place; the length is one more."""
    dt = torch_dtype(cfg.compute_dtype)
    pos_e = params["pos_embed"][cache.length][None, None, :].to(dt)
    h = params["embed"][tokens].to(dt) + pos_e
    new_self = []
    for lp, kv_c, kv_x in zip(params["dec_layers"], cache.self_kv, cache.cross_kv):
        x = norm_apply(cfg.norm, h, lp["ln1"])
        y, kv_new = attn.attn_decode(lp["self_attn"], cfg, x, kv_c, cache.length)
        h = h + y
        new_self.append(kv_new)
        xx = norm_apply(cfg.norm, h, lp["lnx"])
        h = h + attn.cross_attn(lp["cross_attn"], cfg, xx, kv_x)
        x2 = norm_apply(cfg.norm, h, lp["ln2"])
        h = h + ffn_apply(lp["mlp"], cfg, x2)
    h = norm_apply(cfg.norm, h, params["dec_norm"])
    logits = mask_vocab_pad(h @ params["head"].to(dt), cfg.vocab)
    return logits, EncDecCache(new_self, cache.cross_kv, cache.length + 1)
