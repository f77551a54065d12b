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

Tensor parallelism (an active mesh; ``tp`` ranks on ``"model"``), as the
decoder-only stack's: the encoder's input (frames plus positions) is cut to
this rank's sequence block and the residual streams stay sequence blocks
between layers where ``cfg.seq_shard`` and the sequence divides (else
whole), each attention and FFN entering and leaving through the
collectives of :mod:`.attention` and :mod:`.ffn`; the decoder's token
embedding and head are vocab-parallel (:func:`.transformer._embed`,
:func:`~.common.mask_vocab_pad`), its learned positions enter with
``tp_copy`` on a sequence block (each rank adds its own rows).  The
encoder states are gathered whole once for the cross-attention K/V, which
are this rank's heads where they divide.  The decode caches hold this
rank's kv heads where they divide, else all of them.  Under FSDP each
layer's FSDP-cut leaves are gathered at the top of its function (the one
remat wraps), the head where :func:`_logits` uses it.

:func:`encode` returns the encoder states whole on every rank (gathered
with ``rep_gather``, as the decoder-only stack's final states are), so
their gradient must arrive whole on every rank: a consumer whose use is
partial (heads or query rows) takes them through ``tp_copy``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.dist import collectives as coll
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
from .transformer import _embed, _norm, _remat, _seq_sharded

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
    """frames: (B, S_enc, d) stubbed frontend output -> encoder states,
    whole on every rank of an active mesh (see the module docstring)."""
    dt = torch_dtype(cfg.compute_dtype)
    b, s, _ = frames.shape
    mesh = meshlib.active_mesh()
    seq_sharded = _seq_sharded(cfg, mesh, s)
    h = frames.to(dt) + sinusoid_positions(s, cfg.d_model, frames.device).to(dt)[None]
    if seq_sharded:
        h = coll.rep_split(h, mesh, dim=1)
    h = meshlib.constraint(h, "dp", "tp" if seq_sharded else None, None)
    positions = _positions(b, s, frames.device)
    for lp in params["enc_layers"]:
        h = _remat(cfg, _enc_layer, lp, cfg, h, positions, seq_sharded)
    h = _norm(cfg, h, params["enc_norm"], seq_sharded)
    return coll.rep_gather(h, mesh, dim=1) if seq_sharded else h


def _enc_layer(lp: dict, cfg: ModelConfig, h: Tensor, positions: Tensor,
               seq_sharded: bool = False) -> Tensor:
    lp = coll.fsdp_tree(lp)
    x = _norm(cfg, h, lp["ln1"], seq_sharded)
    h = h + attn.attn_sequence(lp["attn"], cfg, x, positions, causal=False,
                               q_chunk=cfg.seq_chunk, seq_sharded=seq_sharded)
    x2 = _norm(cfg, h, lp["ln2"], seq_sharded)
    return h + ffn_apply(lp["mlp"], cfg, x2, seq_sharded=seq_sharded)


def _logits(params: dict, cfg: ModelConfig, h: Tensor, mesh) -> Tensor:
    """The head's logits of the whole decoder states ``h``; on ``mesh`` this
    rank's vocab block."""
    if mesh is not None:
        h = coll.tp_copy(h, mesh)
    return mask_vocab_pad(h @ coll.fsdp_tree(params["head"]).to(h.dtype), cfg.vocab)


def decode_train(params: dict, cfg: ModelConfig, tokens: Tensor, enc_out: Tensor) -> Tensor:
    """Teacher-forced decoder pass -> logits (B, S_dec, V); on an active
    mesh this rank's vocab block of them."""
    dt = torch_dtype(cfg.compute_dtype)
    b, s = tokens.shape
    mesh = meshlib.active_mesh()
    seq_sharded = _seq_sharded(cfg, mesh, s)
    pos = params["pos_embed"][:s].to(dt)[None]
    if mesh is None:
        h = F.embedding(tokens, params["embed"]).to(dt) + pos
    else:
        h = _embed(params, tokens, dt, mesh)
        if seq_sharded:  # this rank's rows of the positions: its use is partial
            tp, i = meshlib.model_coord(mesh)
            n = s // tp
            h = coll.sp_scatter(h, mesh) + coll.tp_copy(pos, mesh)[:, i * n:(i + 1) * n]
        else:
            h = coll.tp_sum(h, mesh) + pos
        heads = attn._heads_sharded(cfg, meshlib.model_coord(mesh)[0])
        if heads or seq_sharded:  # the cross K/V's use of the encoder states is partial
            enc_out = coll.tp_copy(enc_out, mesh)
    h = meshlib.constraint(h, "dp", "tp" if seq_sharded else None, None)
    positions = _positions(b, s, tokens.device)
    for lp in params["dec_layers"]:
        h = _remat(cfg, _dec_train_layer, lp, cfg, h, positions, enc_out, seq_sharded)
    h = _norm(cfg, h, params["dec_norm"], seq_sharded)
    if seq_sharded:
        h = coll.rep_gather(h, mesh, dim=1)
    return meshlib.constraint(_logits(params, cfg, h, mesh), "dp", None, "tp")


def _dec_train_layer(lp: dict, cfg: ModelConfig, h: Tensor, positions: Tensor,
                     enc_out: Tensor, seq_sharded: bool = False) -> Tensor:
    lp = coll.fsdp_tree(lp)
    x = _norm(cfg, h, lp["ln1"], seq_sharded)
    h = h + attn.attn_sequence(lp["self_attn"], cfg, x, positions, causal=True,
                               q_chunk=cfg.seq_chunk, seq_sharded=seq_sharded)
    xx = _norm(cfg, h, lp["lnx"], seq_sharded)
    kv = attn.cross_attn_kv(lp["cross_attn"], cfg, enc_out, seq_sharded=seq_sharded)
    h = h + attn.cross_attn(lp["cross_attn"], cfg, xx, kv, seq_sharded=seq_sharded)
    x2 = _norm(cfg, h, lp["ln2"], seq_sharded)
    return h + ffn_apply(lp["mlp"], cfg, x2, seq_sharded=seq_sharded)


class EncDecCache(NamedTuple):
    self_kv: list  # per-dec-layer attention.KVCache (this rank's kv heads where they divide)
    cross_kv: list  # per-dec-layer (k, v) from the encoder output (the same)
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
    new row in place; the length is one more.  On an active mesh the
    logits are this rank's vocab block."""
    dt = torch_dtype(cfg.compute_dtype)
    mesh = meshlib.active_mesh()
    pos_e = params["pos_embed"][cache.length][None, None, :].to(dt)
    if mesh is None:
        h = params["embed"][tokens].to(dt) + pos_e
    else:
        h = coll.tp_sum(_embed(params, tokens, dt, mesh), mesh) + pos_e
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
    return _logits(params, cfg, h, mesh), EncDecCache(new_self, cache.cross_kv, cache.length + 1)
