"""Attention: GQA/MQA, RoPE / M-RoPE, QK-norm, sliding/local windows, caches.

Port of ``repro.models.attention``.  Long prefills split the query axis
into chunks; full-attention chunks score against all keys, windowed ones
(h2o-danube SWA, local attention) against a ``(window + chunk)`` key span
with a clipped start, so prefill costs O(S * window).  Decode keeps a ring
buffer of ``window`` slots when a window is set and a full cache
otherwise.

Scores are computed in the compute dtype, rounded to it, then softmaxed in
fp32, as the reference does; every product casts its weight to the
activation's dtype where it is used.  Sharding constraints are the
reference's, resolved by :func:`repro_torch.launch.mesh.constraint` (the
identity on one device).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.launch import mesh as meshlib

from .common import ParamDef, apply_mrope, apply_rope, attention_scale, rms_norm

Tensor = torch.Tensor
NEG_INF = -1.0e9  # bf16-safe large negative


# --------------------------------------------------------------------------
# Parameters
# --------------------------------------------------------------------------
def attn_defs(cfg: ModelConfig, cross: bool = False) -> dict:
    d, h, hk, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    defs = {
        "wq": ParamDef((d, h * hd), ("fsdp", "tp")),
        "wk": ParamDef((d, hk * hd), ("fsdp", "tp")),
        "wv": ParamDef((d, hk * hd), ("fsdp", "tp")),
        "wo": ParamDef((h * hd, d), ("tp", "fsdp")),
    }
    if cfg.qk_norm and not cross:
        defs["q_norm"] = ParamDef((hd,), (None,), "ones")
        defs["k_norm"] = ParamDef((hd,), (None,), "ones")
    return defs


def _split_heads(x: Tensor, n: int, hd: int) -> Tensor:
    b, s, _ = x.shape
    return x.reshape(b, s, n, hd)


def _head_axis_ok(n_heads: int) -> bool:
    """Shard a head axis only when every device gets >= 1 head."""
    return n_heads >= max(meshlib.tp_size(), 1)


def _project_q(p: dict, cfg: ModelConfig, x: Tensor, layout: str = "heads") -> Tensor:
    q = _split_heads(x @ p["wq"].to(x.dtype), cfg.n_heads, cfg.hd)
    if "q_norm" in p:
        q = rms_norm(q, p["q_norm"])
    if layout == "seq":  # sequence-parallel attention (few-head archs)
        return meshlib.constraint(q, "dp", "tp", None, None)
    if _head_axis_ok(cfg.n_heads):
        return meshlib.constraint(q, "dp", None, "tp", None)
    return meshlib.constraint(q, "dp", None, None, None)


def _project_kv(p: dict, cfg: ModelConfig, x: Tensor) -> tuple[Tensor, Tensor]:
    k = _split_heads(x @ p["wk"].to(x.dtype), cfg.n_kv_heads, cfg.hd)
    v = _split_heads(x @ p["wv"].to(x.dtype), cfg.n_kv_heads, cfg.hd)
    if "k_norm" in p:
        k = rms_norm(k, p["k_norm"])
    spec = ("dp", None, "tp", None) if _head_axis_ok(cfg.n_kv_heads) else ("dp", None, None, None)
    k = meshlib.constraint(k, *spec)
    v = meshlib.constraint(v, *spec)
    return k, v


def _rope(cfg: ModelConfig, x: Tensor, positions: Tensor) -> Tensor:
    if cfg.is_encdec:  # whisper: absolute embeddings, no rotary
        return x
    if cfg.mrope_sections:
        return apply_mrope(x, positions, cfg.mrope_sections, cfg.rope_theta)
    return apply_rope(x, positions, cfg.rope_theta)


# --------------------------------------------------------------------------
# Core scaled-dot-product with GQA grouping
# --------------------------------------------------------------------------
def _softmax_probs(scores: Tensor, mask: Tensor | None, dtype: torch.dtype) -> Tensor:
    scores = scores.float()
    if mask is not None:
        scores = scores.masked_fill(~mask, NEG_INF)
    return torch.softmax(scores, dim=-1).to(dtype)


def _attend(q: Tensor, k: Tensor, v: Tensor, mask: Tensor | None) -> Tensor:
    """q: (B,Sq,H,hd), k/v: (B,Sk,Hk,hd), mask broadcastable (B,1,1,Sq,Sk).

    With query groups (``g = H / Hk > 1``) whose kv-head axis divides the
    tensor-parallel degree -- always at one device -- the queries are
    grouped against the shared K/V; otherwise K/V are expanded to the full
    query-head count, as the reference does for its sharding.
    """
    b, sq, h, hd = q.shape
    hk = k.shape[2]
    g = h // hk
    tp = meshlib.tp_size()
    scale = attention_scale(hd, q.dtype)
    if g > 1 and hk % tp == 0:
        qg = q.reshape(b, sq, hk, g, hd)
        scores = torch.einsum("bqhgd,bkhd->bhgqk", qg, k) * scale
        probs = _softmax_probs(scores, mask, q.dtype)
        out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v)
        return out.reshape(b, sq, h, hd)
    if g > 1:  # expand kv heads
        k = torch.repeat_interleave(k, g, dim=2)
        v = torch.repeat_interleave(v, g, dim=2)
        if sq == 1:
            k = meshlib.constraint(k, "dp", "tp", None, None)
            v = meshlib.constraint(v, "dp", "tp", None, None)
        elif _head_axis_ok(h):
            k = meshlib.constraint(k, "dp", None, "tp", None)
            v = meshlib.constraint(v, "dp", None, "tp", None)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    probs = _softmax_probs(scores, None if mask is None else mask[:, :, 0], q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def _causal_mask(sq: int, sk: int, q_off: int, window: int, device=None) -> Tensor:
    """(1,1,1,sq,sk) mask; q rows are global rows q_off..q_off+sq-1, k cols
    are global cols 0..sk-1 (full) -- callers with sliced keys pass offsets."""
    i = q_off + torch.arange(sq, device=device)[:, None]
    j = torch.arange(sk, device=device)[None, :]
    m = j <= i
    if window:
        m = m & (j > i - window)
    return m[None, None, None]


# --------------------------------------------------------------------------
# Training / prefill self-attention (full sequence in, full sequence out)
# --------------------------------------------------------------------------
def attn_sequence(
    p: dict,
    cfg: ModelConfig,
    x: Tensor,
    positions: Tensor,
    *,
    causal: bool = True,
    window: int = 0,
    q_chunk: int = 0,
    return_kv: bool = False,
):
    """Self-attention over a full sequence.  Returns y [, (k, v) for caching]."""
    b, s, _ = x.shape
    # windowed attention with no explicit chunk: chunk at the window size so
    # the scores stay O(s * window) instead of O(s^2)
    if window and not q_chunk and s > window:
        q_chunk = window
    chunked = bool(q_chunk) and s > q_chunk and s % q_chunk == 0
    seq_layout = not _head_axis_ok(cfg.n_heads) and s > 1
    layout = "seq" if (seq_layout and not chunked) else "heads"
    q = _rope(cfg, _project_q(p, cfg, x, layout), positions)
    k, v = _project_kv(p, cfg, x)
    k = _rope(cfg, k, positions)

    if not chunked:
        mask = _causal_mask(s, s, 0, window, x.device) if causal else None
        y = _attend(q, k, v, mask)
    else:
        n_chunks = s // q_chunk
        span = min(s, window + q_chunk) if window else s
        ys = []
        for c in range(n_chunks):
            q_c = q[:, c * q_chunk : (c + 1) * q_chunk]
            if seq_layout:
                q_c = meshlib.constraint(q_c, "dp", "tp", None, None)
            if window and span < s:
                start = min(max(c * q_chunk + q_chunk - span, 0), s - span)
                k_c = k[:, start : start + span]
                v_c = v[:, start : start + span]
                i = (c * q_chunk + torch.arange(q_chunk, device=x.device))[:, None]
                j = (start + torch.arange(span, device=x.device))[None, :]
                m = (j <= i) & (j > i - window) if causal else (j >= 0).expand(q_chunk, span)
                ys.append(_attend(q_c, k_c, v_c, m[None, None, None]))
            else:
                m = _causal_mask(q_chunk, s, c * q_chunk, window, x.device) if causal else None
                ys.append(_attend(q_c, k, v, m))
        y = torch.cat(ys, 1)

    y = y.reshape(b, s, cfg.n_heads * cfg.hd)
    out = y @ p["wo"].to(y.dtype)
    out = meshlib.constraint(out, "dp", None, None)
    if return_kv:
        return out, (k, v)
    return out


# --------------------------------------------------------------------------
# Decode (one token, cache)
# --------------------------------------------------------------------------
class KVCache(NamedTuple):
    """k/v: (B, W, Hk, hd) with W = window (ring) or max_len (full)."""

    k: Tensor
    v: Tensor


def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int, dtype,
                  device: str | torch.device = "cuda") -> KVCache:
    w = min(cfg.sliding_window or max_len, max_len)
    if cfg.local_window:
        w = min(cfg.local_window, max_len)
    shape = (batch, w, cfg.n_kv_heads, cfg.hd)
    return KVCache(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device))


def attn_decode(
    p: dict,
    cfg: ModelConfig,
    x: Tensor,
    cache: KVCache,
    length: int,
) -> tuple[Tensor, KVCache]:
    """One decode step.  x: (B, 1, d); length: tokens so far (a host int).

    The new k/v row is rotated at its absolute position and written at slot
    ``length % W`` (ring semantics when a window bounds W; plain append
    otherwise).  Attention masks invalid (unwritten) slots; slot order is
    irrelevant because positions are encoded in the rotated keys.  The row
    is written into ``cache``'s tensors in place; the cache is returned.
    """
    b = x.shape[0]
    w = cache.k.shape[1]
    if cfg.mrope_sections:  # text-only decode: all three streams advance together
        pos = torch.full((b, 1, len(cfg.mrope_sections)), length, dtype=torch.int32,
                         device=x.device)
    else:
        pos = torch.full((b, 1), length, dtype=torch.int32, device=x.device)
    q = _rope(cfg, _project_q(p, cfg, x), pos)
    k_new, v_new = _project_kv(p, cfg, x)
    k_new = _rope(cfg, k_new, pos)
    slot = length % w
    cache.k[:, slot : slot + 1] = k_new.to(cache.k.dtype)
    cache.v[:, slot : slot + 1] = v_new.to(cache.v.dtype)
    # Slots 0..min(length, W-1) hold data (ring: all slots once length >= W).
    valid = torch.arange(w, device=x.device) <= min(length, w - 1)  # (W,)
    mask = valid[None, None, None, None, :]  # -> (B, Hk, G, 1, W) by broadcast
    y = _attend(q, cache.k, cache.v, mask)
    y = y.reshape(b, 1, cfg.n_heads * cfg.hd)
    out = y @ p["wo"].to(y.dtype)
    return out, cache


# --------------------------------------------------------------------------
# Cross-attention (whisper decoder)
# --------------------------------------------------------------------------
def cross_attn_kv(p: dict, cfg: ModelConfig, enc_out: Tensor) -> tuple[Tensor, Tensor]:
    return _project_kv(p, cfg, enc_out)


def cross_attn(p: dict, cfg: ModelConfig, x: Tensor, kv: tuple[Tensor, Tensor]) -> Tensor:
    b, s, _ = x.shape
    layout = "seq" if (not _head_axis_ok(cfg.n_heads) and s > 1) else "heads"
    q = _project_q(p, cfg, x, layout)
    y = _attend(q, kv[0], kv[1], None)
    y = y.reshape(b, s, cfg.n_heads * cfg.hd)
    return y @ p["wo"].to(y.dtype)
