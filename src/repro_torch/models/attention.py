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
identity on a rank's local block).

Tensor parallelism (an active mesh; ``tp`` ranks on ``"model"``): the
parameters are this rank's blocks.  Where the query heads divide by ``tp``
(:func:`_heads_sharded`), q/k/v are column-parallel over heads (this rank's
``n_heads / tp`` query heads) and ``wo`` is row-parallel: the input enters
with ``sp_gather`` (a sequence-sharded residual stream) or ``tp_copy`` and
the output leaves with ``sp_scatter`` or ``tp_sum``; ``q_norm``/``k_norm``
enter with ``tp_copy`` (their gradient is partial on each rank).  K/V are
sharded by kv heads where those divide by ``tp`` (the grouped path, as the
reference's ``hk % tp == 0``); otherwise ``wk``/``wv`` are gathered whole,
K/V computed whole on every rank and expanded to the query heads, each
rank keeping its own (the reference's expand path).  Where the query heads
do not divide and the stream is sequence-sharded, the layout is the
reference's ``"seq"`` one (:func:`_attn_rows`): this rank's queries are its
own sequence block, attended against K/V computed whole from the gathered
input, and the output rows land in the sequence-sharded layout; the
weights are gathered whole with a summed backward (``sp_gather``: each
rank's gradient of them covers only its own rows) and ``q_norm``/``k_norm``
enter with ``tp_copy``.  Decode and a whole (unsharded) stream keep the
whole-attention layout there: every rank computes the attention whole on
gathered weights (``rep_gather``, whose backward keeps a rank's own slice
of the equal whole gradients), ``tp`` times the work.

A decode cache of type :class:`SeqKVCache` is cut by slots over
``"model"`` instead (the dry-run's decode layout, split-K): each rank
attends every query head against its own slots, and the ranks' partial
softmax statistics are combined by log-sum-exp in rank order
(:func:`_split_decode`); the cross-attention's encoder K/V likewise.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.dist import collectives as coll
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


def _heads_sharded(cfg: ModelConfig, tp: int) -> bool:
    """The query heads are column-parallel over ``tp`` ranks."""
    return cfg.n_heads % tp == 0


def kv_sharded(cfg: ModelConfig, tp: int | None = None) -> bool:
    """K/V (and the decode cache) are sharded by kv heads over ``tp``
    ranks (default: the active model axis): the heads divide, so the
    grouped path runs on each rank's share."""
    tp = meshlib.tp_active() if tp is None else tp
    return cfg.n_kv_heads % tp == 0


def _tp_weights(p: dict, cfg: ModelConfig, mesh, *, rows: bool = False) -> dict:
    """This rank's effective attention weights on ``mesh``: its blocks,
    gathered whole where its use of them is not column/row parallel (with
    a summed backward in the query-row layout, ``rows``, where each rank's
    use of them is partial)."""
    tp, _ = meshlib.model_coord(mesh)
    w = dict(p)
    if _heads_sharded(cfg, tp) or rows:
        for name in ("q_norm", "k_norm"):
            if name in p:
                w[name] = coll.tp_copy(p[name], mesh)
    if _heads_sharded(cfg, tp):
        if not kv_sharded(cfg, tp):
            for name in ("wk", "wv"):
                if name in p:
                    w[name] = coll.sp_gather(p[name], mesh, dim=1)
        return w
    gather = coll.sp_gather if rows else coll.rep_gather
    for name, dim in (("wq", 1), ("wk", 1), ("wv", 1), ("wo", 0)):
        if name in p:
            w[name] = gather(p[name], mesh, dim=dim)
    return w


def _rank_kv(k: Tensor, v: Tensor, cfg: ModelConfig, mesh) -> tuple[Tensor, Tensor, bool | None]:
    """``(K, V, grouped)`` this rank attends with: off a mesh or in the
    whole-attention layout ``k, v`` as they are; with sharded kv heads its
    share, grouped; else whole K/V expanded to the query heads and cut to
    this rank's ``n_heads / tp`` of them."""
    if mesh is None:
        return k, v, None
    tp, i = meshlib.model_coord(mesh)
    if not _heads_sharded(cfg, tp):
        return k, v, None
    if kv_sharded(cfg, tp):
        return k, v, True
    n = cfg.n_heads // tp

    def own(x):
        x = torch.repeat_interleave(x, cfg.n_heads // cfg.n_kv_heads, dim=2)
        return x[:, :, i * n:(i + 1) * n]

    return own(k), own(v), None


def _project_q(p: dict, cfg: ModelConfig, x: Tensor, layout: str = "heads") -> Tensor:
    q = _split_heads(x @ p["wq"].to(x.dtype), -1, cfg.hd)
    if "q_norm" in p:
        q = rms_norm(q, p["q_norm"])
    if layout == "seq":  # sequence-parallel attention (few-head archs)
        return meshlib.constraint(q, "dp", "tp", None, None)
    if _head_axis_ok(cfg.n_heads):
        return meshlib.constraint(q, "dp", None, "tp", None)
    return meshlib.constraint(q, "dp", None, None, None)


def _project_kv(p: dict, cfg: ModelConfig, x: Tensor) -> tuple[Tensor, Tensor]:
    k = _split_heads(x @ p["wk"].to(x.dtype), -1, cfg.hd)
    v = _split_heads(x @ p["wv"].to(x.dtype), -1, cfg.hd)
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


def _attend(q: Tensor, k: Tensor, v: Tensor, mask: Tensor | None,
            grouped: bool | None = None) -> Tensor:
    """q: (B,Sq,H,hd), k/v: (B,Sk,Hk,hd), mask broadcastable (B,1,1,Sq,Sk).

    With query groups (``g = H / Hk > 1``) whose kv-head axis divides the
    tensor-parallel degree -- always at one device -- the queries are
    grouped against the shared K/V; otherwise K/V are expanded to the full
    query-head count, as the reference does for its sharding.  ``grouped``
    overrides the choice (a rank's share of sharded kv heads).
    """
    b, sq, h, hd = q.shape
    hk = k.shape[2]
    g = h // hk
    if grouped is None:
        grouped = hk % meshlib.tp_active() == 0
    scale = attention_scale(hd, q.dtype)
    if g > 1 and grouped:
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
    seq_sharded: bool = False,
):
    """Self-attention over a full sequence.  Returns y [, (k, v) for caching].

    On an active mesh ``x`` is this rank's sequence block when
    ``seq_sharded`` (else whole), and so is y; the cached k/v are this
    rank's kv heads where they are sharded, else whole."""
    mesh = meshlib.active_mesh()
    heads = True
    if mesh is not None:
        heads = _heads_sharded(cfg, meshlib.model_coord(mesh)[0])
        rows = seq_sharded and not heads
        p = _tp_weights(p, cfg, mesh, rows=rows)
        if rows:
            return _attn_rows(p, cfg, x, positions, mesh, causal=causal, window=window,
                              q_chunk=q_chunk, return_kv=return_kv)
        if heads:
            x = coll.sp_gather(x, mesh) if seq_sharded else coll.tp_copy(x, mesh)
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
    k_att, v_att, grouped = _rank_kv(k, v, cfg, mesh)

    if not chunked:
        mask = _causal_mask(s, s, 0, window, x.device) if causal else None
        y = _attend(q, k_att, v_att, mask, grouped)
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
                k_c = k_att[:, start : start + span]
                v_c = v_att[:, start : start + span]
                i = (c * q_chunk + torch.arange(q_chunk, device=x.device))[:, None]
                j = (start + torch.arange(span, device=x.device))[None, :]
                m = (j <= i) & (j > i - window) if causal else (j >= 0).expand(q_chunk, span)
                ys.append(_attend(q_c, k_c, v_c, m[None, None, None], grouped))
            else:
                m = _causal_mask(q_chunk, s, c * q_chunk, window, x.device) if causal else None
                ys.append(_attend(q_c, k_att, v_att, m, grouped))
        y = torch.cat(ys, 1)

    y = y.reshape(b, s, -1)
    out = y @ p["wo"].to(y.dtype)
    out = meshlib.constraint(out, "dp", None, None)
    if mesh is not None and heads:
        out = coll.sp_scatter(out, mesh) if seq_sharded else coll.tp_sum(out, mesh)
    if return_kv:
        return out, (k, v)
    return out


def _attn_rows(p: dict, cfg: ModelConfig, x: Tensor, positions: Tensor, mesh, *,
               causal: bool, window: int, q_chunk: int, return_kv: bool):
    """The query-row layout: ``x`` is this rank's sequence block (rows
    ``rank * n`` on, ``p`` the gathered weights); its queries attend K/V
    computed whole from the gathered input, with the masks at their global
    rows.  With a window shorter than the sequence the rows run in chunks of
    the window, each against a ``window + chunk`` key span, as the whole
    sequence's chunks do.  Returns this rank's rows of the output [, the
    whole (k, v)]."""
    _, rank = meshlib.model_coord(mesh)
    b, n, _ = x.shape
    whole = coll.sp_gather(x, mesh)
    s = whole.shape[1]
    off = rank * n
    q = _rope(cfg, _project_q(p, cfg, x, "seq"), positions[:, off:off + n])
    k, v = _project_kv(p, cfg, whole)
    k = _rope(cfg, k, positions)
    if window and not q_chunk and s > window:
        q_chunk = window
    c = q_chunk if q_chunk and n > q_chunk and n % q_chunk == 0 else n
    span = min(s, window + c) if window else s
    ys = []
    for r0 in range(0, n, c):
        i0 = off + r0  # the chunk's first global row
        q_c = q[:, r0:r0 + c]
        if window and span < s:
            start = min(max(i0 + c - span, 0), s - span)
            i = (i0 + torch.arange(c, device=x.device))[:, None]
            j = (start + torch.arange(span, device=x.device))[None, :]
            m = (j <= i) & (j > i - window) if causal else (j >= 0).expand(c, span)
            ys.append(_attend(q_c, k[:, start:start + span], v[:, start:start + span],
                              m[None, None, None]))
        else:
            m = _causal_mask(c, s, i0, window, x.device) if causal else None
            ys.append(_attend(q_c, k, v, m))
    y = torch.cat(ys, 1).reshape(b, n, -1)
    out = meshlib.constraint(y @ p["wo"].to(y.dtype), "dp", "tp", None)
    if return_kv:
        return out, (k, v)
    return out


# --------------------------------------------------------------------------
# Decode (one token, cache)
# --------------------------------------------------------------------------
class KVCache(NamedTuple):
    """k/v: (B, W, Hk, hd) with W = window (ring) or max_len (full); on a
    mesh Hk is this rank's share where :func:`kv_sharded`."""

    k: Tensor
    v: Tensor


class SeqKVCache(KVCache):
    """A :class:`KVCache` whose slot axis is cut over ``"model"``: this
    rank holds slots ``[r W / tp, (r + 1) W / tp)`` of every kv head (W the
    whole cache's slots, ``r`` the rank's ``"model"`` index).  The decode
    layout of the dry-run's cells (``launch/specs.py``, split-K decode):
    every rank reads ``1 / tp`` of the cache whether or not the kv heads
    divide.  The type states the layout; nothing infers it from shapes."""

    __slots__ = ()


def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int, dtype,
                  device: str | torch.device = "cuda") -> KVCache:
    w = min(cfg.sliding_window or max_len, max_len)
    if cfg.local_window:
        w = min(cfg.local_window, max_len)
    tp = meshlib.tp_active()
    hk = cfg.n_kv_heads // tp if kv_sharded(cfg, tp) else cfg.n_kv_heads
    shape = (batch, w, hk, cfg.hd)
    return KVCache(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device))


def _decode_positions(cfg: ModelConfig, b: int, length: int, device) -> Tensor:
    """The new token's position ``length`` for a batch of ``b``; text-only
    M-RoPE decode advances its three streams together."""
    shape = (b, 1, len(cfg.mrope_sections)) if cfg.mrope_sections else (b, 1)
    return torch.full(shape, length, dtype=torch.int32, device=device)


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
    mesh = meshlib.active_mesh()
    if mesh is not None and isinstance(cache, SeqKVCache):
        return _attn_decode_split(p, cfg, x, cache, length, mesh), cache
    heads = True
    if mesh is not None:
        heads = _heads_sharded(cfg, meshlib.model_coord(mesh)[0])
        p = _tp_weights(p, cfg, mesh)
        if heads:
            x = coll.tp_copy(x, mesh)
    pos = _decode_positions(cfg, b, length, x.device)
    q = _rope(cfg, _project_q(p, cfg, x), pos)
    k_new, v_new = _project_kv(p, cfg, x)
    k_new = _rope(cfg, k_new, pos)
    slot = length % w
    cache.k[:, slot : slot + 1] = k_new.to(cache.k.dtype)
    cache.v[:, slot : slot + 1] = v_new.to(cache.v.dtype)
    # Slots 0..min(length, W-1) hold data (ring: all slots once length >= W).
    valid = torch.arange(w, device=x.device) <= min(length, w - 1)  # (W,)
    mask = valid[None, None, None, None, :]  # -> (B, Hk, G, 1, W) by broadcast
    k, v, grouped = _rank_kv(cache.k, cache.v, cfg, mesh)
    y = _attend(q, k, v, mask, grouped)
    y = y.reshape(b, 1, -1)
    out = y @ p["wo"].to(y.dtype)
    if mesh is not None and heads:
        out = coll.tp_sum(out, mesh)
    return out, cache


def _whole_cols(x: Tensor, w: Tensor, mesh) -> Tensor:
    """``x @ w`` for a column block ``w`` of a weight, this rank's columns
    gathered whole over ``"model"`` in rank order."""
    return coll.gather_cat(x @ w.to(x.dtype), (coll.AXIS,), mesh, dim=-1)


def _split_decode(p: dict, cfg: ModelConfig, q: Tensor, k: Tensor, v: Tensor,
                  valid: Tensor | None, mesh) -> Tensor:
    """Split-K attention of one token: the whole query ``q`` (B, 1, H, hd)
    against this rank's slots ``k``/``v`` (B, W_r, Hk, hd) where ``valid``
    (W_r,) allows, the ranks' partial maxima, sums and weighted values
    combined over ``"model"`` in rank order by log-sum-exp; then this
    rank's rows of ``wo`` (row parallel) and the ordered sum over
    ``"model"``.  A rank with no valid slot adds zero (``exp`` of its
    ``NEG_INF`` maximum less the largest)."""
    tp, r = meshlib.model_coord(mesh)
    b, _, h, hd = q.shape
    hk = k.shape[2]
    qg = q.reshape(b, 1, hk, h // hk, hd)
    scores = (torch.einsum("bqhgd,bkhd->bhgqk", qg, k) * attention_scale(hd, q.dtype)).float()
    if valid is not None:
        scores = scores.masked_fill(~valid, NEG_INF)
    m = scores.amax(-1, keepdim=True)  # (B, Hk, G, 1, 1)
    e = torch.exp(scores - m)
    part = torch.cat([m, e.sum(-1, keepdim=True),
                      torch.einsum("bhgqk,bkhd->bhgqd", e, v.float())], -1)
    parts = coll._gather(part, mesh.get_group(coll.AXIS))  # rank order
    top = torch.stack([t[..., :1] for t in parts]).amax(0)
    acc = coll._add_in_order([t[..., 1:] * torch.exp(t[..., :1] - top) for t in parts])
    y = (acc[..., 1:] / acc[..., :1]).to(q.dtype)  # (B, Hk, G, 1, hd)
    y = y.permute(0, 3, 1, 2, 4).reshape(b, 1, h * hd)
    n = h * hd // tp
    out = y[..., r * n:(r + 1) * n] @ p["wo"].to(y.dtype)
    return coll.tp_sum(out, mesh)


def _attn_decode_split(p: dict, cfg: ModelConfig, x: Tensor, cache: SeqKVCache,
                       length: int, mesh) -> Tensor:
    """:func:`attn_decode` on a :class:`SeqKVCache`: q, k and v of the new
    token from this rank's column blocks of ``wq``/``wk``/``wv`` gathered
    whole (every head, whether or not the heads divide), the new row written
    into the rank that owns its slot, then :func:`_split_decode`."""
    tp, r = meshlib.model_coord(mesh)
    b = x.shape[0]
    wr = cache.k.shape[1]
    w = wr * tp
    pos = _decode_positions(cfg, b, length, x.device)
    q = _split_heads(_whole_cols(x, p["wq"], mesh), -1, cfg.hd)
    if "q_norm" in p:
        q = rms_norm(q, p["q_norm"])
    q = _rope(cfg, q, pos)
    k_new = _split_heads(_whole_cols(x, p["wk"], mesh), -1, cfg.hd)
    v_new = _split_heads(_whole_cols(x, p["wv"], mesh), -1, cfg.hd)
    if "k_norm" in p:
        k_new = rms_norm(k_new, p["k_norm"])
    k_new = _rope(cfg, k_new, pos)
    slot = length % w
    if slot // wr == r:  # this rank owns the new row's slot
        cache.k[:, slot - r * wr: slot - r * wr + 1] = k_new.to(cache.k.dtype)
        cache.v[:, slot - r * wr: slot - r * wr + 1] = v_new.to(cache.v.dtype)
    valid = r * wr + torch.arange(wr, device=x.device) <= min(length, w - 1)
    return _split_decode(p, cfg, q, cache.k, cache.v, valid, mesh)


# --------------------------------------------------------------------------
# Cross-attention (whisper decoder)
# --------------------------------------------------------------------------
def cross_attn_kv(p: dict, cfg: ModelConfig, enc_out: Tensor, *,
                  seq_sharded: bool = False) -> tuple[Tensor, Tensor]:
    """The cross-attention K/V of the encoder states ``enc_out``, whole on
    an active mesh (the caller gathers them).  There K/V are this rank's kv
    heads where they divide over ``"model"``, else whole from gathered
    ``wk``/``wv``: with a summed backward where the use is partial (the
    heads layout, or the query-row layout of a ``seq_sharded`` decoder),
    else a rank's own slice (the whole-attention layout)."""
    mesh = meshlib.active_mesh()
    if mesh is not None:
        tp, _ = meshlib.model_coord(mesh)
        if not kv_sharded(cfg, tp):
            gather = coll.sp_gather if (_heads_sharded(cfg, tp) or seq_sharded) \
                else coll.rep_gather
            p = {name: gather(p[name], mesh, dim=1) for name in ("wk", "wv")}
    return _project_kv(p, cfg, enc_out)


def cross_attn(p: dict, cfg: ModelConfig, x: Tensor, kv: tuple[Tensor, Tensor], *,
               seq_sharded: bool = False) -> Tensor:
    """Cross-attention of the decoder states ``x`` on ``kv``
    (:func:`cross_attn_kv`'s, of the same layout).  On an active mesh ``x``
    is this rank's sequence block when ``seq_sharded`` (else whole), and so
    is the output: column/row parallel over heads where they divide, else
    the query-row layout (a ``seq_sharded`` block) or the whole attention."""
    mesh = meshlib.active_mesh()
    if mesh is not None and isinstance(kv, SeqKVCache):  # split-K over the encoder positions
        q = _split_heads(_whole_cols(x, p["wq"], mesh), -1, cfg.hd)
        return _split_decode(p, cfg, q, kv.k, kv.v, None, mesh)
    heads = True
    if mesh is not None:
        heads = _heads_sharded(cfg, meshlib.model_coord(mesh)[0])
        p = _tp_weights({k: w for k, w in p.items() if k not in ("wk", "wv")}, cfg, mesh,
                        rows=seq_sharded and not heads)
        if heads:
            x = coll.sp_gather(x, mesh) if seq_sharded else coll.tp_copy(x, mesh)
    b, s, _ = x.shape
    layout = "seq" if (not _head_axis_ok(cfg.n_heads) and s > 1) else "heads"
    q = _project_q(p, cfg, x, layout)
    k, v, grouped = _rank_kv(kv[0], kv[1], cfg, mesh)
    y = _attend(q, k, v, None, grouped)
    y = y.reshape(b, s, -1)
    out = y @ p["wo"].to(y.dtype)
    if mesh is not None and heads:
        out = coll.sp_scatter(out, mesh) if seq_sharded else coll.tp_sum(out, mesh)
    return out
