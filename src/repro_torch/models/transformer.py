"""Decoder-only transformer assembly: layer loop, caches.

Port of ``repro.models.transformer``.  The reference runs a homogeneous
stack under ``lax.scan`` over per-layer params stacked on a leading axis
(with ``jax.checkpoint`` for training); the port keeps the layers of such a
stack apart in a :class:`repro_torch._tree.Stacked` list and loops over
them.  With ``cfg.remat`` each layer runs under
``torch.utils.checkpoint.checkpoint`` (non-reentrant) while autograd
records, so its activations are recomputed in the backward pass instead
of kept: memory, not values, changes.  Serving runs without autograd and
is untouched.  The stack's checkpoint keys and arrays are the reference's:
see :mod:`repro_torch._tree`.  Heterogeneous stacks (recurrentgemma's
(rec, rec, attn) cycle) are a plain list, as in the reference.

On an active mesh (tensor parallelism over ``"model"``, the parameters this
rank's blocks) the embedding is vocab-parallel: a masked lookup of this
rank's rows, then the ranks' partials summed in rank order, cut along the
sequence (``sp_scatter``) when ``cfg.seq_shard`` and the sequence divides
(Megatron's sequence parallelism: the residual stream stays a sequence
block between layers, the norms run on it with their weights entering by
``tp_copy``), else summed whole (``tp_sum``).  The final hidden states are
gathered whole (``rep_gather``), and :func:`lm_logits` gives this rank's
vocab block.  Under FSDP (``make_train_step(fsdp=True)``) a layer's
FSDP-cut leaves are gathered at the top of :func:`_apply_layer`, the
function remat wraps, and the head where :func:`lm_logits` uses it.  Every layer kind shards: attention and FFN (heads or query
rows, column/row parallel), the MoE's experts, the SSM's and RG-LRU's
channels (the scans on the whole sequence: they enter with ``sp_gather``
and leave with ``sp_scatter``); the decode caches hold this rank's share.

Layer recipes:
  attn   : h += Attn(norm(h));        h += FFN(norm(h))
  moe    : h += Attn(norm(h));        h += MoE(norm(h))   (+aux loss)
  ssm    : h += Mamba(norm(h))                             (no FFN; mamba-1)
  rec    : h += RGLRU(norm(h));       h += FFN(norm(h))
  lattn  : h += LocalAttn(norm(h));   h += FFN(norm(h))    (window attention)
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from repro_torch._tree import Stacked
from repro_torch.configs.base import ModelConfig
from repro_torch.dist import collectives as coll
from repro_torch.launch import mesh as meshlib

from . import attention as attn
from . import moe as moe_mod
from . import rglru as rg
from . import ssm as ssm_mod
from .common import ParamDef, mask_vocab_pad, norm_apply, norm_defs, torch_dtype, vocab_padded
from .ffn import ffn_apply, ffn_defs

Tensor = torch.Tensor

# --------------------------------------------------------------------------
# Layer type plan
# --------------------------------------------------------------------------
def layer_types(cfg: ModelConfig) -> list[str]:
    if cfg.family == "ssm":
        return ["ssm"] * cfg.n_layers
    if cfg.family == "moe":
        return ["moe"] * cfg.n_layers
    if cfg.family == "hybrid":
        pat = cfg.block_pattern or ("rec",)
        types = [pat[i % len(pat)] for i in range(cfg.n_layers)]
        return ["lattn" if t == "attn" else t for t in types]
    return ["attn"] * cfg.n_layers


def is_scanned(cfg: ModelConfig) -> bool:
    types = layer_types(cfg)
    return cfg.scan_layers and len(set(types)) == 1 and cfg.n_layers > 1


# --------------------------------------------------------------------------
# Parameter definitions
# --------------------------------------------------------------------------
def _layer_defs(cfg: ModelConfig, kind: str) -> dict:
    if kind in ("attn", "lattn"):
        return {
            "ln1": norm_defs(cfg.norm, cfg.d_model),
            "attn": attn.attn_defs(cfg),
            "ln2": norm_defs(cfg.norm, cfg.d_model),
            "mlp": ffn_defs(cfg),
        }
    if kind == "moe":
        return {
            "ln1": norm_defs(cfg.norm, cfg.d_model),
            "attn": attn.attn_defs(cfg),
            "ln2": norm_defs(cfg.norm, cfg.d_model),
            "moe": moe_mod.moe_defs(cfg),
        }
    if kind == "ssm":
        return {"ln": norm_defs(cfg.norm, cfg.d_model), "mixer": ssm_mod.ssm_defs(cfg)}
    if kind == "rec":
        return {
            "ln1": norm_defs(cfg.norm, cfg.d_model),
            "rec": rg.rglru_defs(cfg),
            "ln2": norm_defs(cfg.norm, cfg.d_model),
            "mlp": ffn_defs(cfg),
        }
    raise ValueError(kind)


def decoder_defs(cfg: ModelConfig) -> dict:
    types = layer_types(cfg)
    v_pad = vocab_padded(cfg.vocab)
    embed_spec = ("tp", None)  # vocab-sharded rows; d replicated (cheap lookup)
    defs: dict[str, Any] = {
        "embed": ParamDef((v_pad, cfg.d_model), embed_spec, "small"),
        "final_norm": norm_defs(cfg.norm, cfg.d_model),
    }
    if not cfg.tie_embeddings:
        defs["head"] = ParamDef((cfg.d_model, v_pad), ("fsdp", "tp"))
    layers = [_layer_defs(cfg, t) for t in types]
    defs["layers"] = Stacked(layers) if is_scanned(cfg) else layers
    return defs


# --------------------------------------------------------------------------
# Layer application (full-sequence)
# --------------------------------------------------------------------------
def _remat(cfg: ModelConfig, fn, *args, **kwargs):
    """``fn(*args, **kwargs)``, under activation checkpointing when
    ``cfg.remat`` and autograd records (the reference's ``jax.checkpoint``
    around a layer).  The recompute runs under the ambient mesh of the
    forward (``meshlib.carry``), on whichever thread the backward runs."""
    if cfg.remat and torch.is_grad_enabled():
        return torch.utils.checkpoint.checkpoint(meshlib.carry(fn), *args, use_reentrant=False,
                                                 **kwargs)
    return fn(*args, **kwargs)


def _seq_sharded(cfg: ModelConfig, mesh, s: int) -> bool:
    """A residual stream of ``s`` tokens is a sequence block on ``mesh``
    between layers: ``cfg.seq_shard``, more than one token, and ``s``
    divides over ``"model"``."""
    return mesh is not None and cfg.seq_shard and s > 1 and s % meshlib.model_coord(mesh)[0] == 0


def _norm(cfg: ModelConfig, x: Tensor, p: dict, seq_sharded: bool) -> Tensor:
    """``norm_apply``; on a sequence block of an active mesh the weights
    enter by ``tp_copy`` (each rank's gradient of them is partial)."""
    mesh = meshlib.active_mesh()
    if mesh is not None and seq_sharded:
        p = {k: coll.tp_copy(w, mesh) for k, w in p.items()}
    return norm_apply(cfg.norm, x, p)


def _apply_layer(
    p: dict,
    cfg: ModelConfig,
    kind: str,
    h: Tensor,
    positions: Tensor,
    *,
    collect: bool,
    seq_sharded: bool = False,
):
    """Returns (h, aux, cache_entry_or_None).  FSDP blocks among ``p`` are
    gathered here, inside the remat (see :func:`coll.fsdp_tree`)."""
    p = coll.fsdp_tree(p)
    zero = torch.zeros((), dtype=torch.float32, device=h.device)
    if kind == "ssm":
        x = _norm(cfg, h, p["ln"], seq_sharded)
        if collect:
            y, state = ssm_mod.ssm_apply(p["mixer"], cfg, x, return_state=True,
                                         seq_sharded=seq_sharded)
        else:
            y, state = ssm_mod.ssm_apply(p["mixer"], cfg, x, seq_sharded=seq_sharded), None
        return h + y, zero, state
    if kind == "rec":
        x = _norm(cfg, h, p["ln1"], seq_sharded)
        if collect:
            y, state = rg.rglru_apply(p["rec"], cfg, x, return_state=True,
                                      seq_sharded=seq_sharded)
        else:
            y, state = rg.rglru_apply(p["rec"], cfg, x, seq_sharded=seq_sharded), None
        h = h + y
        h = h + ffn_apply(p["mlp"], cfg, _norm(cfg, h, p["ln2"], seq_sharded),
                          seq_sharded=seq_sharded)
        return h, zero, state
    # attention variants
    window = cfg.local_window if kind == "lattn" else cfg.sliding_window
    x = _norm(cfg, h, p["ln1"], seq_sharded)
    q_chunk = cfg.seq_chunk
    if collect:
        y, (k, v) = attn.attn_sequence(
            p["attn"], cfg, x, positions, window=window, q_chunk=q_chunk, return_kv=True,
            seq_sharded=seq_sharded,
        )
        cache_entry = (k, v)
    else:
        y = attn.attn_sequence(p["attn"], cfg, x, positions, window=window, q_chunk=q_chunk,
                               seq_sharded=seq_sharded)
        cache_entry = None
    h = h + y
    x2 = _norm(cfg, h, p["ln2"], seq_sharded)
    if kind == "moe":
        y2, aux = moe_mod.moe_apply(p["moe"], cfg, x2, seq_sharded=seq_sharded)
    else:
        y2, aux = ffn_apply(p["mlp"], cfg, x2, seq_sharded=seq_sharded), zero
    return h + y2, aux, cache_entry


def _embed(params: dict, tokens: Tensor, dt: torch.dtype, mesh) -> Tensor:
    """The embedding rows of ``tokens`` in ``dt``; on ``mesh`` this rank's
    partial: its vocab block's rows, zero for a token outside the block."""
    # F.embedding, not params["embed"][tokens]: the same rows, and a backward
    # that sums a repeated token's rows in a fixed order on the CPU too
    # (indexing's backward adds them with atomics there), so a step repeats
    # bitwise.
    table = params["embed"]
    if mesh is None:
        return F.embedding(tokens, table).to(dt)
    _, i = meshlib.model_coord(mesh)
    n = table.shape[0]
    local = tokens.long() - i * n
    valid = (local >= 0) & (local < n)
    rows = F.embedding(local.clamp(0, n - 1), table)
    return torch.where(valid[..., None], rows, torch.zeros((), dtype=rows.dtype,
                                                           device=rows.device)).to(dt)


def forward(
    params: dict,
    cfg: ModelConfig,
    tokens: Tensor,
    positions: Tensor | None = None,
    *,
    collect_cache: bool = False,
):
    """Token ids -> final hidden states.  Returns (hidden, aux, cache): aux
    the summed MoE aux loss (0 without experts); the cache, when
    ``collect_cache``, a list of per-layer ``(k, v)`` (attention layers) or
    :class:`~.ssm.SSMState` / :class:`~.rglru.LRUState` (recurrent layers),
    else None.  On an active mesh the hidden states are whole on every
    rank."""
    types = layer_types(cfg)
    b, s = tokens.shape
    if positions is None:
        positions = torch.arange(s, dtype=torch.int32, device=tokens.device).expand(b, s)
        if cfg.mrope_sections:
            positions = positions[..., None].expand(b, s, 3)
    dt = torch_dtype(cfg.compute_dtype)
    mesh = meshlib.active_mesh()
    h = _embed(params, tokens, dt, mesh)
    sp = ("dp", "tp", None) if cfg.seq_shard and s > 1 else ("dp", None, None)
    seq_sharded = _seq_sharded(cfg, mesh, s)
    if mesh is not None:
        h = coll.sp_scatter(h, mesh) if seq_sharded else coll.tp_sum(h, mesh)
    h = meshlib.constraint(h, *sp)

    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    cache = []
    for lp, kind in zip(params["layers"], types):
        h, aux_l, cache_e = _remat(cfg, _apply_layer, lp, cfg, kind, h, positions,
                                  collect=collect_cache, seq_sharded=seq_sharded)
        h = meshlib.constraint(h, *sp)
        aux = aux + aux_l
        cache.append(cache_e)

    h = _norm(cfg, h, params["final_norm"], seq_sharded)
    if seq_sharded:
        h = coll.rep_gather(h, mesh, dim=1)
    return h, aux, cache if collect_cache else None


def lm_logits(params: dict, cfg: ModelConfig, h: Tensor) -> Tensor:
    """Logits of the whole hidden states ``h``; on an active mesh this
    rank's vocab block (the embedding's or head's columns)."""
    dt = h.dtype
    mesh = meshlib.active_mesh()
    if mesh is not None:
        h = coll.tp_copy(h, mesh)
    if cfg.tie_embeddings:
        logits = h @ params["embed"].to(dt).T
    else:
        logits = h @ coll.fsdp_tree(params["head"]).to(dt)
    logits = mask_vocab_pad(logits, cfg.vocab)
    return meshlib.constraint(logits, "dp", None, "tp")


# --------------------------------------------------------------------------
# Decode path
# --------------------------------------------------------------------------
class DecodeCache(NamedTuple):
    """Per-model cache: ``entries`` one :class:`~.attention.KVCache`,
    :class:`~.ssm.SSMState` or :class:`~.rglru.LRUState` a layer (the
    reference stacks a scanned stack's on a leading axis); ``length`` the
    tokens written so far, a host int."""

    entries: Any
    length: int


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype,
               device: str | torch.device = "cuda") -> DecodeCache:
    def one(kind: str):
        if kind == "ssm":
            return ssm_mod.init_ssm_state(cfg, batch, dtype, device)
        if kind == "rec":
            return rg.init_lru_state(cfg, batch, dtype, device)
        return attn.init_kv_cache(cfg, batch, max_len, dtype, device)

    return DecodeCache([one(kind) for kind in layer_types(cfg)], 0)


def _decode_layer(p: dict, cfg: ModelConfig, kind: str, h: Tensor, entry, length: int):
    if kind == "ssm":
        y, entry = ssm_mod.ssm_decode(p["mixer"], cfg, norm_apply(cfg.norm, h, p["ln"]), entry)
        return h + y, entry
    if kind == "rec":
        y, entry = rg.rglru_decode(p["rec"], cfg, norm_apply(cfg.norm, h, p["ln1"]), entry)
        h = h + y
        h = h + ffn_apply(p["mlp"], cfg, norm_apply(cfg.norm, h, p["ln2"]))
        return h, entry
    x = norm_apply(cfg.norm, h, p["ln1"])
    y, entry = attn.attn_decode(p["attn"], cfg, x, entry, length)
    h = h + y
    x2 = norm_apply(cfg.norm, h, p["ln2"])
    if kind == "moe":
        y2, _ = moe_mod.moe_apply(p["moe"], cfg, x2)
    else:
        y2 = ffn_apply(p["mlp"], cfg, x2)
    return h + y2, entry


def decode_step(
    params: dict, cfg: ModelConfig, tokens: Tensor, cache: DecodeCache
) -> tuple[Tensor, DecodeCache]:
    """One decode step.  tokens: (B, 1) int.  Returns (logits, cache): an
    attention entry's tensors take the new row in place, a recurrent
    layer's state is a new one, the length one more."""
    types = layer_types(cfg)
    dt = torch_dtype(cfg.compute_dtype)
    mesh = meshlib.active_mesh()
    if mesh is None:
        h = params["embed"][tokens].to(dt)
    else:
        h = coll.tp_sum(_embed(params, tokens, dt, mesh), mesh)
    new_entries = []
    for lp, kind, entry in zip(params["layers"], types, cache.entries):
        h, ne = _decode_layer(lp, cfg, kind, h, entry, cache.length)
        new_entries.append(ne)
    h = norm_apply(cfg.norm, h, params["final_norm"])
    logits = lm_logits(params, cfg, h)
    return logits, DecodeCache(new_entries, cache.length + 1)
