"""Mixture-of-Experts FFN: top-k routing with capacity dispatch.

Port of ``repro.models.moe``.  Dispatch is sort-free (cumsum-position
capacity dispatch), as the reference's:
  1. top-k routing (router logits; padded experts masked to -inf),
  2. per-expert positions via a one-hot cumsum over the token-major pairs,
  3. pairs beyond capacity C = max(8, ceil(T*k/E_pad * cf)) are dropped,
     T the tokens of the call (so a decode step has its own capacity),
  4. scatter into the (E_local, C, d) buffer, dense per-expert products,
     gather back weighted by the routing probabilities,
plus the shared expert behind its sigmoid gate and the Switch-style
load-balance aux loss.

The expert count is padded to a multiple of 16 (qwen2-moe: 60 -> 64; the
pads get -inf router logits and are never selected for k <= the real
count).

Expert parallelism (an active mesh; ``tp`` ranks on ``"model"``), the
reference's ``shard_map``: each rank holds ``e_pad / tp`` experts (its
``"expert"`` blocks) and routes every token of its data-parallel block to
them, so the capacity counts the whole block's tokens as the reference's
does.  The input enters with ``sp_gather`` (a sequence-sharded residual
stream) or ``tp_copy``; the router and ``shared_gate`` (replicated, each
rank's gradient of them partial: its own experts' pairs, its share of the
shared expert) enter with ``tp_copy``; the shared expert is column/row
parallel on its ``"tp"`` blocks, its partial joining the experts' before the
one sum, which leaves with ``sp_scatter`` (the reference's ``psum``, then
the sequence cut) or ``tp_sum``.  Every model rank computes the same aux
loss from the whole routing; each enters the ordered sum over ``"model"`` as
its ``1 / tp`` share, so the router's summed gradient counts it once.  Its
mean over the data axes is the train step's, as the cross entropy's is.

``torch.topk`` promises no order among equal logits where
``jax.lax.top_k`` puts the lower index first; with real-valued router
logits ties do not arise in practice, and the tests hold the routing
indices against the reference's.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.dist import collectives as coll
from repro_torch.launch import mesh as meshlib

from .common import ParamDef, act_fn

Tensor = torch.Tensor

EXPERT_PAD_MULTIPLE = 16


def padded_experts(n: int) -> int:
    return -(-n // EXPERT_PAD_MULTIPLE) * EXPERT_PAD_MULTIPLE


def moe_defs(cfg: ModelConfig) -> dict:
    d, fe = cfg.d_model, cfg.d_ff_expert
    e_pad = padded_experts(cfg.n_experts)
    defs = {
        "router": ParamDef((d, e_pad), (None, None)),
        "w_gate": ParamDef((e_pad, d, fe), ("expert", "fsdp", None)),
        "w_up": ParamDef((e_pad, d, fe), ("expert", "fsdp", None)),
        "w_down": ParamDef((e_pad, fe, d), ("expert", None, "fsdp")),
    }
    if cfg.d_ff_shared:
        fs = cfg.d_ff_shared
        defs["shared"] = {
            "gate": ParamDef((d, fs), ("fsdp", "tp")),
            "up": ParamDef((d, fs), ("fsdp", "tp")),
            "down": ParamDef((fs, d), ("tp", "fsdp")),
        }
        defs["shared_gate"] = ParamDef((d, 1), (None, None))  # qwen2-moe gate
    return defs


def moe_apply(p: dict, cfg: ModelConfig, x: Tensor, *,
              seq_sharded: bool = False) -> tuple[Tensor, Tensor]:
    """Returns (y, aux_loss).  x: (B, S, d); on an active mesh this rank's
    sequence block when ``seq_sharded`` (else whole), and so is y, with
    this rank's experts (see the module docstring).  Off a mesh, or in
    manual mode, every expert runs locally."""
    act = act_fn("silu")
    e_pad = padded_experts(cfg.n_experts)
    mesh = meshlib.active_mesh()
    if mesh is None:
        return _moe_local(p, cfg, x, e_loc=e_pad, my_first=0, act=act)
    tp, rank = meshlib.model_coord(mesh)
    if e_pad % tp:
        raise ValueError(f"padded experts {e_pad} not divisible by tp={tp}")
    e_loc = e_pad // tp
    x = coll.sp_gather(x, mesh) if seq_sharded else coll.tp_copy(x, mesh)
    local = dict(p, router=coll.tp_copy(p["router"], mesh))
    if p.get("shared") is not None:
        local["shared_gate"] = coll.tp_copy(p["shared_gate"], mesh)
    y, aux = _moe_local(local, cfg, x, e_loc=e_loc, my_first=rank * e_loc, act=act)
    y = coll.sp_scatter(y, mesh) if seq_sharded else coll.tp_sum(y, mesh)
    return y, coll.tp_sum(aux / tp, mesh)


class Routing(NamedTuple):
    """One call's routing: ``logits`` (T, E_pad) fp32 with the pads at -inf;
    ``top_idx``/``probs`` (T, k); ``onehot`` (T*k, E_pad) int32;
    ``keep``/``slot`` (T, k), a dropped pair's slot the drop row
    ``e_loc * cap``; ``cap`` the capacity an expert."""

    logits: Tensor
    top_idx: Tensor
    probs: Tensor
    onehot: Tensor
    keep: Tensor
    slot: Tensor
    cap: int


def route(p: dict, cfg: ModelConfig, xf: Tensor, *, e_loc: int, my_first: int = 0) -> Routing:
    """Route the tokens ``xf`` (T, d) to the experts ``[my_first, my_first +
    e_loc)``, as :func:`_moe_local` does."""
    t = xf.shape[0]
    e_pad = padded_experts(cfg.n_experts)
    k = cfg.n_experts_per_tok
    cap = max(8, int(math.ceil(t * k / e_pad * cfg.capacity_factor)))
    logits = (xf @ p["router"].to(xf.dtype)).float()
    pad_mask = torch.arange(e_pad, device=xf.device) < cfg.n_experts
    logits = logits.masked_fill(~pad_mask[None, :], -math.inf)
    top_vals, top_idx = torch.topk(logits, k, dim=-1)  # (T, k)
    probs = torch.softmax(top_vals, dim=-1).to(xf.dtype)

    # Within-expert positions over the flat (token-major) pair order: one
    # cumsum over a (T*k, E_pad) one-hot.
    pair_expert = top_idx.reshape(-1)  # (T*k,)
    onehot = (pair_expert[:, None] == torch.arange(e_pad, device=xf.device)[None, :]).to(
        torch.int32)
    pos_flat = torch.gather(torch.cumsum(onehot, 0) - 1, 1, pair_expert[:, None])[:, 0]
    pos = pos_flat.reshape(t, k)
    local_e = top_idx - my_first  # (T, k)
    keep = (local_e >= 0) & (local_e < e_loc) & (pos < cap)
    drop = torch.full_like(pos, e_loc * cap)
    slot = torch.where(keep, local_e * cap + pos, drop)  # (T, k)
    return Routing(logits, top_idx, probs, onehot, keep, slot, cap)


def dropped_pairs(p: dict, cfg: ModelConfig, x: Tensor) -> int:
    """The (token, expert) pairs of ``x`` (B, S, d) that :func:`moe_apply`
    drops at capacity (a host read)."""
    xf = x.reshape(-1, x.shape[-1])
    r = route(p, cfg, xf, e_loc=padded_experts(cfg.n_experts))
    return int((~r.keep).sum())


def _moe_local(
    p: dict,
    cfg: ModelConfig,
    x: Tensor,
    *,
    e_loc: int,
    my_first: int,
    act,
) -> tuple[Tensor, Tensor]:
    """Per-device MoE body.  x: (B_loc, S, d)."""
    b, s, d = x.shape
    t = b * s
    e_pad = padded_experts(cfg.n_experts)
    k = cfg.n_experts_per_tok
    dt = x.dtype
    xf = x.reshape(t, d)
    r = route(p, cfg, xf, e_loc=e_loc, my_first=my_first)
    cap, keep, slot = r.cap, r.keep, r.slot

    buf = torch.zeros((e_loc * cap + 1, d), dtype=dt, device=x.device)
    for j in range(k):
        # Kept slots are unique.  Every dropped pair writes the drop row
        # (last), so on CUDA that row's content is whichever write lands
        # last; it is sliced off below and never read.  Not a race to fix.
        buf[slot[:, j]] = xf
    buf3 = buf[: e_loc * cap].reshape(e_loc, cap, d)
    h = act(torch.bmm(buf3, p["w_gate"].to(dt))) * torch.bmm(buf3, p["w_up"].to(dt))
    y_exp = torch.bmm(h, p["w_down"].to(dt))
    y_flat = torch.cat([y_exp.reshape(e_loc * cap, d), torch.zeros((1, d), dtype=dt,
                                                                   device=x.device)], 0)
    out = torch.zeros((t, d), dtype=dt, device=x.device)
    for j in range(k):  # combine: plain gathers, no scatter-add needed
        w_j = (r.probs[:, j] * keep[:, j].to(dt))[:, None]
        out = out + y_flat[slot[:, j]] * w_j

    if p.get("shared") is not None:
        sh = p["shared"]
        hs = act(xf @ sh["gate"].to(dt)) * (xf @ sh["up"].to(dt))
        ys = hs @ sh["down"].to(dt)
        gate = torch.sigmoid((xf @ p["shared_gate"].to(dt)).float())
        out = out + ys * gate.to(dt)

    # Load-balance aux loss (Switch-style): E * sum_e f_e * p_e over real experts.
    probs_full = torch.softmax(r.logits, dim=-1)  # fp32, pads 0
    frac = torch.mean((r.onehot.reshape(t, k, e_pad).sum(1) > 0).float(), 0)
    mean_p = torch.mean(probs_full, 0)
    aux = cfg.n_experts * torch.sum(frac * mean_p)
    return out.reshape(b, s, d), aux
