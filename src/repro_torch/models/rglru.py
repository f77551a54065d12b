"""RG-LRU recurrent block (recurrentgemma / Griffin).

Port of ``repro.models.rglru``.  Temporal-mixing block: x-branch linear ->
causal conv4 -> RG-LRU; gate branch linear -> GeLU (the tanh form, as
``jax.nn.gelu``); elementwise product -> out projection.

RG-LRU (Griffin eq. 1-4):
    r_t = sigmoid(BD_a(x_t)),  i_t = sigmoid(BD_x(x_t))        (block-diag gates)
    log a_t = -c * softplus(Lambda) * r_t                       (c = 8)
    h_t = a_t h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

The recurrence is elementwise over the LRU width: the parallel scan of
:func:`.scan_utils.linear_scan` in fp32, chunked only by ``cfg.seq_chunk``.
Decode state is O(1): (h (B, w), conv tail (B, 3, w)).

Tensor parallelism (an active mesh; ``tp`` ranks on ``"model"``): each rank
holds ``w / tp`` channels.  ``in_x`` and ``in_gate`` are column-parallel,
the conv and the scan local to the channels, ``out`` row-parallel: the
input enters with ``sp_gather`` (a sequence-sharded residual stream: the
scan needs the whole sequence) or ``tp_copy``, the output leaves with
``sp_scatter`` or ``tp_sum``.  The block-diagonal gates stay replicated
with ``n_heads`` blocks, which need not align with a rank's channels
(recurrentgemma at ``tp = 4``: 640-channel rank blocks over 256-channel gate
blocks), so the conv output is gathered over ``"model"`` along the channels
(its gradient, partial on each rank, reduce-scattered back), each rank
computes the gates of the blocks that hold its channels and keeps its own;
the gate weights and ``lam`` enter with ``tp_copy`` (each rank's gradient of
them is partial).  The decode state holds this rank's channels.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.dist import collectives as coll
from repro_torch.launch import mesh as meshlib

from .common import ParamDef, act_fn, softplus
from .scan_utils import causal_conv1d, linear_scan

Tensor = torch.Tensor

LRU_C = 8.0


class LRUState(NamedTuple):
    h: Tensor  # (B, w); on a mesh this rank's w / tp channels
    conv: Tensor  # (B, K-1, w)


def _nb(cfg: ModelConfig) -> int:
    return max(cfg.n_heads, 1)


def rglru_defs(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    w = cfg.lru_width or d
    nb = _nb(cfg)
    bw = w // nb
    return {
        "in_x": ParamDef((d, w), ("fsdp", "tp")),
        "in_gate": ParamDef((d, w), ("fsdp", "tp")),
        "conv_w": ParamDef((w, 4), ("tp", None), "normal", 0.2),
        "conv_b": ParamDef((w,), ("tp",), "zeros"),
        # the gates are small, so they stay replicated (the block count need
        # not divide tp)
        "gate_a_w": ParamDef((nb, bw, bw), (None, None, None)),
        "gate_a_b": ParamDef((nb, bw), (None, None), "zeros"),
        "gate_x_w": ParamDef((nb, bw, bw), (None, None, None)),
        "gate_x_b": ParamDef((nb, bw), (None, None), "zeros"),
        "lam": ParamDef((w,), (None,), "normal", 1.0),
        "out": ParamDef((w, d), ("tp", "fsdp")),
    }


def _block_diag(x: Tensor, w: Tensor, b: Tensor, nb: int) -> Tensor:
    """Block-diagonal linear: x (..., W) with W split into nb blocks."""
    shape = x.shape
    xb = x.reshape(shape[:-1] + (nb, shape[-1] // nb))
    y = torch.einsum("...nb,nbc->...nc", xb, w.to(x.dtype)) + b.to(x.dtype)
    return y.reshape(shape)


def _lru_coeffs(p: dict, cfg: ModelConfig, xc: Tensor, mesh=None):
    """xc: (B, S, w) conv output -> (a, forced) fp32 recurrence coefficients;
    on ``mesh`` this rank's ``w / tp`` channels of them (and of ``xc``)."""
    nb, gates, lam, xo = _nb(cfg), p, p["lam"], xc

    def keep(g):
        return g

    if mesh is not None:
        gates, xc, nb, keep, lam, xo = _rank_gates(p, cfg, xc, mesh)
    r = torch.sigmoid(keep(_block_diag(xc, gates["gate_a_w"], gates["gate_a_b"], nb)).float())
    i = torch.sigmoid(keep(_block_diag(xc, gates["gate_x_w"], gates["gate_x_b"], nb)).float())
    log_a = -LRU_C * softplus(lam.float()) * r
    a = torch.exp(log_a)
    forced = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-6)) * (i * xo.float())
    return a, forced


def _rank_gates(p: dict, cfg: ModelConfig, xc: Tensor, mesh):
    """This rank's view of the gates over its channels ``[c0, c0 + w / tp)``
    of the whole width ``w``: ``(gate weights of the blocks [lo, hi) that
    hold them, the gathered conv output over those blocks, hi - lo, a cut of
    a gate output to the rank's channels, lam's and the conv output's
    channels)``.  A cut spanning the whole dim is skipped, so at ``tp = 1``
    the autograd graph is the local one and a step is bitwise the local
    step."""
    tp, rank = meshlib.model_coord(mesh)
    nb = _nb(cfg)
    own = xc.shape[-1]
    bw, c0 = own * tp // nb, rank * own
    lo, hi = c0 // bw, -(-(c0 + own) // bw)

    def cut(t, start, stop):
        return t if (start, stop) == (0, t.shape[-1]) else t[..., start:stop]

    def cut0(t, start, stop):
        return t if (start, stop) == (0, t.shape[0]) else t[start:stop]

    whole = coll.sp_gather(xc, mesh, dim=-1)
    gates = {k: cut0(coll.tp_copy(p[k], mesh), lo, hi)
             for k in ("gate_a_w", "gate_a_b", "gate_x_w", "gate_x_b")}
    off = c0 - lo * bw
    return (gates, cut(whole, lo * bw, hi * bw), hi - lo, lambda g: cut(g, off, off + own),
            cut(coll.tp_copy(p["lam"], mesh), c0, c0 + own), cut(whole, c0, c0 + own))


def rglru_apply(
    p: dict,
    cfg: ModelConfig,
    x: Tensor,
    state: LRUState | None = None,
    *,
    return_state: bool = False,
    seq_sharded: bool = False,
):
    """Full-sequence forward.  x: (B, S, d); on an active mesh this rank's
    sequence block when ``seq_sharded`` (else whole), and so is the output."""
    dt = x.dtype
    gelu = act_fn("gelu")
    mesh = meshlib.active_mesh()
    if mesh is not None:
        x = coll.sp_gather(x, mesh) if seq_sharded else coll.tp_copy(x, mesh)
    xb = x @ p["in_x"].to(dt)
    gate = x @ p["in_gate"].to(dt)
    xb = meshlib.constraint(xb, "dp", None, "tp")
    xc, conv_tail = causal_conv1d(
        xb, p["conv_w"], p["conv_b"], buf=None if state is None else state.conv
    )
    a, forced = _lru_coeffs(p, cfg, xc, mesh)
    h0 = None if state is None else state.h.float()
    h_all, h_last = linear_scan(a, forced, h0, axis=1, chunk=cfg.seq_chunk)
    y = h_all.to(dt) * gelu(gate)
    out = y @ p["out"].to(dt)
    out = meshlib.constraint(out, "dp", None, None)
    if mesh is not None:
        out = coll.sp_scatter(out, mesh) if seq_sharded else coll.tp_sum(out, mesh)
    if return_state:
        return out, LRUState(h_last.to(dt), conv_tail)
    return out


def rglru_decode(
    p: dict, cfg: ModelConfig, x: Tensor, state: LRUState
) -> tuple[Tensor, LRUState]:
    """One-token step.  x: (B, 1, d)."""
    dt = x.dtype
    mesh = meshlib.active_mesh()
    if mesh is not None:
        x = coll.tp_copy(x, mesh)
    xb = x @ p["in_x"].to(dt)
    gate = x @ p["in_gate"].to(dt)
    xc, conv_tail = causal_conv1d(xb, p["conv_w"], p["conv_b"], buf=state.conv)
    a, forced = _lru_coeffs(p, cfg, xc, mesh)
    h = a[:, 0] * state.h.float() + forced[:, 0]
    y = h[:, None, :].to(dt) * act_fn("gelu")(gate)
    out = y @ p["out"].to(dt)
    if mesh is not None:
        out = coll.tp_sum(out, mesh)
    return out, LRUState(h.to(dt), conv_tail)


def init_lru_state(cfg: ModelConfig, batch: int, dtype,
                   device: str | torch.device = "cuda") -> LRUState:
    """Zero state; on an active mesh this rank's ``w / tp`` channels."""
    w = (cfg.lru_width or cfg.d_model) // meshlib.tp_active()
    return LRUState(torch.zeros((batch, w), dtype=dtype, device=device),
                    torch.zeros((batch, 3, w), dtype=dtype, device=device))
