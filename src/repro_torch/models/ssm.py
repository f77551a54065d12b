"""Mamba-1 selective-SSM block (falcon-mamba-7b).

Port of ``repro.models.ssm``.  Block: in_proj -> (x | z); causal depthwise
conv4 + SiLU on x; data-dependent (Delta, B, C); discretize
h_t = exp(Delta A) h_{t-1} + Delta B x_t;  y = C h + D x;
out = (y * SiLU(z)) @ out_proj.

The recurrence is the chunked scan of :func:`.scan_utils.linear_scan`
(default chunk 128 when S > 128, as the reference).  The gate math runs in
fp32 and the scanned pair is cast to the compute dtype before the scan, as
the reference does; ``softplus`` is ``logaddexp(x, 0)`` (``jax.nn.softplus``;
``F.softplus`` turns into the identity above 20).  Decode carries an O(1)
state (h: (B, d_inner, d_state), conv tail: (B, K-1, d_inner)), updated in
fp32 and stored in the compute dtype.

Tensor parallelism (an active mesh; ``tp`` ranks on ``"model"``): each rank
holds ``d_inner / tp`` channels.  ``in_proj`` is column-parallel, cut part
by part (its ``x | z`` halves each give this rank its block), the conv,
``a_log``, ``d_skip``, the biases and the scan are local to the channels,
and ``out_proj`` is row-parallel: the input enters with ``sp_gather`` (a
sequence-sharded residual stream: the scan needs the whole sequence) or
``tp_copy``, the output leaves with ``sp_scatter`` or ``tp_sum``.
``x_proj`` is row-parallel too: its ``(dt_rank + 2N)`` outputs are the
ranks' partials summed, and every rank's use of the sum (``dt_w``'s columns,
B and C against its own channels) is partial, so the sum's gradient is
summed as well (``tp_copy(tp_sum(.))``).  The decode state holds this
rank's channels.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.dist import collectives as coll
from repro_torch.launch import mesh as meshlib

from .common import ParamDef, softplus
from .scan_utils import causal_conv1d, linear_scan

Tensor = torch.Tensor


class SSMState(NamedTuple):
    h: Tensor  # (B, d_inner, N); on a mesh this rank's d_inner / tp channels
    conv: Tensor  # (B, K-1, d_inner)


def ssm_defs(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    di = cfg.expand * d
    n = cfg.ssm_state
    k = cfg.ssm_conv
    dtr = cfg.dt_rank
    return {
        "in_proj": ParamDef((d, 2 * di), ("fsdp", "tp"), parts=2),  # x | z
        "conv_w": ParamDef((di, k), ("tp", None), "normal", 0.2),
        "conv_b": ParamDef((di,), ("tp",), "zeros"),
        "x_proj": ParamDef((di, dtr + 2 * n), ("tp", None)),
        "dt_w": ParamDef((dtr, di), (None, "tp")),
        "dt_b": ParamDef((di,), ("tp",), "ones"),  # softplus(1) ~ healthy init dt
        "a_log": ParamDef((di, n), ("tp", None), "normal", 0.5),
        "d_skip": ParamDef((di,), ("tp",), "ones"),
        "out_proj": ParamDef((di, d), ("tp", "fsdp")),
    }


def _delta_bc(p: dict, cfg: ModelConfig, xc: Tensor, mesh=None):
    """xc: (B, S, di) conv output -> (delta (B,S,di), B (B,S,N), C (B,S,N))."""
    dt = xc.dtype
    dtr, n = cfg.dt_rank, cfg.ssm_state
    x_db = xc @ p["x_proj"].to(dt)
    if mesh is not None:  # summed forward and backward (see the module docstring)
        x_db = coll.tp_copy(coll.tp_sum(x_db, mesh), mesh)
    dt_r, b_in, c_in = torch.split(x_db, [dtr, n, n], dim=-1)
    delta = softplus((dt_r @ p["dt_w"].to(dt)).float() + p["dt_b"].float())
    return delta, b_in.float(), c_in.float()


def ssm_apply(
    p: dict,
    cfg: ModelConfig,
    x: Tensor,
    state: SSMState | None = None,
    *,
    return_state: bool = False,
    seq_sharded: bool = False,
):
    """Full-sequence forward.  x: (B, S, d); on an active mesh this rank's
    sequence block when ``seq_sharded`` (else whole), and so is the output."""
    dt = x.dtype
    mesh = meshlib.active_mesh()
    if mesh is not None:
        x = coll.sp_gather(x, mesh) if seq_sharded else coll.tp_copy(x, mesh)
    xz = x @ p["in_proj"].to(dt)
    xz = meshlib.constraint(xz, "dp", None, "tp")
    xr, z = torch.chunk(xz, 2, dim=-1)
    xc, conv_tail = causal_conv1d(
        xr, p["conv_w"], p["conv_b"], buf=None if state is None else state.conv
    )
    xc = F.silu(xc)

    delta, b_in, c_in = _delta_bc(p, cfg, xc, mesh)
    a = -torch.exp(p["a_log"].float())  # (di, N)
    # Discretize: decay (B,S,di,N), forced (B,S,di,N).  The gate math runs
    # fp32; the scanned pair is cast to the compute dtype before the scan.
    decay = torch.exp(delta[..., None] * a).to(dt)
    forced = ((delta * xc.float())[..., None] * b_in[:, :, None, :]).to(dt)
    h0 = None if state is None else state.h.to(dt)
    chunk = cfg.seq_chunk or (128 if x.shape[1] > 128 else 0)
    h_all, h_last = linear_scan(decay, forced, h0, axis=1, chunk=chunk)
    y = torch.einsum("bsdn,bsn->bsd", h_all.float(), c_in).to(dt)
    y = y + xc * p["d_skip"].to(dt)
    out = (y * F.silu(z)) @ p["out_proj"].to(dt)
    out = meshlib.constraint(out, "dp", None, None)
    if mesh is not None:
        out = coll.sp_scatter(out, mesh) if seq_sharded else coll.tp_sum(out, mesh)
    if return_state:
        return out, SSMState(h_last.to(dt), conv_tail)
    return out


def ssm_decode(
    p: dict, cfg: ModelConfig, x: Tensor, state: SSMState
) -> tuple[Tensor, SSMState]:
    """One-token step.  x: (B, 1, d); O(1) state update."""
    dt = x.dtype
    mesh = meshlib.active_mesh()
    if mesh is not None:
        x = coll.tp_copy(x, mesh)
    xz = x @ p["in_proj"].to(dt)
    xr, z = torch.chunk(xz, 2, dim=-1)
    xc, conv_tail = causal_conv1d(xr, p["conv_w"], p["conv_b"], buf=state.conv)
    xc = F.silu(xc)
    delta, b_in, c_in = _delta_bc(p, cfg, xc, mesh)
    a = -torch.exp(p["a_log"].float())
    decay = torch.exp(delta[:, 0, :, None] * a)  # (B, di, N)
    forced = (delta[:, 0] * xc[:, 0].float())[..., None] * b_in[:, 0, None, :]
    h = decay * state.h.float() + forced
    y = torch.einsum("bdn,bn->bd", h, c_in[:, 0])[:, None, :].to(dt)
    y = y + xc * p["d_skip"].to(dt)
    out = (y * F.silu(z)) @ p["out_proj"].to(dt)
    if mesh is not None:
        out = coll.tp_sum(out, mesh)
    return out, SSMState(h.to(dt), conv_tail)


def init_ssm_state(cfg: ModelConfig, batch: int, dtype,
                   device: str | torch.device = "cuda") -> SSMState:
    """Zero state; on an active mesh this rank's ``d_inner / tp`` channels."""
    di = cfg.expand * cfg.d_model // meshlib.tp_active()
    return SSMState(
        torch.zeros((batch, di, cfg.ssm_state), dtype=dtype, device=device),
        torch.zeros((batch, cfg.ssm_conv - 1, di), dtype=dtype, device=device),
    )
