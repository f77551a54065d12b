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
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.launch import mesh as meshlib

from .common import ParamDef, act_fn, softplus
from .scan_utils import causal_conv1d, linear_scan

Tensor = torch.Tensor

LRU_C = 8.0


class LRUState(NamedTuple):
    h: Tensor  # (B, w)
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


def _lru_coeffs(p: dict, cfg: ModelConfig, xc: Tensor):
    """xc: (B, S, w) conv output -> (a, forced) fp32 recurrence coefficients."""
    nb = _nb(cfg)
    r = torch.sigmoid(_block_diag(xc, p["gate_a_w"], p["gate_a_b"], nb).float())
    i = torch.sigmoid(_block_diag(xc, p["gate_x_w"], p["gate_x_b"], nb).float())
    log_a = -LRU_C * softplus(p["lam"].float()) * r
    a = torch.exp(log_a)
    forced = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-6)) * (i * xc.float())
    return a, forced


def rglru_apply(
    p: dict,
    cfg: ModelConfig,
    x: Tensor,
    state: LRUState | None = None,
    *,
    return_state: bool = False,
):
    """Full-sequence forward.  x: (B, S, d)."""
    dt = x.dtype
    gelu = act_fn("gelu")
    xb = x @ p["in_x"].to(dt)
    gate = x @ p["in_gate"].to(dt)
    xb = meshlib.constraint(xb, "dp", None, "tp")
    xc, conv_tail = causal_conv1d(
        xb, p["conv_w"], p["conv_b"], buf=None if state is None else state.conv
    )
    a, forced = _lru_coeffs(p, cfg, xc)
    h0 = None if state is None else state.h.float()
    h_all, h_last = linear_scan(a, forced, h0, axis=1, chunk=cfg.seq_chunk)
    y = h_all.to(dt) * gelu(gate)
    out = y @ p["out"].to(dt)
    out = meshlib.constraint(out, "dp", None, None)
    if return_state:
        return out, LRUState(h_last.to(dt), conv_tail)
    return out


def rglru_decode(
    p: dict, cfg: ModelConfig, x: Tensor, state: LRUState
) -> tuple[Tensor, LRUState]:
    """One-token step.  x: (B, 1, d)."""
    dt = x.dtype
    xb = x @ p["in_x"].to(dt)
    gate = x @ p["in_gate"].to(dt)
    xc, conv_tail = causal_conv1d(xb, p["conv_w"], p["conv_b"], buf=state.conv)
    a, forced = _lru_coeffs(p, cfg, xc)
    h = a[:, 0] * state.h.float() + forced[:, 0]
    y = h[:, None, :].to(dt) * act_fn("gelu")(gate)
    out = y @ p["out"].to(dt)
    return out, LRUState(h.to(dt), conv_tail)


def init_lru_state(cfg: ModelConfig, batch: int, dtype,
                   device: str | torch.device = "cuda") -> LRUState:
    w = cfg.lru_width or cfg.d_model
    return LRUState(torch.zeros((batch, w), dtype=dtype, device=device),
                    torch.zeros((batch, 3, w), dtype=dtype, device=device))
