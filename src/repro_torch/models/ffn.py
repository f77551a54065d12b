"""Dense FFN variants (SwiGLU / GeGLU / GELU-MLP) + CP-factorized option.

Port of ``repro.models.ffn``.  The CP-factorized path is the paper-technique
hook: with ``cfg.cp_rank = r > 0`` the up/gate/down weights are replaced by
rank-r CP factor pairs  W ~= A @ B  (a 2-way CP model, i.e. columns are the
rank-1 terms).  :func:`repro_torch.core.cp_layers.compress_ffn` converts a
dense FFN's ``{gate, up, down}`` into exactly these ``{name}_a``/``{name}_b``
parameters.

Tensor parallelism (an active mesh): ``gate``/``up`` are column-parallel
and ``down`` row-parallel over ``"model"``; in the CP-factorized FFN
``gate_b``/``up_b`` are column-parallel and ``down_a`` row-parallel, so the
ranks' partials meet as a ``(B, S, r)`` sum before the replicated
``down_b``.  The input enters with ``sp_gather`` (a sequence-sharded
residual stream) or ``tp_copy``, the output leaves with ``sp_scatter`` or
``tp_sum``; the replicated ``gate_a``/``up_a`` (and ``down_b`` on a
sequence block) enter with ``tp_copy``, their gradient partial on each
rank.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.dist import collectives as coll
from repro_torch.launch import mesh as meshlib

from .common import ParamDef, act_fn

Tensor = torch.Tensor


def ffn_defs(cfg: ModelConfig, d_ff: int | None = None) -> dict:
    d = cfg.d_model
    f = d_ff if d_ff is not None else cfg.d_ff
    if cfg.cp_rank:
        r = cfg.cp_rank
        return {
            "gate_a": ParamDef((d, r), ("fsdp", None)),
            "gate_b": ParamDef((r, f), (None, "tp")),
            "up_a": ParamDef((d, r), ("fsdp", None)),
            "up_b": ParamDef((r, f), (None, "tp")),
            "down_a": ParamDef((f, r), ("tp", None)),
            "down_b": ParamDef((r, d), (None, "fsdp")),
        }
    if cfg.act in ("swiglu", "geglu"):
        return {
            "gate": ParamDef((d, f), ("fsdp", "tp")),
            "up": ParamDef((d, f), ("fsdp", "tp")),
            "down": ParamDef((f, d), ("tp", "fsdp")),
        }
    # plain MLP (whisper)
    return {
        "up": ParamDef((d, f), ("fsdp", "tp")),
        "down": ParamDef((f, d), ("tp", "fsdp")),
    }


def ffn_apply(p: dict, cfg: ModelConfig, x: Tensor, *, seq_sharded: bool = False) -> Tensor:
    """The FFN of ``x``.  On an active mesh ``x`` is this rank's sequence
    block when ``seq_sharded`` (else whole), and so is the output."""
    dt = x.dtype
    act = act_fn({"swiglu": "silu", "geglu": "gelu", "gelu": "gelu"}[cfg.act])
    mesh = meshlib.active_mesh()
    if mesh is not None:
        x = coll.sp_gather(x, mesh) if seq_sharded else coll.tp_copy(x, mesh)

        def leave(partial):
            return coll.sp_scatter(partial, mesh) if seq_sharded else coll.tp_sum(partial, mesh)

        def enter(w):  # a replicated weight whose gradient is partial here
            return coll.tp_copy(w, mesh)
    else:
        def leave(partial):
            return partial

        def enter(w):
            return w
    if cfg.cp_rank:
        gate = (x @ enter(p["gate_a"]).to(dt)) @ p["gate_b"].to(dt)
        up = (x @ enter(p["up_a"]).to(dt)) @ p["up_b"].to(dt)
        h = act(gate) * up
        h = meshlib.constraint(h, "dp", None, "tp")
        t = leave(h @ p["down_a"].to(dt))
        down_b = enter(p["down_b"]) if seq_sharded else p["down_b"]
        return t @ down_b.to(dt)
    if cfg.act in ("swiglu", "geglu"):
        h = act(x @ p["gate"].to(dt)) * (x @ p["up"].to(dt))
        h = meshlib.constraint(h, "dp", None, "tp")
        return leave(h @ p["down"].to(dt))
    h = act(x @ p["up"].to(dt))
    h = meshlib.constraint(h, "dp", None, "tp")
    return leave(h @ p["down"].to(dt))
