"""Analytic parameter & MODEL_FLOPS counters (roofline's "useful flops" term).

Port of ``repro.analysis.flops``.  param_count derives from the ParamDef
tree (single source of truth with the actual init), so MoE expert padding
etc. is counted exactly as allocated.  The port's ``build_model`` allocates
its parameters, so the count reads the definition tree that ``build_model``
initializes (``decoder_defs`` / ``encdec_defs``) and allocates nothing:
dbrx-132b counts in microseconds, not 526 GB.

MODEL_FLOPS follows the brief: 6*N*D for dense training, 6*N_active*D for MoE
(N_active = non-expert params + top-k routed experts + shared experts); the
attention O(S^2) term is excluded by that convention.
"""

from __future__ import annotations

from repro_torch.configs.base import ModelConfig, ShapeConfig


def param_count(cfg: ModelConfig) -> int:
    from repro_torch.models import encdec, transformer
    from repro_torch.models.common import count_params

    defs = encdec.encdec_defs(cfg) if cfg.is_encdec else transformer.decoder_defs(cfg)
    return count_params(defs)


def _per_expert_params(cfg: ModelConfig) -> int:
    return 3 * cfg.d_model * cfg.d_ff_expert  # gate/up/down


def active_param_count(cfg: ModelConfig) -> int:
    """Params touched per token: excludes non-selected and padded experts."""
    total = param_count(cfg)
    if not cfg.n_experts:
        return total
    from repro_torch.models.moe import padded_experts

    e_pad = padded_experts(cfg.n_experts)
    inactive = (e_pad - cfg.n_experts_per_tok) * _per_expert_params(cfg) * cfg.n_layers
    return total - inactive


def model_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """MODEL_FLOPS for one step of the given shape (whole batch)."""
    n_active = active_param_count(cfg)
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens
    # decode: one token per sequence per step
    return 2.0 * n_active * shape.global_batch


def bytes_per_param(cfg: ModelConfig, training: bool) -> int:
    """fp32 master + Adam m/v when training; bf16 weights when serving."""
    return 12 if training else 2


def hbm_estimate(cfg: ModelConfig, shape: ShapeConfig, n_chips: int) -> float:
    """Rough per-chip HBM for params(+opt states), used as a sanity bound."""
    n = param_count(cfg)
    return n * bytes_per_param(cfg, shape.kind == "train") / n_chips
