"""Model / shape configuration schema shared by all assigned architectures.

The port's copy of ``repro.configs.base``: the same fields, defaults and
``reduced()`` rule, so ``dataclasses.asdict`` of a port config equals the
reference's field for field.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field, replace
from typing import Literal

Family = Literal["dense", "moe", "ssm", "hybrid", "encdec", "vlm"]


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: Family
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0  # 0 -> d_model // n_heads

    # --- attention options ---
    rope_theta: float = 1.0e4
    qk_norm: bool = False                     # qwen3
    sliding_window: int = 0                   # h2o-danube (0 = full)
    mrope_sections: tuple[int, ...] = ()      # qwen2-vl M-RoPE half-dim split
    norm: str = "rmsnorm"                     # rmsnorm | layernorm | layernorm_np
    act: str = "swiglu"                       # swiglu | geglu | gelu
    logit_softcap: float = 0.0

    # --- MoE ---
    n_experts: int = 0
    n_experts_per_tok: int = 0
    d_ff_expert: int = 0
    d_ff_shared: int = 0                      # qwen2-moe shared expert
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01

    # --- SSM (mamba-1) ---
    ssm_state: int = 0
    ssm_conv: int = 4
    dt_rank: int = 0
    expand: int = 2

    # --- hybrid (recurrentgemma) ---
    block_pattern: tuple[str, ...] = ()       # cycle over ('rec','rec','attn')
    local_window: int = 0                     # local attention window
    lru_width: int = 0

    # --- encoder-decoder (whisper) ---
    enc_layers: int = 0
    dec_layers: int = 0

    # --- substrate knobs ---
    tie_embeddings: bool = False
    scan_layers: bool = True
    remat: bool = True
    seq_shard: bool = True                    # Megatron-style sequence parallelism:
                                              # layer-boundary activations sharded
                                              # (dp, tp, -) -- 16x less saved-carry HBM
    compute_dtype: str = "bfloat16"
    param_dtype: str = "float32"
    seq_chunk: int = 0                        # q-chunk for long-seq attention / ssm scan
    cp_rank: int = 0                          # CP-factorized FFN (paper technique hook)

    # provenance note: "[source; verified-tier]"
    source: str = ""

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // max(self.n_heads, 1))

    @property
    def is_encdec(self) -> bool:
        return self.family == "encdec"

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def subquadratic(self) -> bool:
        """Eligible for the long_500k shape (bounded attention state)."""
        return self.family in ("ssm", "hybrid") or self.sliding_window > 0

    def reduced(self) -> "ModelConfig":
        """Smoke-test scale config of the same family (CPU-runnable)."""
        def cap(v, m):
            return min(v, m) if v else v

        pattern = self.block_pattern
        n_layers = min(self.n_layers, 3 if not pattern else len(pattern))
        return replace(
            self,
            name=self.name + "-reduced",
            n_layers=n_layers,
            d_model=cap(self.d_model, 64),
            n_heads=cap(self.n_heads, 4),
            n_kv_heads=cap(self.n_kv_heads, 2),
            head_dim=16,
            d_ff=cap(self.d_ff, 128),
            vocab=cap(self.vocab, 256),
            n_experts=cap(self.n_experts, 8),
            n_experts_per_tok=cap(self.n_experts_per_tok, 2),
            d_ff_expert=cap(self.d_ff_expert, 64),
            d_ff_shared=cap(self.d_ff_shared, 64),
            ssm_state=cap(self.ssm_state, 8),
            dt_rank=cap(self.dt_rank, 8),
            lru_width=cap(self.lru_width, 64),
            sliding_window=cap(self.sliding_window, 16),
            local_window=cap(self.local_window, 16),
            mrope_sections=(2, 3, 3) if self.mrope_sections else (),
            enc_layers=cap(self.enc_layers, 2),
            dec_layers=cap(self.dec_layers, 2),
            compute_dtype="float32",
            scan_layers=self.scan_layers,
            seq_chunk=0,
        )


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: Literal["train", "prefill", "decode"]


LM_SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


def cell_is_applicable(cfg: ModelConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """The documented skip rules (DESIGN.md 'Shape-cell skips')."""
    if shape.name == "long_500k" and not cfg.subquadratic:
        return False, "pure full-attention arch: 500k decode cache excluded by brief"
    return True, ""
