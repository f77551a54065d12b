"""Shape-and-layout stand-ins of every (arch x shape) cell, and the cell's step.

Port of ``repro.launch.specs``.  A :class:`Struct` is a global shape, a
dtype and a :class:`~repro_torch.launch.mesh.NamedSharding` (a resolved
spec on a mesh): the counterpart of a ``jax.ShapeDtypeStruct`` with its
sharding.  Nothing here draws a number: parameter structs come from the
model's ``ParamDef`` tree (the counterpart of ``jax.eval_shape(model.init)``;
the model itself is built on the ``meta`` device), caches from the port's
cache constructors on ``meta``.  :func:`build_cell` returns a cell's step
and this rank's blocks of its structs (``NamedSharding.block_shape``),
allocated by ``torch.empty``: called under a
``torch._subclasses.fake_tensor.FakeTensorMode``, as the dry-run calls it,
they are fake tensors that hold no storage.

Layouts (the reference's):
  batch        -> the data axes (('pod','data') or ('data',)); replicated
                  when the batch does not divide (long_500k's batch of 1)
  params       -> train cells: FSDP x TP, the ParamDef logical specs with
                  "fsdp" (``make_train_step(fsdp=True)`` gathers them);
                  prefill and decode cells: TP only (``serve=True``)
  KV cache     -> the slot (sequence/window) axis over 'model'
                  (:class:`~repro_torch.models.attention.SeqKVCache`,
                  split-K decode: every rank reads 1/tp of the cache, and
                  kv-head counts that do not divide 16 need no copy)
  SSM/LRU state-> the inner width over 'model', the port's channel layout

The decode cache's ``length`` is a host int in the port
(``transformer.DecodeCache``); a decode cell decodes the token after a
full cache (``length = seq_len - 1``).
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any

import torch

from repro_torch._tree import map_with_specs, tree_map
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.launch import mesh as meshlib
from repro_torch.launch.mesh import NamedSharding
from repro_torch.models import Model, build_model
from repro_torch.models.common import torch_dtype
from repro_torch.train.optimizer import OptState


@dataclass(frozen=True)
class Struct:
    """A global ``shape``, a ``dtype`` and a ``sharding`` (``None``: not
    placed yet).  :attr:`block_shape` is this rank's block of it."""

    shape: tuple[int, ...]
    dtype: torch.dtype
    sharding: NamedSharding | None = None

    @property
    def block_shape(self) -> tuple[int, ...]:
        return self.sharding.block_shape(self.shape)

    def block(self, device: str | torch.device = "cpu") -> torch.Tensor:
        """An uninitialized tensor of this rank's block (fake under a
        ``FakeTensorMode``)."""
        return torch.empty(self.block_shape, dtype=self.dtype, device=device)


def _dp(mesh, batch: int):
    axes = meshlib.dp_axes(mesh)
    size = meshlib.dp_coord(mesh)[0]
    if batch % size != 0:
        return None  # replicate (batch==1 long_500k)
    return axes if len(axes) > 1 else axes[0]


def _sds(shape, dtype, mesh, spec) -> Struct:
    return Struct(tuple(shape), dtype, NamedSharding.of(mesh, spec))


def with_shardings(struct_tree: Any, spec_tree: Any, mesh) -> Any:
    """Every struct of ``struct_tree`` placed by its spec in ``spec_tree``
    (resolved specs, as ``Model.partition_specs`` gives them)."""
    return map_with_specs(lambda s, sp: Struct(tuple(s.shape), s.dtype,
                                               NamedSharding.of(mesh, sp)),
                          struct_tree, spec_tree)


# --------------------------------------------------------------------------
# Params / optimizer structs
# --------------------------------------------------------------------------
def param_structs(model: Model, mesh, *, serve: bool = False) -> Any:
    dtype = torch_dtype(model.cfg.param_dtype)
    structs = tree_map(lambda d: Struct(tuple(d.shape), dtype), model.param_defs)
    specs = model.partition_specs(mesh, drop_fsdp=serve)
    return with_shardings(structs, specs, mesh)


def opt_structs(model: Model, mesh) -> Any:
    p = param_structs(model, mesh)
    m = tree_map(lambda s: Struct(s.shape, torch.float32, s.sharding), p)
    step = _sds((), torch.int32, mesh, ())
    return OptState(step, m, tree_map(lambda s: s, m))


# --------------------------------------------------------------------------
# Batch structs
# --------------------------------------------------------------------------
def train_batch_structs(cfg: ModelConfig, shape: ShapeConfig, mesh) -> dict:
    b, s = shape.global_batch, shape.seq_len
    dp = _dp(mesh, b)
    batch = {"tokens": _sds((b, s + 1), torch.int32, mesh, (dp, None))}
    if cfg.mrope_sections:
        batch["positions"] = _sds((b, s + 1, 3), torch.int32, mesh, (dp, None, None))
    if cfg.is_encdec:
        batch["frames"] = _sds((b, s, cfg.d_model), torch.float32, mesh, (dp, None, None))
    return batch


def prefill_batch_structs(cfg: ModelConfig, shape: ShapeConfig, mesh) -> dict:
    b, s = shape.global_batch, shape.seq_len
    dp = _dp(mesh, b)
    batch = {"tokens": _sds((b, s), torch.int32, mesh, (dp, None))}
    if cfg.mrope_sections:
        batch["positions"] = _sds((b, s, 3), torch.int32, mesh, (dp, None, None))
    if cfg.is_encdec:
        batch["frames"] = _sds((b, s, cfg.d_model), torch.float32, mesh, (dp, None, None))
    return batch


# --------------------------------------------------------------------------
# Decode cache structs (layout by family; see the module docstring)
# --------------------------------------------------------------------------
def cache_structs(model: Model, shape: ShapeConfig, mesh) -> Any:
    from repro_torch.models import transformer

    cfg = model.cfg
    b, s = shape.global_batch, shape.seq_len
    dp = _dp(mesh, b)
    if cfg.is_encdec:
        return _encdec_cache_structs(model, shape, mesh, dp)
    with meshlib.manual_mode():  # the whole cache's shapes, not a rank's
        whole = transformer.init_cache(cfg, b, s, torch_dtype(cfg.compute_dtype), "meta")
    entries = [_entry_structs(e, mesh, dp) for e in whole.entries]
    return transformer.DecodeCache(entries, s - 1)


def _entry_structs(e, mesh, dp):
    from repro_torch.models.attention import KVCache, SeqKVCache
    from repro_torch.models.rglru import LRUState
    from repro_torch.models.ssm import SSMState

    def st(x, spec):
        return _sds(x.shape, x.dtype, mesh, spec)

    if isinstance(e, SSMState):  # h (B, di, N); conv (B, K-1, di)
        return SSMState(st(e.h, (dp, "model", None)), st(e.conv, (dp, None, "model")))
    if isinstance(e, LRUState):  # h (B, w); conv (B, K-1, w)
        return LRUState(st(e.h, (dp, "model")), st(e.conv, (dp, None, "model")))
    if isinstance(e, KVCache):  # (B, W, Hk, hd)
        return SeqKVCache(st(e.k, (dp, "model", None, None)), st(e.v, (dp, "model", None, None)))
    raise TypeError(type(e))


def _encdec_cache_structs(model: Model, shape: ShapeConfig, mesh, dp) -> Any:
    from repro_torch.models.attention import SeqKVCache
    from repro_torch.models.encdec import EncDecCache

    cfg = model.cfg
    b, s = shape.global_batch, shape.seq_len
    dt = torch_dtype(cfg.compute_dtype)

    def kv():
        one = (b, s, cfg.n_kv_heads, cfg.hd)
        return SeqKVCache(_sds(one, dt, mesh, (dp, "model", None, None)),
                          _sds(one, dt, mesh, (dp, "model", None, None)))

    return EncDecCache([kv() for _ in range(cfg.dec_layers)],
                       [kv() for _ in range(cfg.dec_layers)], s - 1)


def decode_token_structs(shape: ShapeConfig, mesh) -> Struct:
    dp = _dp(mesh, shape.global_batch)
    return _sds((shape.global_batch, 1), torch.int32, mesh, (dp, None))


# --------------------------------------------------------------------------
# Cell assembly: (step, this rank's blocks)
# --------------------------------------------------------------------------
def serve_config(cfg: ModelConfig) -> ModelConfig:
    """bf16 weights for inference cells."""
    return replace(cfg, param_dtype="bfloat16", remat=False)


def train_config(cfg: ModelConfig, seq_len: int) -> ModelConfig:
    # chunk long sequences (memory discipline; see models/attention.py);
    # respect an explicit seq_chunk already set on the config.  512 keeps the
    # per-chunk fp32 score tensor under ~0.5 GB even for 56-head archs.
    chunk = cfg.seq_chunk or (512 if seq_len > 8192 else 0)
    return replace(cfg, seq_chunk=chunk)


# Gradient-accumulation factors for train_4k, the reference's, so a cell is
# the same program.  The reference sized them so the per-microbatch
# activation peak fits a 16 GB chip beside the fp32 masters and AdamW
# state; an H100 has 80 GB, and the headroom each leaves there is what the
# dry-run records (argument and temp bytes a rank).
TRAIN_ACCUM: dict[str, int] = {
    "dbrx-132b": 8,
    "deepseek-coder-33b": 4,
    "qwen2-vl-7b": 2,
    "qwen3-8b": 4,
    "h2o-danube-3-4b": 2,
    "qwen2-moe-a2.7b": 2,
    "recurrentgemma-2b": 16,
    "whisper-base": 4,
    "falcon-mamba-7b": 4,
}


def train_accum(cfg: ModelConfig) -> int:
    return TRAIN_ACCUM.get(cfg.name, 1)


def cell_accum(cfg: ModelConfig, shape: ShapeConfig, mesh) -> int:
    """The accumulation a train cell's step runs on ``mesh``:
    :func:`train_accum`, at most the sequences a data rank holds.  The
    port's step cuts a rank's block into micro-batches of whole sequences;
    the reference's cuts the global batch and lets GSPMD spread a
    micro-batch thinner than the data axes (recurrentgemma-2b's 16 on the
    multipod mesh's 32 data ranks, 8 sequences each): the same tokens a
    rank in fewer, larger micro-batches."""
    rows = shape.global_batch
    if _dp(mesh, rows) is not None:
        rows //= meshlib.dp_coord(mesh)[0]
    return min(train_accum(cfg), rows)


def blocks(struct_tree: Any, device: str | torch.device = "cpu") -> Any:
    """This rank's block of every struct of ``struct_tree`` (host ints and
    other non-struct leaves as they are)."""
    return tree_map(lambda s: s.block(device) if isinstance(s, Struct) else s, struct_tree)


def build_cell(arch_cfg: ModelConfig, shape: ShapeConfig, mesh, *,
               device: str | torch.device = "cpu"):
    """Returns ``(fn, args)``: the cell's step and this rank's blocks of its
    inputs on ``device``, to run under ``use_mesh(mesh)`` (call it under a
    ``FakeTensorMode`` for fake blocks).  Train cells run
    ``make_train_step(..., fsdp=True)`` on FSDP blocks."""
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.train_step import make_train_step

    if shape.kind == "train":
        cfg = train_config(arch_cfg, shape.seq_len)
        model = build_model(cfg, device="meta")
        step = make_train_step(
            model, OptConfig(total_steps=1000), accum_steps=cell_accum(cfg, shape, mesh),
            fsdp=True,
        )
        args = (
            blocks(param_structs(model, mesh), device),
            blocks(opt_structs(model, mesh), device),
            blocks(train_batch_structs(cfg, shape, mesh), device),
        )
        return step, args

    if shape.kind == "prefill":
        cfg = train_config(serve_config(arch_cfg), shape.seq_len)
        model = build_model(cfg, device="meta")

        def prefill_step(params, batch):
            return model.prefill(params, batch, max_len=shape.seq_len + 1)

        args = (
            blocks(param_structs(model, mesh, serve=True), device),
            blocks(prefill_batch_structs(cfg, shape, mesh), device),
        )
        return prefill_step, args

    # decode
    cfg = serve_config(arch_cfg)
    model = build_model(cfg, device="meta")

    def serve_step(params, tokens, cache):
        return model.decode_step(params, tokens, cache)

    args = (
        blocks(param_structs(model, mesh, serve=True), device),
        blocks(decode_token_structs(shape, mesh), device),
        blocks(cache_structs(model, shape, mesh), device),
    )
    return serve_step, args
