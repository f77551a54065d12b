"""Shared model substrate: param definitions, norms, rotary embeddings, init.

Port of ``repro.models.common``.  A :class:`ParamDef` is plain shape data
(shape, logical spec, init rule, scale); the model builds its tensors from
the definitions with an explicit ``torch.Generator`` under the reference's
std rules, on any device (``"meta"`` gives shapes with no storage).  The
numerics follow the reference: norms in fp32 and cast back, RoPE's
trigonometry in fp32 with each half cast before the concat, GELU in its
tanh form (``jax.nn.gelu``'s default).
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import Any, Callable

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch._tree import leaves, tree_map
from repro_torch.launch import mesh as meshlib

Tensor = torch.Tensor


# --------------------------------------------------------------------------
# Parameter definition trees: shapes + logical sharding specs built together
# so params and their shardings can never diverge.
# --------------------------------------------------------------------------
@dataclass(frozen=True)
class ParamDef:
    shape: tuple[int, ...]
    spec: tuple[Any, ...]  # logical axes per dim: "fsdp" | "tp" | "expert" | None
    init: str = "fan_in"  # fan_in | normal | zeros | ones | small
    scale: float = 1.0
    # the last dim is this many equal parts laid end to end (the SSM's
    # in_proj, x | z): a sharding cuts each part (mesh.PartsSpec)
    parts: int = 1

    def std(self) -> float:
        """The std of a random init: ``normal`` scale, ``small`` 0.02 x
        scale, ``fan_in`` scale / sqrt(shape[-2] (or shape[0]))."""
        if self.init == "normal":
            return self.scale
        if self.init == "small":
            return 0.02 * self.scale
        fan = self.shape[-2] if len(self.shape) >= 2 else self.shape[0]
        return self.scale / float(np.sqrt(max(fan, 1)))

    def make(self, generator: torch.Generator | None, dtype: torch.dtype,
             device: str | torch.device = "cuda") -> Tensor:
        if self.init == "zeros":
            return torch.zeros(self.shape, dtype=dtype, device=device)
        if self.init == "ones":
            return torch.ones(self.shape, dtype=dtype, device=device)
        if torch.device(device).type == "meta":
            return torch.empty(self.shape, dtype=dtype, device=device)
        x = torch.randn(self.shape, generator=generator, dtype=torch.float32, device=device)
        return (x * self.std()).to(dtype)


def is_def(x) -> bool:
    return isinstance(x, ParamDef)


def init_tree(defs: Any, generator: torch.Generator | None, dtype: torch.dtype,
              device: str | torch.device = "cuda") -> Any:
    """Initialize a tree of ParamDefs, one draw of ``generator`` a leaf in
    tree order (a stack's layers one by one)."""
    return tree_map(lambda d: d.make(generator, dtype, device), defs)


def spec_tree(defs: Any) -> Any:
    """Extract the logical-spec tree matching init_tree's output."""
    return tree_map(lambda d: d.spec, defs)


def count_params(params: Any) -> int:
    return sum(int(np.prod(p.shape)) for p in leaves(params))


def vocab_padded(vocab: int) -> int:
    """Pad the embedding-table vocab to the 128-lane boundary so the
    tensor-parallel shard is even (whisper: 51865 -> 51968).  Logit positions
    >= the true vocab are masked (see transformer.lm_logits)."""
    return -(-vocab // 128) * 128


def mask_vocab_pad(logits: Tensor, vocab: int) -> Tensor:
    """Logit positions at or past ``vocab`` set to -1e9.  On a mesh the
    last dim is this rank's vocab block (``"model"`` block ``i`` of ``tp``
    starts at ``i * V_block``), so the pad sits in the last ranks' blocks."""
    tp, i = meshlib.model_coord()
    if tp == 1 and logits.shape[-1] == vocab:
        return logits
    iota = torch.arange(logits.shape[-1], device=logits.device) + i * logits.shape[-1]
    return torch.where(iota < vocab, logits, torch.tensor(-1e9, dtype=logits.dtype,
                                                          device=logits.device))


def cast_floats(tree: Any, dtype) -> Any:
    """Mixed-precision entry cast: float leaves -> compute dtype (fp32 masters
    stay in the optimizer)."""
    dtype = torch_dtype(dtype)
    return tree_map(lambda x: x.to(dtype) if x.is_floating_point() else x, tree)


def torch_dtype(name) -> torch.dtype:
    """``"bfloat16"``/``"float32"`` (a config's dtype names) as a torch dtype."""
    if isinstance(name, torch.dtype):
        return name
    return getattr(torch, str(name))


# --------------------------------------------------------------------------
# Normalizations
# --------------------------------------------------------------------------
def rms_norm(x: Tensor, w: Tensor | None, eps: float = 1e-6) -> Tensor:
    dt = x.dtype
    x32 = x.float()
    y = x32 * torch.rsqrt(torch.mean(torch.square(x32), -1, keepdim=True) + eps)
    if w is not None:
        y = y * w.float()
    return y.to(dt)


def layer_norm(x: Tensor, w: Tensor | None, b: Tensor | None, eps: float = 1e-5) -> Tensor:
    dt = x.dtype
    x32 = x.float()
    mu = torch.mean(x32, -1, keepdim=True)
    var = torch.mean(torch.square(x32 - mu), -1, keepdim=True)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    if w is not None:
        y = y * w.float()
    if b is not None:
        y = y + b.float()
    return y.to(dt)


def norm_defs(kind: str, dim: int) -> dict:
    if kind == "rmsnorm":
        return {"w": ParamDef((dim,), (None,), "ones")}
    if kind == "layernorm":
        return {"w": ParamDef((dim,), (None,), "ones"), "b": ParamDef((dim,), (None,), "zeros")}
    if kind == "layernorm_np":  # olmo: non-parametric
        return {}
    raise ValueError(f"unknown norm {kind!r}")


def norm_apply(kind: str, x: Tensor, p: dict) -> Tensor:
    if kind == "rmsnorm":
        return rms_norm(x, p["w"])
    if kind == "layernorm":
        return layer_norm(x, p["w"], p["b"])
    if kind == "layernorm_np":
        return layer_norm(x, None, None)
    raise ValueError(f"unknown norm {kind!r}")


# --------------------------------------------------------------------------
# Rotary position embeddings: standard RoPE and Qwen2-VL M-RoPE
# --------------------------------------------------------------------------
def _inv_freq(half: int, theta: float, device=None) -> Tensor:
    return 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32, device=device) / half))


def _rotate(x: Tensor, freqs: Tensor, out_dtype=None) -> Tensor:
    """x: (..., hd) fp32; freqs: broadcastable (..., hd//2) angle array.

    The halves are cast to ``out_dtype`` BEFORE the concat so the
    concatenated tensor never materializes in fp32 (the trig math itself
    stays fp32).
    """
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half : 2 * half]
    cos, sin = torch.cos(freqs), torch.sin(freqs)
    dt = out_dtype or x.dtype
    out1 = (x1 * cos - x2 * sin).to(dt)
    out2 = (x2 * cos + x1 * sin).to(dt)
    rotated = torch.cat([out1, out2], -1)
    if 2 * half < x.shape[-1]:  # odd head_dim (danube hd=120 is even; safety)
        rotated = torch.cat([rotated, x[..., 2 * half :].to(dt)], -1)
    return rotated


def apply_rope(x: Tensor, positions: Tensor, theta: float) -> Tensor:
    """x: (B, S, H, hd); positions: (B, S) int."""
    half = x.shape[-1] // 2
    freqs = positions[..., None].float() * _inv_freq(half, theta, x.device)
    return _rotate(x.float(), freqs[:, :, None, :], out_dtype=x.dtype)


def apply_mrope(x: Tensor, positions: Tensor, sections: tuple[int, ...], theta: float) -> Tensor:
    """Qwen2-VL M-RoPE.  positions: (B, S, 3) = (temporal, height, width) ids.

    The hd//2 frequency slots are split into len(sections) groups; group g's
    angles use position stream g.  Text tokens carry identical ids in all
    three streams (degenerates to standard RoPE, as in the paper).
    """
    half = x.shape[-1] // 2
    assert sum(sections) == half, (sections, half)
    inv = _inv_freq(half, theta, x.device)
    parts = []
    start = 0
    for g, sec in enumerate(sections):
        pos_g = positions[..., g].float()  # (B, S)
        parts.append(pos_g[..., None] * inv[start : start + sec])
        start += sec
    freqs = torch.cat(parts, -1)  # (B, S, half)
    return _rotate(x.float(), freqs[:, :, None, :], out_dtype=x.dtype)


def sinusoid_positions(seq: int, dim: int, device: str | torch.device = "cuda") -> Tensor:
    """Whisper-encoder style fixed sinusoidal embeddings (S, d)."""
    pos = np.arange(seq)[:, None]
    i = np.arange(dim // 2)[None, :]
    angle = pos / np.power(10000.0, 2 * i / dim)
    out = np.concatenate([np.sin(angle), np.cos(angle)], -1)
    return torch.tensor(out, dtype=torch.float32, device=device)


# --------------------------------------------------------------------------
# Activations
# --------------------------------------------------------------------------
def _gelu(x: Tensor) -> Tensor:
    return F.gelu(x, approximate="tanh")  # jax.nn.gelu's default form


def act_fn(name: str) -> Callable[[Tensor], Tensor]:
    return {"silu": F.silu, "gelu": _gelu, "relu": F.relu}[name]


def softplus(x: Tensor) -> Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)`` at every x (``F.softplus``
    turns into the identity above its threshold)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def softcap(x: Tensor, cap: float) -> Tensor:
    return torch.tanh(x / cap) * cap if cap else x


@functools.lru_cache(maxsize=None)
def attention_scale(hd: int, dtype: torch.dtype) -> float:
    """``1 / sqrt(hd)`` with the square root rounded to ``dtype`` first, as
    the reference computes it (``1.0 / jnp.sqrt(hd).astype(q.dtype)``)."""
    root = torch.tensor(math.sqrt(hd), dtype=torch.float32).to(dtype)
    return (1.0 / root).item()
