"""Model facade: build_model(cfg) -> an ``nn.Module`` with the reference's
init / loss / prefill / decode interfaces.

Port of ``repro.models.model``.  :class:`Model` holds its parameters as
``nn.Parameter``s built from the param-definition tree with an explicit
``torch.Generator``, on an explicit device (``"cuda"`` unless the caller
asks otherwise; ``"meta"`` gives shapes with no storage).  ``model.params``
is the tree of those parameters in the reference's structure (dicts, with a
scanned stack's layers in a :class:`repro_torch._tree.Stacked` list), and
the interfaces take a params tree explicitly, as the reference's pure
functions do.  Serving (``prefill``, ``decode_step``) runs without
autograd; ``loss_fn`` is the forward pass of training.
"""

from __future__ import annotations

from typing import Any

import torch
from torch import nn

from repro_torch._tree import tree_map
from repro_torch.configs.base import ModelConfig
from repro_torch.launch import mesh as meshlib

from . import encdec, transformer
from .attention import KVCache
from .common import cast_floats, init_tree, spec_tree, torch_dtype
from .rglru import LRUState
from .ssm import SSMState

Tensor = torch.Tensor


def cross_entropy(logits: Tensor, labels: Tensor) -> tuple[Tensor, Tensor]:
    """Mean next-token CE + accuracy.  logits: (B, S, V); labels: (B, S).

    On an active mesh ``logits`` is this rank's vocab block (``"model"``
    block ``i`` of ``V / tp`` columns), as the reference's vocab axis is
    tensor-parallel: the log-sum-exp comes from the blocks' own, the label
    logit from the block that holds it (the others add zero), the accuracy
    from the blocks' maxima (the first rank holding the largest, as
    ``argmax`` takes the first); every cross-rank sum runs in rank order."""
    mesh = meshlib.active_mesh()
    if mesh is not None:
        return _cross_entropy_blocks(logits, labels, mesh)
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    loss = torch.mean(lse - ll)
    acc = torch.mean((torch.argmax(logits, -1) == labels).float())
    return loss, acc


def _cross_entropy_blocks(logits: Tensor, labels: Tensor, mesh) -> tuple[Tensor, Tensor]:
    from repro_torch.dist import collectives as coll

    _, i = meshlib.model_coord(mesh)
    group = mesh.get_group(coll.AXIS)
    logits = logits.float()
    n = logits.shape[-1]
    lse_i = torch.logsumexp(logits, dim=-1)
    top = torch.stack(coll._gather(lse_i.detach(), group)).amax(0)
    # one rank: top is its own lse, exp(0) = 1 and log(1) = 0, bit for bit
    lse = top + torch.log(coll.tp_sum(torch.exp(lse_i - top), mesh))
    local = labels.long() - i * n
    held = (local >= 0) & (local < n)
    ll_i = torch.gather(logits, -1, local.clamp(0, n - 1)[..., None])[..., 0]
    ll = coll.tp_sum(torch.where(held, ll_i, torch.zeros((), device=ll_i.device)), mesh)
    loss = torch.mean(lse - ll)
    with torch.no_grad():
        best, arg = logits.max(-1)
        bests = torch.stack(coll._gather(best, group))  # (tp, B, S)
        args = torch.stack(coll._gather(arg + i * n, group))
        first = torch.argmax(bests, 0)  # the first rank holding the largest
        pred = torch.gather(args, 0, first[None])[0]
        acc = torch.mean((pred == labels).float())
    return loss, acc


def _register(module: nn.Module, tree: dict) -> None:
    """Register a dict of parameters and subtrees on ``module``: tensors as
    parameters, dicts as submodules, lists as ``nn.ModuleList``s."""

    def child(node) -> nn.Module:
        if isinstance(node, (list, tuple)):
            return nn.ModuleList(child(t) for t in node)
        m = nn.Module()
        _register(m, node)
        return m

    for key, node in tree.items():
        if isinstance(node, nn.Parameter):
            module.register_parameter(key, node)
        else:
            module.add_module(key, child(node))


class Model(nn.Module):
    def __init__(self, cfg: ModelConfig, param_defs: Any, *, device: str | torch.device = "cuda",
                 generator: torch.Generator | None = None):
        super().__init__()
        self.cfg = cfg
        self.param_defs = param_defs
        tree = init_tree(param_defs, generator, torch_dtype(cfg.param_dtype), device)
        self._params = tree_map(nn.Parameter, tree)
        _register(self, self._params)

    @property
    def params(self) -> Any:
        """The parameters as the reference's params tree."""
        return self._params

    @property
    def device(self) -> torch.device:
        return self._params["embed"].device

    def init(self, generator: torch.Generator | None = None) -> Any:
        """A freshly initialized params tree (plain tensors, this model's
        device), drawn from ``generator``."""
        return init_tree(self.param_defs, generator, torch_dtype(self.cfg.param_dtype),
                         self.device)

    def logical_specs(self) -> Any:
        return spec_tree(self.param_defs)

    def partition_specs(self, mesh, *, drop_fsdp: bool = False) -> Any:
        """Each parameter's logical spec resolved on ``mesh`` (a tuple of mesh
        axis names, one entry a dim); ``drop_fsdp=True`` keeps only tensor
        parallelism, the serving layout.  A leaf of equal parts (``in_proj``)
        gets a :class:`~repro_torch.launch.mesh.PartsSpec`, equal to the
        plain tuple, which the port's shardings cut part by part."""

        def resolve(d):
            spec = d.spec
            if drop_fsdp:
                spec = tuple(None if ax == "fsdp" else ax for ax in spec)
            spec = meshlib.resolve_logical(spec, mesh)
            return meshlib.PartsSpec(spec, d.parts) if d.parts > 1 else spec

        return tree_map(resolve, self.param_defs)

    # ---- training ----
    def loss_fn(self, params: Any, batch: dict) -> tuple[Tensor, dict]:
        cfg = self.cfg
        params = cast_floats(params, cfg.compute_dtype)
        if cfg.is_encdec:
            enc_out = encdec.encode(params, cfg, batch["frames"])
            logits = encdec.decode_train(params, cfg, batch["tokens"][:, :-1], enc_out)
            loss, acc = cross_entropy(logits, batch["tokens"][:, 1:])
            return loss, {"ce": loss, "acc": acc}
        tokens = batch["tokens"]
        positions = batch.get("positions")
        if positions is not None:
            positions = positions[:, : tokens.shape[1] - 1]
        h, aux, _ = transformer.forward(params, cfg, tokens[:, :-1], positions)
        logits = transformer.lm_logits(params, cfg, h)
        loss, acc = cross_entropy(logits, tokens[:, 1:])
        total = loss + cfg.router_aux_weight * aux if cfg.n_experts else loss
        return total, {"ce": loss, "acc": acc, "aux": aux}

    # ---- serving ----
    @torch.no_grad()
    def prefill(self, params: Any, batch: dict, max_len: int) -> tuple[Any, Tensor]:
        """Process the prompt; returns (cache, last-token logits).

        An enc-dec model encodes ``batch["frames"]`` and decodes only the
        prompt's first token (``tokens[:, :1]``), as the reference does.
        """
        cfg = self.cfg
        dt = torch_dtype(cfg.compute_dtype)
        tokens = batch["tokens"]
        if cfg.is_encdec:
            enc_out = encdec.encode(params, cfg, batch["frames"])
            cache = encdec.init_encdec_cache(params, cfg, enc_out, max_len, dt)
            logits, cache = encdec.decode_step(params, cfg, tokens[:, :1], cache)
            return cache, logits
        b, s = tokens.shape
        h, _, collected = transformer.forward(
            params, cfg, tokens, batch.get("positions"), collect_cache=True
        )  # h is already final-normed
        cache = transformer.init_cache(cfg, b, max_len, dt, tokens.device)
        entries = _fill_cache(cache.entries, collected, s)
        logits = transformer.lm_logits(params, cfg, h[:, -1:, :])
        return transformer.DecodeCache(entries, s), logits

    @torch.no_grad()
    def decode_step(self, params: Any, tokens: Tensor, cache: Any):
        if self.cfg.is_encdec:
            return encdec.decode_step(params, self.cfg, tokens, cache)
        return transformer.decode_step(params, self.cfg, tokens, cache)

    def init_cache(self, batch: int, max_len: int) -> Any:
        cfg = self.cfg
        assert not cfg.is_encdec, "enc-dec caches come from prefill()"
        return transformer.init_cache(cfg, batch, max_len, torch_dtype(cfg.compute_dtype),
                                      self.device)


def _fill_cache(entries: list, collected: list, s: int) -> list:
    """Write prefill K/V (or recurrent states) into a fresh decode cache,
    layer by layer.

    Ring invariant (attention.attn_decode): the token at absolute position p
    lives at slot ``p % W``.  When the prompt is longer than the window we
    keep the last W tokens and roll them so position p lands at slot p % W --
    the next decode write (slot s % W) then correctly evicts the oldest.
    """
    out = []
    for entry, col in zip(entries, collected):
        if isinstance(entry, (SSMState, LRUState)):
            out.append(type(entry)(*(c.to(e.dtype) for e, c in zip(entry, col))))
            continue
        k, v = col  # (B, S, Hk, hd)
        w = entry.k.shape[1]
        if s >= w:
            k = torch.roll(k[:, s - w : s], s % w, dims=1)
            v = torch.roll(v[:, s - w : s], s % w, dims=1)
            out.append(KVCache(k.to(entry.k.dtype), v.to(entry.v.dtype)))
        else:
            entry.k[:, :s] = k.to(entry.k.dtype)
            entry.v[:, :s] = v.to(entry.v.dtype)
            out.append(entry)
    return out


def build_model(cfg: ModelConfig, *, device: str | torch.device = "cuda",
                generator: torch.Generator | None = None) -> Model:
    """The model of ``cfg`` with parameters drawn from ``generator`` on
    ``device``: the enc-dec backbone for an enc-dec config, else the
    decoder-only stack."""
    defs = encdec.encdec_defs(cfg) if cfg.is_encdec else transformer.decoder_defs(cfg)
    return Model(cfg, defs, device=device, generator=generator)

