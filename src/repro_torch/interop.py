"""Carry CP-ALS state and served results between the JAX package and the
port, as numpy arrays.

The two packages share no array type, so a state crosses as plain numpy:
:func:`cpstate_to_numpy` on one side, :func:`cpstate_from_numpy` on the
other.  A batched state (leading ``B`` axis on every factor, ``(B, C)``
weights, ``(B,)`` fits) crosses the same way.  :func:`cpresult_to_numpy`
reads a served result (``CPResult``) of either package, since the
reference's fields convert with ``np.asarray``; :func:`cpresult_from_numpy`
builds the port's.  A pairwise-perturbation cache (``PPState``) crosses
the same way (:func:`ppstate_to_numpy`, :func:`ppstate_from_numpy`), so
both packages' PP sweeps can start from one state.

An LM's weights cross as a flat ``{leaf path: array}`` dict keyed by the
reference's checkpoint leaf paths (``embed``, ``layers/attn/wq``,
``final_norm/w``, ...), a scanned stack as one array with a leading layer
axis and a plain layer list by index (an enc-dec model's
``enc_layers/0/attn/wq``, ...): :func:`params_to_numpy` reads a port model's, and
:func:`params_from_numpy` loads such a dict (from the reference's
``repro.checkpoint.manager._flatten(params)``, say) into a port model.  The
port's ``CheckpointManager`` writes and reads the same mapping.  An AdamW
state (``OptState``) crosses the same way, its moments keyed like the
parameters: :func:`optstate_to_numpy` reads either package's,
:func:`optstate_from_numpy` builds the port's for a model, so both
packages' training steps can start from one state.  On a mesh the
parameters cross as each rank's blocks: ``params_from_numpy(..., mesh=)``
cuts every whole leaf to this rank's block, ``params_to_numpy(...,
params=, mesh=)`` assembles the blocks back.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from repro_torch import _tree
from repro_torch.core.cpals import CPState


def _numpy(a) -> np.ndarray:
    """A port tensor or a reference array as a numpy array."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def cpstate_from_numpy(
    factors: Sequence[np.ndarray],
    weights: np.ndarray,
    *,
    fit=None,
    it: int = 0,
    pp_exact_sweeps: int | None = None,
    device: str | torch.device,
) -> CPState:
    """The port's :class:`CPState` from numpy factors/weights (copied onto
    ``device``); ``fit`` defaults to 0 per problem (a 0-d tensor, or
    ``(B,)`` for batched ``(B, C)`` weights)."""
    fs = [torch.tensor(np.asarray(f), device=device) for f in factors]
    w = torch.tensor(np.asarray(weights), device=device)
    if fit is None:
        fit_t = torch.zeros(tuple(w.shape[:-1]), dtype=w.dtype, device=device)
    else:
        fit_t = torch.tensor(np.asarray(fit), dtype=w.dtype, device=device)
    return CPState(
        factors=fs, weights=w, fit=fit_t, it=int(it),
        pp_exact_sweeps=None if pp_exact_sweeps is None else int(pp_exact_sweeps),
    )


def cpstate_to_numpy(state) -> dict:
    """``{"factors", "weights", "fit", "it", "pp_exact_sweeps"}`` of a state
    of either package, as numpy arrays (fit a 0-d or ``(B,)`` array), an
    int, and an int or ``None``."""
    pp = state.pp_exact_sweeps
    return {
        "factors": [_numpy(f) for f in state.factors],
        "weights": _numpy(state.weights),
        "fit": np.asarray(_numpy(state.fit)),
        "it": int(state.it),
        "pp_exact_sweeps": None if pp is None else int(pp),
    }


def ppstate_to_numpy(pp) -> dict:
    """``{"ref", "pairs", "base", "drift", "n_exact"}`` of a PP cache of
    either package: numpy arrays (``pairs`` keyed by ``(n, m)``) and an
    int."""
    return {
        "ref": [_numpy(f) for f in pp.ref],
        "pairs": {tuple(k): _numpy(v) for k, v in pp.pairs.items()},
        "base": [_numpy(b) for b in pp.base],
        "drift": _numpy(pp.drift),
        "n_exact": int(pp.n_exact),
    }


def ppstate_from_numpy(
    ref: Sequence[np.ndarray],
    pairs: dict,
    base: Sequence[np.ndarray],
    drift: np.ndarray,
    n_exact: int,
    *,
    device: str | torch.device,
):
    """The port's ``PPState`` from numpy arrays (copied onto ``device``), as
    :func:`ppstate_to_numpy` gives them for a reference cache; the host copy
    of the drift maximum comes from ``drift`` itself, with no device read."""
    from repro_torch.plan.sweep import PPState  # the sweep engine, only here

    drift = np.asarray(drift, dtype=np.float32)
    return PPState(
        ref=[torch.tensor(np.asarray(f), device=device) for f in ref],
        pairs={tuple(k): torch.tensor(np.asarray(v), device=device) for k, v in pairs.items()},
        base=[torch.tensor(np.asarray(b), device=device) for b in base],
        drift=torch.tensor(drift, device=device),
        n_exact=int(n_exact),
        drift_max=float(drift.max()),
    )


def cpresult_to_numpy(result) -> dict:
    """The fields of a served ``CPResult`` of either package: factors and
    weights as numpy arrays, the rest as Python scalars and strings."""
    return {
        "rid": int(result.rid),
        "factors": [_numpy(f) for f in result.factors],
        "weights": _numpy(result.weights),
        "fit": float(result.fit),
        "sweeps": int(result.sweeps),
        "signature": str(result.signature),
        "latency_s": float(result.latency_s),
    }


def cpresult_from_numpy(fields: dict, *, device: str | torch.device):
    """The port's ``CPResult`` from :func:`cpresult_to_numpy` fields
    (factors and weights copied onto ``device``)."""
    from repro_torch.serve.cp_service import CPResult  # the serving layer, only here

    return CPResult(
        rid=int(fields["rid"]),
        factors=[torch.tensor(np.asarray(f), device=device) for f in fields["factors"]],
        weights=torch.tensor(np.asarray(fields["weights"]), device=device),
        fit=float(fields["fit"]),
        sweeps=int(fields["sweeps"]),
        signature=str(fields["signature"]),
        latency_s=float(fields["latency_s"]),
    )


def params_to_numpy(model, *, params=None, mesh=None) -> dict[str, np.ndarray]:
    """A port model's parameters as ``{reference leaf path: array}``.  With
    ``mesh``, ``params`` are this rank's blocks of ``model.partition_specs(
    mesh, drop_fsdp=True)``, assembled whole here (collectives: every rank
    calls it)."""
    if mesh is not None:
        from repro_torch.launch.mesh import assemble_tree

        params = assemble_tree(params, model.partition_specs(mesh, drop_fsdp=True), mesh)
    return _tree.flatten(model.params if params is None else params, _numpy, np.stack)


@torch.no_grad()
def params_from_numpy(model, flat: dict[str, np.ndarray], *, mesh=None):
    """Copy ``{reference leaf path: array}`` into ``model``'s parameters in
    place (each keeps its dtype and device); every parameter must be given,
    at its shape.  Returns ``model.params``; with ``mesh``, this rank's
    blocks of them under ``model.partition_specs(mesh, drop_fsdp=True)``
    (new tensors; the model keeps the whole parameters)."""
    expected = _tree.flatten(model.params, lambda p: tuple(p.shape),
                             lambda shapes: (len(shapes),) + shapes[0])
    if set(flat) != set(expected):
        missing, extra = sorted(set(expected) - set(flat)), sorted(set(flat) - set(expected))
        raise KeyError(f"params_from_numpy: missing {missing}, unexpected {extra}")

    def copy(arr, p, key):
        if tuple(np.shape(arr)) != tuple(p.shape):
            raise ValueError(f"{key}: shape {np.shape(arr)} != parameter {tuple(p.shape)}")
        a = np.asarray(arr)
        p.copy_(torch.from_numpy(a if a.flags.writeable else a.copy()))
        return p

    _tree.rebuild(model.params, lambda key: flat[key], copy)
    if mesh is None:
        return model.params
    from repro_torch.launch.mesh import shard_tree

    return shard_tree(_tree.tree_map(torch.Tensor.detach, model.params),
                      model.partition_specs(mesh, drop_fsdp=True), mesh)


def optstate_to_numpy(state) -> dict:
    """``{"step": int, "m": {leaf path: array}, "v": {...}}`` of an AdamW
    state of either package (the reference's moments are pytrees of the
    parameters' structure, a scanned stack one array)."""
    return {
        "step": int(_numpy(state.step)),
        "m": _tree.flatten(state.m, _numpy, np.stack),
        "v": _tree.flatten(state.v, _numpy, np.stack),
    }


def optstate_from_numpy(model, fields: dict):
    """The port's ``OptState`` for ``model``'s parameters from
    :func:`optstate_to_numpy` fields: fp32 moments of the parameters'
    structure, each on its parameter's device; every moment must be given,
    at its parameter's shape."""
    from repro_torch.train.optimizer import OptState  # the optimizer, only here

    def moments(flat: dict):
        def make(arr, p, key):
            if tuple(np.shape(arr)) != tuple(p.shape):
                raise ValueError(f"{key}: shape {np.shape(arr)} != parameter {tuple(p.shape)}")
            return torch.tensor(np.asarray(arr), dtype=torch.float32, device=p.device)

        return _tree.rebuild(model.params, lambda key: flat[key], make)

    device = model.device
    return OptState(torch.tensor(int(fields["step"]), dtype=torch.int32, device=device),
                    moments(fields["m"]), moments(fields["v"]))
