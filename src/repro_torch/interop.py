"""Carry CP-ALS state between the JAX package and the port, as numpy arrays.

The two packages share no array type, so a state crosses as plain numpy:
:func:`cpstate_to_numpy` on one side, :func:`cpstate_from_numpy` on the
other.  The reference's ``CPState`` fields (``factors``, ``weights``,
``fit``, ``it``) convert with ``np.asarray``.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from repro_torch.core.cpals import CPState


def cpstate_from_numpy(
    factors: Sequence[np.ndarray],
    weights: np.ndarray,
    *,
    fit=None,
    it: int = 0,
    device: str | torch.device,
) -> CPState:
    """The port's :class:`CPState` from numpy factors/weights (copied onto
    ``device``); ``fit`` defaults to 0."""
    fs = [torch.tensor(np.asarray(f), device=device) for f in factors]
    w = torch.tensor(np.asarray(weights), device=device)
    fit_t = torch.tensor(0.0 if fit is None else np.asarray(fit), dtype=w.dtype, device=device)
    return CPState(factors=fs, weights=w, fit=fit_t, it=int(it))


def cpstate_to_numpy(state: CPState) -> dict:
    """``{"factors", "weights", "fit", "it"}`` of a port state, as numpy
    arrays (fit a 0-d array) and an int."""
    return {
        "factors": [f.detach().cpu().numpy() for f in state.factors],
        "weights": state.weights.detach().cpu().numpy(),
        "fit": np.asarray(state.fit.detach().cpu().numpy()),
        "it": int(state.it),
    }
