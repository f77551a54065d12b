"""The comparison that decides ``correct``.

Each answer the timed path produced -- one decomposition's factors,
weights, fit and, where the program reports them, the fit after each
sweep -- is held against the plain ALS (:mod:`cpbench.reference.als`) run
from the same tensor and the same initial factors, which the harness made
and handed to both sides.  The numbers, read over the answers checked:

* ``early_fit_gap``: the largest ``|fit_P - fit_R|`` after the first
  sweep (every mode's MTTKRP, the solve, the normalisation and the fit,
  before the problem's conditioning has had a sweep to amplify rounding);
* ``factor_gap``: the largest relative Frobenius gap of any mode's factor
  or of the weights, ``||P - R|| / ||R||``;
* ``model_gap``: the largest relative gap of the CP model itself,
  ``||[[lambda_P; U_P]] - [[lambda_R; U_R]]|| / ||[[lambda_R; U_R]]||``,
  worked out from the factors' cross Grams without forming the tensors;
* ``fit_gap``: the largest ``|fit_P - fit_R|`` after the last sweep;
* ``median_model_gap``, ``median_fit_gap``: the median over the answers of
  ``model_gap`` and ``fit_gap``.  Sound answers of a few inputs read far
  above the rest (the problem's conditioning amplifies rounding over the
  sweeps, the float32 reference's as much as the program's), so the
  largest reading of a sample swings from seed to seed; the median does
  not, and a fault that wrongs half the answers or more moves it.

A cell compares the numbers its workload file gives a limit (``limits``):
one the lower precision of the control fails, and one a planted fault of
:mod:`cpbench.faults` fails; the others are read for the record
(:mod:`cpbench.control`).  An answer is the decomposition of its own
tensor from its own initial factors, so a single one served in the wrong
slot reads a ``model_gap`` of the order of 1, far above the largest that
rounding gives.
"""

from __future__ import annotations

import math
import statistics
from dataclasses import dataclass
from typing import Sequence

import torch

NUMBERS = ("early_fit_gap", "factor_gap", "model_gap", "fit_gap", "median_model_gap",
           "median_fit_gap")
MEDIAN = "median_"
EARLY_SWEEPS = 1

# The control of a configuration: the reference put in the program's place
# in the nearest precision below the one the configuration states.
CONTROL = {("float32", False): "tf32", ("float64", False): "float32"}


def control_precision(config: dict) -> str:
    """The precision of ``config``'s control (see :data:`CONTROL`)."""
    return CONTROL[(config["dtype"], bool(config["tf32"]))]


@dataclass
class Answer:
    """One decomposition as the program returned it: ``factors`` (per mode
    ``(I_k, C)``), ``weights`` ``(C,)``, the final ``fit`` and, where the
    program reports them, the fit after each sweep (``fits``)."""

    factors: Sequence[torch.Tensor]
    weights: torch.Tensor
    fit: float
    fits: Sequence[float] | None = None


def reference(factors, weights, fits) -> Answer:
    """An :class:`Answer` from :func:`cpbench.reference.als.cp_als`'s result."""
    return Answer(factors=factors, weights=weights, fit=fits[-1], fits=fits)


def _rel(p: torch.Tensor, r: torch.Tensor) -> float:
    p = p.to(torch.float64)
    r = r.to(torch.float64)
    return float(torch.linalg.vector_norm(p - r) / torch.linalg.vector_norm(r))


def _inner(a: Answer, b: Answer) -> torch.Tensor:
    """``<[[lambda_a; U_a]], [[lambda_b; U_b]]>`` in float64, from the cross
    Grams ``U_a^T U_b`` of every mode."""
    h = None
    for ua, ub in zip(a.factors, b.factors):
        g = ua.to(torch.float64).T @ ub.to(torch.float64)
        h = g if h is None else h * g
    return a.weights.to(torch.float64) @ h @ b.weights.to(torch.float64)


def _model_gap(got: Answer, ref: Answer) -> float:
    sq = _inner(got, got) + _inner(ref, ref) - 2.0 * _inner(got, ref)
    return float(torch.sqrt(torch.clamp(sq, min=0.0)) / torch.sqrt(_inner(ref, ref)))


def gaps(got: Answer, ref: Answer) -> dict[str, float]:
    """The numbers of one answer against its reference (``early_fit_gap``
    only where both report the fit after each sweep)."""
    bad = {name: math.inf for name in NUMBERS}
    if len(got.factors) != len(ref.factors):
        return bad
    parts = []
    for p, r in zip(list(got.factors) + [got.weights], list(ref.factors) + [ref.weights]):
        if tuple(p.shape) != tuple(r.shape):
            return bad
        parts.append(_rel(p, r))
    out = {"factor_gap": max(parts), "model_gap": _model_gap(got, ref),
           "fit_gap": abs(float(got.fit) - float(ref.fit))}
    if got.fits is not None and ref.fits is not None:
        if len(got.fits) < EARLY_SWEEPS:
            return bad
        out["early_fit_gap"] = max(abs(float(a) - float(b)) for a, b in
                                   zip(got.fits[:EARLY_SWEEPS], ref.fits[:EARLY_SWEEPS]))
    return out


def summarize(readings: Sequence[dict[str, float]], names: Sequence[str] | None = None) -> dict:
    """Each of ``names`` over the answers' readings: the largest, or for a
    ``median_`` name the median of its base number (a NaN, or a number an
    answer does not give, reads as inf); ``None``: every number that some
    answer gives."""
    if names is None:
        given = [n for n in NUMBERS if any(n in r for r in readings)]
        names = given + [MEDIAN + n for n in given if MEDIAN + n in NUMBERS]
    out = {}
    for name in names:
        base = name.removeprefix(MEDIAN)
        vals = [r.get(base, math.inf) for r in readings]
        vals = [v if math.isfinite(v) else math.inf for v in vals]
        if not vals:
            out[name] = math.inf
        elif name.startswith(MEDIAN):
            out[name] = statistics.median(vals)
        else:
            out[name] = max(vals)
    return out


def verdict(readings: Sequence[dict[str, float]], limits: dict[str, float]) -> tuple[bool, dict]:
    """``correct`` and the printed checks ``{name: {"value", "limit"}}``: the
    reading of every number that has a limit at or under it, and no answer
    whose reading of it is not a number."""
    numbers = summarize(readings, list(limits))
    checks = {name: {"value": numbers[name], "limit": float(limits[name])} for name in limits}
    ok = bool(checks) and all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                              for c in checks.values())
    bases = {name.removeprefix(MEDIAN) for name in limits}
    ok = ok and all(math.isfinite(r.get(b, math.inf)) for r in readings for b in bases)
    return ok, checks


def sample(n_answers: int, k: int, seed: int) -> list[int]:
    """``k`` answer indices drawn from ``seed`` (all of them when fewer),
    in order; the last answer is always among them."""
    if n_answers <= k:
        return list(range(n_answers))
    gen = torch.Generator().manual_seed(int(seed) % (1 << 63))
    picked = torch.randperm(n_answers - 1, generator=gen)[: k - 1].tolist()
    return sorted(picked) + [n_answers - 1]
