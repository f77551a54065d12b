"""Faults planted under the timed path, to show that the check catches them.

Each fault replaces one function of the port for as long as it is planted
(:func:`planted`), in this process only:

* ``unchanged``: every sweep returns its state unchanged (factors, weights)
  and a fit of 0;
* ``frozen``: sweeps 2..N leave the factors and weights of sweep 1 and
  still report a fit each (that of a sweep from sweep 1's factors), so a
  decomposition reports as many fits as it was asked for;
* ``altered``: one entry of every MTTKRP is altered where it is produced;
* ``half_batch``: the service's batched decomposition returns the first
  half of the batch's answers in the second half's slots too;
* ``swapped``: one slot mix-up, the answers of a batch's first two slots
  exchanged.

The CPU tests (``test_cpbench_run.py``) plant them at a tiny size;
``python3 -m cpbench.control --fault <name>`` reads them at a cell's own
size on the card.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib


def _unchanged(real):
    def sweep(problem, plan, executor, state):
        return dataclasses.replace(state, fit=state.norm_x * 0)
    return sweep


def _frozen(real):
    def sweep(problem, plan, executor, state):
        out = real(problem, plan, executor, state)
        return out if state.it == 0 else dataclasses.replace(state, fit=out.fit)
    return sweep


def _altered(real):
    def update(plan, factors, gs, weights, n, m_n, it, *args, **kwargs):
        m_n = m_n.clone()
        m_n[..., 0, 0] += 0.01 * float(m_n.abs().max())  # one entry of each MTTKRP
        return real(plan, factors, gs, weights, n, m_n, it, *args, **kwargs)
    return update


def _half_batch(real):
    import torch

    def cp_als(*args, **kwargs):
        st = real(*args, **kwargs)
        h = st.fit.shape[0] // 2
        dup = lambda t: torch.cat([t[:h], t[:h]])  # noqa: E731
        return dataclasses.replace(st, factors=[dup(u) for u in st.factors],
                                   weights=dup(st.weights), fit=dup(st.fit))
    return cp_als


def _swapped(real):
    import torch

    def cp_als(*args, **kwargs):
        st = real(*args, **kwargs)
        perm = torch.arange(st.fit.shape[0], device=st.fit.device)
        perm[:2] = perm[:2].flip(0)
        return dataclasses.replace(st, factors=[u[perm] for u in st.factors],
                                   weights=st.weights[perm], fit=st.fit[perm])
    return cp_als


# name -> (module, attribute, maker of the replacement from the original)
FAULTS = {
    "unchanged": ("repro_torch.plan.sweep", "als_sweep", _unchanged),
    "frozen": ("repro_torch.plan.sweep", "als_sweep", _frozen),
    "altered": ("repro_torch.plan.sweep", "_update_factor", _altered),
    "half_batch": ("repro_torch.serve.cp_service", "cp_als", _half_batch),
    "swapped": ("repro_torch.serve.cp_service", "cp_als", _swapped),
}
BATCHED_ONLY = {"half_batch", "swapped"}


@contextlib.contextmanager
def planted(name: str):
    """Fault ``name`` of :data:`FAULTS` planted in the port while inside."""
    module, attr, make = FAULTS[name]
    mod = importlib.import_module(module)
    real = getattr(mod, attr)
    setattr(mod, attr, make(real))
    try:
        yield
    finally:
        setattr(mod, attr, real)
