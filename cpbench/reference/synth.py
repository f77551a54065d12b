"""The synthetic fMRI study, made on the device from a seed.

A frozen copy of the data synthesis of the port's smoke test (after the
fMRI example): a tensor of time points x subjects x regions x regions with
planted rank-``rank`` structure -- positive temporal envelopes, softplus
subject loadings and symmetric rank-one network maps -- scaled to
``max |x| = 1``, plus Gaussian noise of ``noise`` times that maximum.  The
fleet's tensors are its subject slices, each made contiguous.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch


def fmri_tensor(gen: torch.Generator, shape: Sequence[int], rank: int, noise: float,
                device) -> torch.Tensor:
    """The ``(T, S, R, R)`` float32 study tensor drawn from ``gen`` (a
    generator on ``device``)."""
    t, s, r, r2 = (int(d) for d in shape)
    if r != r2:
        raise ValueError(f"the two region modes differ: {tuple(shape)}")
    tt = torch.linspace(0, 8 * math.pi, t, device=device)[:, None]
    phases = torch.rand((1, rank), generator=gen, device=device) * 2 * math.pi
    temporal = 1.0 + torch.sin(tt / (1 + torch.arange(rank, device=device)) + phases)
    subj = torch.nn.functional.softplus(torch.randn((s, rank), generator=gen, device=device))
    seeds = torch.randn((r, rank), generator=gen, device=device)
    ts = (temporal[:, None, :] * subj[None, :, :]).reshape(t * s, rank)
    nets = (seeds[:, None, :] * seeds[None, :, :]).reshape(r * r, rank)
    x = (ts @ nets.T).view(t, s, r, r)
    x /= x.abs().max()
    for k in range(t):  # noise slab by slab: no second buffer of the tensor's size
        x[k] += noise * torch.randn((s, r, r), generator=gen, device=device)
    return x


def subjects(x: torch.Tensor, mode: int) -> torch.Tensor:
    """The subject slices of ``x`` along ``mode``, stacked on a new leading
    axis and contiguous, so that ``out[i]`` is one subject's tensor."""
    return x.movedim(mode, 0).contiguous()


def derived_seed(seed: int, stream: int) -> int:
    """A generator seed for the ``stream``-th draw of a run seeded with
    ``seed`` (any integer), within ``torch.Generator.manual_seed``'s range."""
    return (int(seed) * 0x9E3779B97F4A7C15 + 0x632BE59BD9B4E019 * (stream + 1)) % (1 << 63)
