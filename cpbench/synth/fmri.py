"""The synthetic fMRI study (:mod:`cpbench.reference.synth`): the ``(T, S, R,
R)`` study tensor, or with ``subject_mode`` its subject slices stacked on a
leading axis, in the configuration's dtype.

Configuration keys: ``shape``, ``planted_rank``, ``noise``, ``dtype`` and,
for a fleet, ``subject_mode``.
"""

from __future__ import annotations

import torch

from cpbench.reference import synth

# The study's order, with its two region modes equal, at a size the CPU tests
# run in a second.
TINY_SHAPE = (12, 7, 8, 8)


def make(gen: torch.Generator, config: dict, device) -> torch.Tensor:
    """``config``'s data drawn from ``gen`` (a generator on ``device``)."""
    x = synth.fmri_tensor(gen, config["shape"], int(config["planted_rank"]),
                          float(config["noise"]), device, getattr(torch, config["dtype"]))
    if "subject_mode" in config:
        x = synth.subjects(x, int(config["subject_mode"]))
    return x
