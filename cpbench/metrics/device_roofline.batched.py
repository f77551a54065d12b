"""The least time of the slice's exact batch sweeps (``cpbench.roofline``)
over the device's busy time in it, in %, in cells that serve batches of
tensors (moves ``problems_per_s``)."""


def read(run):
    if not run.batched or run.trace is None or run.trace.busy_s <= 0 or not run.sweeps:
        return None
    return 100.0 * run.sweeps * run.least_sweep_s / run.trace.busy_s
