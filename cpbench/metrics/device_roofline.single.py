"""The least time of the slice's exact sweeps (``cpbench.roofline``) over
the device's busy time in it, in %, in cells that decompose one tensor at
a time (moves ``sweep_ms``)."""


def read(run):
    if run.batched or run.trace is None or run.trace.busy_s <= 0 or not run.sweeps:
        return None
    return 100.0 * run.sweeps * run.least_sweep_s / run.trace.busy_s
