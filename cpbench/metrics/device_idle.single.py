"""Share of the traced slice in which no operation ran on the device, in %,
in cells that decompose one tensor at a time (moves ``sweep_ms``)."""


def read(run):
    if run.batched or run.trace is None or not run.trace.ops or run.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
