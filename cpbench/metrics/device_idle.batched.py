"""Share of the traced slice in which no operation ran on the device, in %,
in cells that serve batches of tensors (moves ``problems_per_s``)."""


def read(run):
    if not run.batched or run.trace is None or not run.trace.ops or run.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
