"""Device operations in the traced slice over the sweeps in it, in cells that
decompose one tensor at a time (moves ``sweep_ms``)."""


def read(run):
    if run.batched or run.trace is None or not run.trace.ops or not run.sweeps:
        return None
    return run.trace.ops / run.sweeps
