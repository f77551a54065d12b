"""Device operations in the traced slice over the sweeps in it, in cells that
serve batches of tensors (moves ``problems_per_s``)."""


def read(run):
    if not run.batched or run.trace is None or not run.trace.ops or not run.sweeps:
        return None
    return run.trace.ops / run.sweeps
