"""The serving layer's own share of the host time in ``CPService.step()``
over the traced slice, in %: 1 - the service's ``execute_s`` (time inside
the batched ``cp_als``) / the host seconds in ``step()``.  It is the
stacking of the batch, the initial factors and the slicing of the results
(moves ``problems_per_s``)."""


def read(run):
    step_s = run.counts.get("step_host_s")
    execute_s = run.counts.get("execute_s")
    if not step_s or execute_s is None:
        return None
    return 100.0 * (1.0 - execute_s / step_s)
