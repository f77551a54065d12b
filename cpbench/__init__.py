"""The benchmark of ``repro_torch``, the PyTorch and CUDA port, on one H100.

One command runs one cell once, from the root of a checkout::

    python3 -m cpbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything a cell is made of is data that the harness finds by name:

* ``configs/<config>.json``: the problem (shape, dtype, rank, its source);
* ``workloads/<cell>.json``: the configuration, the traffic driver and its
  parameters, the sample that is checked and the limits of the check;
* ``traffic/<driver>.py``: one general driver of each kind of traffic;
* ``metrics/<metric>.py``: one reader of each per-layer metric.

The yardstick lives here too, where the program cannot move it: the data
synthesis and the plain float64 ALS (``reference/``), the bytes and
operations of an exact sweep with the card's peaks (``roofline.py``), the
reading of the device trace (``trace.py``) and the comparison that decides
``correct`` (``check.py``).  Nothing here imports ``jax`` or the JAX
package ``repro``; ``reference/`` imports nothing of ``repro_torch`` either.
"""
