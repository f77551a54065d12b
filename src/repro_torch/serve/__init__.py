"""``repro_torch.serve`` -- the serving layer: fixed-shape batches, one
dispatch state per signature.

Port of ``repro.serve``: two engines over one pattern (clients submit work,
a scheduler packs same-signature requests into fixed-size batches, results
stream back):

* :class:`CPService` (:mod:`repro_torch.serve.cp_service`) -- decomposition
  as a service: submit tensors, get :class:`CPFuture` handles, batches run
  through ``Problem(batch=B) -> plan_sweep -> batched cp_als`` with the
  tuning cache as the warm-plan store.
* :class:`ServeEngine` (:mod:`repro_torch.serve.engine`) -- the LM engine
  (prefill + decode, greedy or sampled) over the port's models of every
  family.

Both share the bounded FIFO+priority :class:`RequestQueue` of
:mod:`repro_torch.serve.queue` (backpressure via :class:`QueueFull`).
"""

from .cp_service import CPFuture, CPResult, CPService
from .engine import GenerationConfig, Request, ServeEngine, generate
from .queue import PendingRequest, QueueFull, RequestQueue

__all__ = [
    "CPFuture",
    "CPResult",
    "CPService",
    "GenerationConfig",
    "PendingRequest",
    "QueueFull",
    "Request",
    "RequestQueue",
    "ServeEngine",
    "generate",
]
