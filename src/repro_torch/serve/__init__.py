"""``repro_torch.serve`` -- the CP serving layer: fixed-shape batches, one
dispatch state per signature.

Port of the CP half of ``repro.serve``: :class:`CPService`
(:mod:`repro_torch.serve.cp_service`) -- decomposition as a service: submit
tensors, get :class:`CPFuture` handles, batches run through
``Problem(batch=B) -> plan_sweep -> batched cp_als`` with the tuning cache
as the warm-plan store -- over the bounded FIFO+priority
:class:`RequestQueue` of :mod:`repro_torch.serve.queue` (backpressure via
:class:`QueueFull`).  The LM engine (``ServeEngine``) comes with the LM
substrate slice of the port.
"""

from .cp_service import CPFuture, CPResult, CPService
from .queue import PendingRequest, QueueFull, RequestQueue

__all__ = [
    "CPFuture",
    "CPResult",
    "CPService",
    "PendingRequest",
    "QueueFull",
    "RequestQueue",
]
