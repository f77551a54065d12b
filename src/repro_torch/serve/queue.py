"""Generic request queue + slot scheduler of the serving engine.

Port of ``repro.serve.queue`` (it has no JAX in its logic, so the port
keeps its own copy, unchanged in behaviour).  The pattern the CP serving
engine (:mod:`repro_torch.serve.cp_service`) follows: clients submit work
and get a request id back, a scheduler packs pending requests into
fixed-size batches (one dispatch per batch signature), and results stream
back as batches complete.  This module holds the engine-agnostic half:

* :class:`RequestQueue` -- a bounded in-process queue of
  :class:`PendingRequest` entries.  Requests carry a *key* (the batch
  bucket: only same-key requests may share one dispatch) and a
  *priority*; dequeue order is priority-descending, FIFO within a priority.
  A full queue rejects submission with :class:`QueueFull` -- backpressure
  the caller can surface to its own clients.
* the slot scheduler is :meth:`RequestQueue.take`: pop up to ``batch_size``
  requests of one bucket, in serving order; :meth:`RequestQueue.next_key`
  names the bucket owning the globally most urgent request, so engines that
  serve multiple signatures pick the right bucket without peeking inside.

The queue is synchronous and single-process (matching the engine's
flush-driven execution); it imports neither torch nor any device runtime.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Iterator


class QueueFull(RuntimeError):
    """Raised by :meth:`RequestQueue.submit` when the queue is at capacity.

    The bounded queue's backpressure signal: callers should retry after
    draining (``flush``/``step``) or surface the rejection to their client.
    """


@dataclass(frozen=True)
class PendingRequest:
    """One queued unit of work, as the scheduler orders it.

    ``rid`` is the queue-assigned id (also the FIFO tiebreak: rids increase
    in submission order); ``key`` is the batch bucket -- only requests with
    equal keys may be packed into one dispatch; higher ``priority``
    serves first; ``submitted_at`` (monotonic seconds) feeds the engines'
    latency accounting; ``payload`` is engine-owned and opaque here.
    """

    rid: int
    payload: Any
    key: str = ""
    priority: int = 0
    submitted_at: float = field(default_factory=time.monotonic)

    def sort_index(self) -> tuple[int, int]:
        """Serving order: priority descending, then FIFO (rid ascending)."""
        return (-self.priority, self.rid)


class RequestQueue:
    """Bounded FIFO+priority queue with per-key batch buckets.

    ``max_pending`` caps the total pending count across every bucket
    (``None`` = unbounded); hitting the cap makes :meth:`submit` raise
    :class:`QueueFull` rather than grow without bound -- the engines expose
    that as client-visible backpressure.
    """

    def __init__(self, max_pending: int | None = None):
        """Create an empty queue holding at most ``max_pending`` requests."""
        if max_pending is not None and max_pending < 1:
            raise ValueError(f"max_pending must be >= 1, got {max_pending}")
        self.max_pending = max_pending
        self._pending: dict[str, list[PendingRequest]] = {}
        self._next_rid = 0

    def __len__(self) -> int:
        """Total pending requests across every bucket."""
        return sum(len(v) for v in self._pending.values())

    def __iter__(self) -> Iterator[PendingRequest]:
        """Every pending request, in global serving order."""
        return iter(sorted(
            (r for v in self._pending.values() for r in v),
            key=PendingRequest.sort_index,
        ))

    @property
    def depth(self) -> int:
        """Current queue depth (same as ``len``; the engines' counter name)."""
        return len(self)

    def submit(self, payload: Any, *, key: str = "", priority: int = 0) -> PendingRequest:
        """Enqueue ``payload`` under bucket ``key``; returns the entry.

        Raises :class:`QueueFull` when ``max_pending`` requests are already
        waiting (the queue is left unchanged).
        """
        if self.max_pending is not None and len(self) >= self.max_pending:
            raise QueueFull(
                f"queue full: {len(self)} pending >= max_pending={self.max_pending}"
            )
        req = PendingRequest(
            rid=self._next_rid, payload=payload, key=str(key), priority=int(priority)
        )
        self._next_rid += 1
        self._pending.setdefault(req.key, []).append(req)
        return req

    def keys(self) -> list[str]:
        """Buckets with pending work, most urgent front request first."""
        return sorted(
            self._pending,
            key=lambda k: min(r.sort_index() for r in self._pending[k]),
        )

    def next_key(self) -> str | None:
        """Bucket owning the most urgent pending request; ``None`` if empty."""
        ks = self.keys()
        return ks[0] if ks else None

    def take(self, batch_size: int, key: str | None = None) -> list[PendingRequest]:
        """Pop up to ``batch_size`` requests of one bucket, in serving order.

        ``key=None`` serves the :meth:`next_key` bucket.  Returns ``[]``
        when nothing is pending (or the named bucket is empty) -- the
        engines' drain loops stop on that.
        """
        if batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, got {batch_size}")
        if key is None:
            key = self.next_key()
        bucket = self._pending.get(key or "", [])
        if not bucket:
            return []
        bucket.sort(key=PendingRequest.sort_index)
        chunk, rest = bucket[:batch_size], bucket[batch_size:]
        if rest:
            self._pending[key] = rest
        else:
            del self._pending[key]
        return chunk
