"""The device trace of a steady slice of a run, and what is read from it.

:func:`record` runs a slice of the cell's work under ``torch.profiler``
with CPU and CUDA activity (a rewrite of the port's smoke-test ``_trace``,
frozen here) and keeps every device operation and every host event of the
slice.  From them come the device's busy seconds (device operations
merged where they overlap), the slice's length, the idle gaps between
device operations named by what the host was doing in each, and the
device operations that took most time.  The CPU activity costs the host a
few microseconds an operation, so a traced slice is a little more host
bound than an untraced one.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

SLICE = "cpbench.slice"
TOP = 10


@dataclass
class Trace:
    """One traced slice: the host-clock seconds of the slice (``wall_s``),
    its span on the profiler's clock (``lo_us``, ``hi_us``), and the device
    and host events ``(start_us, end_us, name)`` in start order."""

    wall_s: float
    lo_us: float
    hi_us: float
    device: list = field(default_factory=list)
    host: list = field(default_factory=list)

    @property
    def window_s(self) -> float:
        """The traced window: the slice's span on the profiler's clock, or
        the host clock's when the profiler recorded no span."""
        span = (self.hi_us - self.lo_us) * 1e-6
        return span if span > 0 else self.wall_s

    def merged(self) -> list[list[float]]:
        """Device busy intervals: the operations merged where they overlap."""
        out: list[list[float]] = []
        for a, b, _ in self.device:
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return out

    @property
    def busy_s(self) -> float:
        """Seconds in which some operation ran on the device."""
        return sum(b - a for a, b in self.merged()) * 1e-6

    @property
    def ops(self) -> int:
        """Device operations recorded in the slice."""
        return len(self.device)

    def gaps(self) -> list[tuple[float, float]]:
        """Idle stretches of the device inside the slice, ``(start, end)`` µs."""
        merged = self.merged()
        if not merged:
            return [(self.lo_us, self.hi_us)] if self.hi_us > self.lo_us else []
        edges = [(self.lo_us, merged[0][0])]
        edges += [(a[1], b[0]) for a, b in zip(merged, merged[1:])]
        edges.append((merged[-1][1], self.hi_us))
        return [(a, b) for a, b in edges if b > a]

    def host_at(self, points: list[float]) -> list[str]:
        """The innermost host event running at each of ``points`` (in
        order): a sweep over the host events in start order with a stack
        of those still open, which host events' nesting keeps exact."""
        names, stack, i = [], [], 0
        for t in points:
            while i < len(self.host) and self.host[i][0] <= t:
                while stack and stack[-1][1] < self.host[i][0]:
                    stack.pop()
                stack.append(self.host[i])
                i += 1
            while stack and stack[-1][1] < t:
                stack.pop()
            names.append(stack[-1][2] if stack else "(no host event)")
        return names

    def breakdown(self) -> dict:
        """The ``TOP`` device operations by summed seconds, and the idle
        seconds summed by what the host was doing, ``TOP`` first."""
        by_op: dict[str, float] = {}
        for a, b, name in self.device:
            by_op[name] = by_op.get(name, 0.0) + (b - a) * 1e-6
        by_host: dict[str, float] = {}
        gaps = self.gaps()
        for (a, b), name in zip(gaps, self.host_at([(a + b) / 2 for a, b in gaps])):
            by_host[name] = by_host.get(name, 0.0) + (b - a) * 1e-6
        top = lambda d: [[k[:200], v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]
        return {"device_ops": top(by_op), "idle_gaps": top(by_host)}


def record(torch, fn) -> Trace:
    """Run ``fn()`` once under ``torch.profiler`` (CPU and CUDA activity),
    synchronise, and return its :class:`Trace`."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        with record_function(SLICE):
            t0 = time.perf_counter()
            fn()
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    device, host = [], []
    lo = hi = 0.0
    for e in prof.events():
        span = (e.time_range.start, e.time_range.end, e.name)
        if e.device_type == DeviceType.CUDA:
            # a host span also shows on the device's timeline as an annotation
            if not getattr(e, "is_user_annotation", False) and not e.name.startswith("cpbench."):
                device.append(span)
        elif e.name == SLICE:
            lo, hi = span[0], span[1]
        else:
            host.append(span)
    device.sort()
    host.sort()
    return Trace(wall_s=wall, lo_us=lo, hi_us=hi, device=device, host=host)
