"""The device trace of a short steady sub-window, and its reduction.

``Profiled`` wraps whole steps in ``torch.profiler`` with device activity
only (recording every host operation as well would slow the steps it
measures), and keeps each device operation's interval and name.  The
busy time is the union of those intervals (the arithmetic of the port's
``chip_smoke.py::device_busy``, copied here so that the yardstick does
not move with the program); the sub-window's wall time is the host clock
around the steps, which end in a synchronize."""
from __future__ import annotations

import re

import torch

from harness.clock import now


def short_name(name: str) -> str:
    """A device op's name without its template arguments and namespaces."""
    base = name.replace("(anonymous namespace)", "")
    base = re.split(r"[<(]", base, maxsplit=1)[0]
    base = base.rsplit("::", 1)[-1].split(" ")[-1]
    return base.strip()[:80] or name[:80]


class Profiled:
    """``with Profiled(device) as p: <whole steps>``; then ``p.ops`` holds
    ``(start_us, end_us, name)`` of every device operation and ``p.wall_s``
    the sub-window's length on the host clock."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.ops: list = []
        self.wall_s = 0.0

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile

        act = ProfilerActivity.CUDA if self.device.type == "cuda" \
            else ProfilerActivity.CPU
        self._prof = profile(activities=[act])
        self._sync()
        self._prof.__enter__()
        self._t0 = now()
        return self

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def __exit__(self, *exc):
        self._sync()
        self.wall_s = now() - self._t0
        self._prof.__exit__(*exc)
        if exc[0] is not None:
            return False
        from torch.autograd import DeviceType

        want = DeviceType.CUDA if self.device.type == "cuda" \
            else DeviceType.CPU
        for e in self._prof.profiler.kineto_results.events():
            if e.device_type() == want:
                s = e.start_ns() / 1e3
                self.ops.append((s, s + e.duration_ns() / 1e3, e.name()))
        self.ops.sort()
        del self._prof
        return False


def busy_us(ops) -> float:
    """The union of the operations' intervals, in microseconds."""
    total, end = 0.0, float("-inf")
    for s, e, _ in ops:
        total += max(0.0, e - max(s, end))
        end = max(end, e)
    return total


def matching_us(ops, patterns) -> float:
    """Summed device time of the operations whose name holds a pattern."""
    return sum(e - s for s, e, n in ops if any(p in n for p in patterns))


def breakdown(ops, top: int = 10) -> dict:
    """The device operations that took most time, by short name, and the
    idle gaps between operations summed by the operation that ended each
    (what the device waited for the host to launch), in seconds."""
    by_op: dict = {}
    for s, e, n in ops:
        k = short_name(n)
        by_op[k] = by_op.get(k, 0.0) + (e - s) / 1e6
    gaps: dict = {}
    end = None
    for s, e, n in ops:
        if end is not None and s > end:
            k = f"idle before {short_name(n)}"
            gaps[k] = gaps.get(k, 0.0) + (s - end) / 1e6
        end = e if end is None else max(end, e)
    order = sorted(by_op.items(), key=lambda kv: -kv[1])[:top]
    idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[k, v] for k, v in order],
            "idle_gaps": [[k, v] for k, v in idle]}
