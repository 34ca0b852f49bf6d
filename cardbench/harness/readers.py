"""What the metric readers (``metrics/<name>.py``) share: the window's
steps, the device's peaks, and a kernel's roofline share over the traced
sub-window."""
from __future__ import annotations

from harness.spec import kernel_work, peaks
from harness.trace import busy_us, matching_us


def untraced(rec: dict) -> list:
    """The window's steps outside the profiled sub-window."""
    return [s for s in rec["steps"] if not s["traced"]]


def least_s(flops: float, nbytes: float) -> tuple:
    """The least time the device needs for a call, and which bound sets
    it."""
    pk = peaks()
    t_ops = flops / pk["bf16_flops_per_s"]
    t_bytes = nbytes / pk["hbm_bytes_per_s"]
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def roofline_percent(rec: dict, kernel: str, least_total_s: float):
    """100 x least time / device time of the kernel's operations in the
    traced sub-window; None without a trace or without work.  Work with no
    matching device time is an error: the names no longer match."""
    t = rec.get("trace")
    if not t or least_total_s <= 0:
        return None
    spent = matching_us(t["ops"], kernel_work(kernel).PATTERNS) / 1e6
    if spent <= 0:
        raise RuntimeError(f"{kernel}: work counted but no device time "
                           f"matches {kernel_work(kernel).PATTERNS}")
    return 100.0 * least_total_s / spent


def idle_percent(rec: dict):
    t = rec.get("trace")
    if not t or not t["ops"]:
        return None
    return 100.0 * (1.0 - busy_us(t["ops"]) / 1e6 / t["wall_s"])


def due_in_window(rec: dict) -> list:
    w = rec["window"]
    return [r for r in rec["requests"]
            if not r["warm"] and w["t0"] <= r["due"] < w["close"]]
