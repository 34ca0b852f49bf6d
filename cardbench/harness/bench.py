"""One run of a cell: the driver its mix names, the check, the metrics its
files read, and the result line."""
from __future__ import annotations

import importlib
import math
import subprocess

import torch

from harness.spec import metric_reader
from harness.trace import breakdown, busy_us


def driver(cell):
    """The driver module of the cell's mix kind (``harness/<kind>.py``)."""
    return importlib.import_module(f"harness.{cell.traffic['kind']}")


def power_limit_w() -> float | None:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=30, check=True).stdout.split()
        return float(out[0]) if out else None
    except (OSError, subprocess.SubprocessError, ValueError):
        return None


def judge(numbers: dict, limits: dict) -> tuple:
    """``(correct, checks)``: every number at or under its limit (a number
    that is not finite fails)."""
    checks = {k: {"value": float(numbers[k]), "limit": float(lim)}
              for k, lim in limits["numbers"].items()}
    ok = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
             for c in checks.values())
    return ok, checks


def check_lines(checks: dict) -> list:
    return [f"check {k} {c['value']!r} limit {c['limit']!r}"
            for k, c in checks.items()]


def read_metrics(rec: dict, entries) -> dict:
    out = {}
    for m in entries:
        value = metric_reader(m["name"])(rec)
        if value is None:
            continue
        out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def run_cell(cell, seed: int, seconds: float, trace: bool, device,
             t_start: float, fault: str | None = None) -> tuple:
    """Run, check and measure one cell; returns ``(result, checks)``."""
    drv = driver(cell)
    rec = drv.run(cell, seed, seconds, trace, device, fault)
    rec["setup_s"] = rec["window"]["t0"] - t_start
    rec["workload"] = cell.name
    numbers = drv.check(rec, seed, device, cell.limits)
    correct, checks = judge(numbers, cell.limits)
    tried, failed = drv.attempted(rec)
    if trace:
        metrics = read_metrics(rec, cell.per_layer)
    else:
        metrics = read_metrics(rec, cell.end_to_end)
        missing = [m["name"] for m in cell.end_to_end if m["name"]
                   not in metrics]
        if missing:
            raise RuntimeError(f"no reading of {missing}")
    dev = torch.device(device)
    device_info = {
        "platform": "gpu" if dev.type == "cuda" else dev.type,
        "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda"
        else "cpu",
        "count": cell.chips,
        "memory_peak_bytes": int(rec["memory_peak_bytes"]),
    }
    if dev.type == "cuda":
        device_info["power_limit_w"] = power_limit_w()
    result = {"correct": bool(correct), "attempted": int(tried),
              "failed": int(failed), "metrics": metrics,
              "device": device_info}
    if trace and rec.get("trace"):
        t = rec["trace"]
        # a run over several cards gives its busy time averaged over
        # them; one card's is its trace's
        device_info["busy_s"] = t.get("busy_s", busy_us(t["ops"]) / 1e6)
        device_info["window_s"] = t["wall_s"]
        result["breakdown"] = breakdown(t["ops"])
    result["checks"] = checks
    return result, checks
