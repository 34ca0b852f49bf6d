"""The share of rank 0's profiled step's wall time in which an NCCL
kernel runs and no other kernel does (the collectives' time that no
computation hides): the union of all device operations less the union
of those that are not NCCL kernels, over the wall, in %; nothing where
the trace has no NCCL kernel."""
from harness.trace import busy_us


def read(rec):
    t = rec.get("trace")
    ops = t["ops"] if t else []
    other = [op for op in ops if "nccl" not in op[2].lower()]
    if len(other) == len(ops):
        return None
    return 100.0 * (busy_us(ops) - busy_us(other)) / 1e6 / t["wall_s"]
