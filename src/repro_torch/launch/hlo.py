"""Collective census and roofline terms of a dry run — the port of the
JAX package's ``launch/hlo.py``.

The JAX dry run parses the optimized HLO for its collectives.  The port
has no HLO: its dry run (``launch.dryrun``) records every
``torch.distributed`` collective one rank's eager program calls, and
:func:`collective_census` takes those records — ``(op, result bytes,
group size)``, the op in JAX's names (``all-gather``, ``all-reduce``,
``reduce-scatter``, ``all-to-all``, ``collective-permute`` for a
point-to-point send).  Each record converts to *per-device link bytes*
with the ring-algorithm factors of the JAX module.

Hardware constants: the NVIDIA data sheet's figures for the NVIDIA H100
80GB HBM3 (SXM), 700 W — a reckoning from published peaks, not a speed
measured on a card.
"""
from __future__ import annotations

from dataclasses import dataclass, field

#: dense bf16 tensor-core flop/s (data sheet, NVIDIA H100 80GB HBM3 (SXM),
#: 700 W)
PEAK_FLOPS = 989e12
#: HBM3 bytes/s (data sheet, NVIDIA H100 80GB HBM3 (SXM), 700 W)
HBM_BW = 3.35e12
#: bytes/s a GPU sends over its links along one mesh axis: one ConnectX-7
#: NDR 400 Gb/s InfiniBand port per GPU (data sheet).  A 16-wide axis spans
#: two 8-GPU DGX H100 nodes, so its rings cross InfiniBand.
LINK_BW = 50e9
#: NVLink 4 bytes/s a direction within one node (data sheet, NVIDIA H100
#: 80GB HBM3 (SXM), 700 W), for a reader whose axis stays inside a node
NVLINK_BW = 450e9

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")


def _link_factor(op: str, n: int) -> float:
    """Per-device link bytes as a multiple of the result bytes (ring
    algorithms).  reduce-scatter's result is the shard, hence (n-1)."""
    if op == "all-gather":
        return (n - 1) / n
    if op == "all-reduce":
        return 2 * (n - 1) / n
    if op == "reduce-scatter":
        return float(n - 1)
    if op == "all-to-all":
        return (n - 1) / n
    return 1.0                 # collective-permute


@dataclass
class CollectiveCensus:
    ops: list = field(default_factory=list)   # (op, result_bytes, group, link)
    by_op: dict = field(default_factory=dict)
    total_result_bytes: int = 0
    total_link_bytes: float = 0.0

    def add(self, op: str, rbytes: int, group: int):
        link = rbytes * _link_factor(op, group)
        self.ops.append((op, rbytes, group, link))
        agg = self.by_op.setdefault(op, {"count": 0, "bytes": 0,
                                         "link_bytes": 0.0})
        agg["count"] += 1
        agg["bytes"] += rbytes
        agg["link_bytes"] += link
        self.total_result_bytes += rbytes
        self.total_link_bytes += link

    def summary(self) -> dict:
        return {
            "by_op": self.by_op,
            "total_result_bytes": self.total_result_bytes,
            "total_link_bytes": self.total_link_bytes,
            "num_ops": len(self.ops),
        }


def collective_census(records) -> CollectiveCensus:
    """The census of ``(op, result bytes, group size)`` records."""
    census = CollectiveCensus()
    for op, rbytes, group in records:
        if op not in COLLECTIVES:
            raise ValueError(f"collective {op!r}: one of {COLLECTIVES}")
        census.add(op, rbytes, group)
    return census


def roofline_terms(flops_per_device: float, hbm_bytes_per_device: float,
                   link_bytes_per_device: float) -> dict:
    """The three roofline terms, in seconds, from per-device quantities
    and the data-sheet peaks above."""
    compute = flops_per_device / PEAK_FLOPS
    memory = hbm_bytes_per_device / HBM_BW
    collective = link_bytes_per_device / LINK_BW
    terms = {"compute_s": compute, "memory_s": memory,
             "collective_s": collective}
    terms["bottleneck"] = max(terms, key=lambda k: terms[k]).split("_")[0]
    return terms
