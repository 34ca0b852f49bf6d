"""The collectives of training parallelism when ranks share one card,
measured on that card.

    python3 scripts/train_collectives.py     # needs one CUDA card

Ranks on one card talk through gloo (NCCL refuses two ranks on a card),
which copies CUDA tensors through the host.  For 2 and for 4 ranks
(``launch.mesh.launch_ranks``), one JSON object a line:

1. The host time and throughput of ``all_gather``, ``reduce_scatter``
   and ``all_reduce`` of f32 CUDA tensors of 1, 16, 64 and 256 MiB a
   rank (the sizes of the ZeRO-3 shards and gradients of a layer group of
   stablelm-3b are 9-80 MiB), mean of 5 after 2 warm-up calls, the card
   synchronised around each; the size is each rank's tensor (the input
   of ``all_gather``, the output of ``reduce_scatter``).
2. One layer group's ZeRO-3 gather as the training path issues it (one
   ``all_gather`` a leaf, 9 leaves at stablelm-3b's width, 2 data ranks
   a leaf's shard) against one ``all_gather`` of the same bytes.
3. At 64 MiB, ``all_gather`` and ``reduce_scatter`` with the copies to
   and from pinned host buffers made by hand, and each as one
   ``all_reduce`` of the whole buffer (the others' slots zero for the
   gather; this rank's slice taken after the sum for the scatter).
4. Whether gloo takes bf16 CUDA tensors in ``all_reduce`` and
   ``all_gather``.
"""
from __future__ import annotations

import json
import statistics
import sys
import time
from pathlib import Path

import torch
import torch.distributed as dist

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

MIB = 1 << 20
SIZES_MIB = (1, 16, 64, 256)
#: one stablelm-3b layer's leaves (elements), whose halves two data ranks
#: gather: wq, wk, wv, wo (2560 x 2560), w1, w3, w2 (2560 x 6912), two
#: norm scales
GROUP = (2560 * 2560,) * 4 + (2560 * 6912,) * 3 + (2560,) * 2


def _timed(fn, device, iters=5, warm=2) -> float:
    for _ in range(warm):
        fn()
    times = []
    sync = (torch.cuda.synchronize if device.type == "cuda"
            else (lambda _: None))
    for _ in range(iters):
        sync(device)
        t0 = time.perf_counter()
        fn()
        sync(device)
        times.append(time.perf_counter() - t0)
    return statistics.mean(times)


def _via_host(x, parts, g) -> dict:
    """``all_gather`` and ``reduce_scatter`` with the copies to and from
    the host made by hand, through pinned host buffers."""
    pin = x.device.type == "cuda"
    xh = torch.empty(x.shape, pin_memory=pin)
    ph = [torch.empty(x.shape, pin_memory=pin) for _ in parts]

    def gather():
        xh.copy_(x)
        dist.all_gather(ph, xh, group=g)
        for p, h in zip(parts, ph):
            p.copy_(h, non_blocking=True)

    def scatter():
        for p, h in zip(parts, ph):
            h.copy_(p, non_blocking=True)
        if pin:
            torch.cuda.synchronize(x.device)
        dist.reduce_scatter(xh, ph, group=g)
        x.copy_(xh, non_blocking=True)

    n, rank = len(parts), dist.get_rank(g)
    full = torch.empty((n,) + tuple(x.shape), device=x.device)

    def gather_by_sum():
        full.zero_()
        full[rank].copy_(x)
        dist.all_reduce(full, group=g)

    def scatter_by_sum():
        torch.stack(parts, out=full)
        dist.all_reduce(full, group=g)
        x.copy_(full[rank])

    return {"all_gather through pinned host buffers": gather,
            "reduce_scatter through pinned host buffers": scatter,
            "all_gather as an all_reduce of a zero-padded buffer":
                gather_by_sum,
            "reduce_scatter as an all_reduce and a slice": scatter_by_sum}


def rank_fn(mesh) -> list:
    dev, n = mesh.device, mesh.devices.size
    g = mesh.group("data")
    rows = []
    for mib in SIZES_MIB:
        x = torch.ones(mib * MIB // 4, device=dev)
        parts = [torch.empty_like(x) for _ in range(n)]
        ops = {
            "all_gather": lambda: dist.all_gather(parts, x, group=g),
            "reduce_scatter": lambda: dist.reduce_scatter(x, parts,
                                                          group=g),
            "all_reduce": lambda: dist.all_reduce(x, group=g),
        }
        if mib == 64:
            ops.update(_via_host(x, parts, g))
        for name, op in ops.items():
            s = _timed(op, dev)
            rows.append({"ranks": n, "op": name, "mib": mib,
                         "ms": s * 1e3, "gib_per_s": mib / 1024 / s})
        del x, parts
    shards = [torch.ones(k // 2, device=dev) for k in GROUP]
    outs = [[torch.empty_like(t) for _ in range(n)] for t in shards]
    flat = torch.cat(shards)
    flat_out = [torch.empty_like(flat) for _ in range(n)]

    def per_leaf():
        for t, o in zip(shards, outs):
            dist.all_gather(o, t, group=g)

    rows.append({"ranks": n, "op": "group gather, one call a leaf",
                 "leaves": len(GROUP), "mib": flat.numel() * 4 / MIB,
                 "ms": _timed(per_leaf, dev) * 1e3})
    rows.append({"ranks": n, "op": "group gather, one call",
                 "mib": flat.numel() * 4 / MIB,
                 "ms": _timed(lambda: dist.all_gather(flat_out, flat,
                                                      group=g), dev) * 1e3})
    for name, op in (
            ("all_reduce bf16", lambda: dist.all_reduce(
                torch.ones(4, device=dev, dtype=torch.bfloat16), group=g)),
            ("all_gather bf16", lambda: dist.all_gather(
                [torch.empty(4, device=dev, dtype=torch.bfloat16)
                 for _ in range(n)],
                torch.ones(4, device=dev, dtype=torch.bfloat16), group=g))):
        try:
            op()
            rows.append({"ranks": n, "op": name, "ok": True})
        except Exception as e:            # report what gloo refuses
            rows.append({"ranks": n, "op": name, "ok": False,
                         "error": str(e).splitlines()[0][:200]})
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("train_collectives: no CUDA device")
    from repro_torch.launch.mesh import launch_ranks

    print(subprocess_smi(), flush=True)
    for n in (2, 4):
        rows = launch_ranks(rank_fn, n, 1, devices=["cuda:0"] * n,
                            backend="gloo", timeout=600)[0]
        for row in rows:
            print(json.dumps(row), flush=True)
    return 0


def subprocess_smi() -> str:
    import subprocess
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()


if __name__ == "__main__":
    sys.exit(main())
