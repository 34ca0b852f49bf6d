"""The collectives of tensor-parallel serving when two ranks share one
card, measured on that card.

    python3 scripts/tp_collectives.py     # needs one CUDA card

Three things, one JSON object a line:

1. Which collectives gloo runs on CUDA tensors for two ranks on the card
   (``all_reduce``, ``broadcast``, ``all_gather``, ``reduce_scatter``).
2. Whether NCCL takes two ranks on one card (it refuses them:
   "Duplicate GPU detected"), and that ``launch.mesh.make_mesh`` refuses
   that layout before NCCL sees it.
3. The host time of one gloo all-reduce of the f32 partials the serving
   path reduces — a decode step's (4 slots, 1, 2560) and a 128-token
   prefill's (1, 128, 2560) at stablelm-3b's width — on the CUDA tensor
   as ``maybe_psum`` issues it, and through a copy to a host tensor by
   hand; mean of 200 after 20 warm-up calls, the card synchronised
   around them.
"""
from __future__ import annotations

import json
import multiprocessing as mp
import os
import queue
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch
import torch.distributed as dist

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

#: the partials serving TP reduces at stablelm-3b's width
SHAPES = {"decode (4, 1, 2560)": (4, 1, 2560),
          "prefill (1, 128, 2560)": (1, 128, 2560)}


def gloo_ops(mesh) -> dict:
    """Each collective on CUDA tensors over the mesh's gloo group: "ok"
    or the error it raised."""
    dev, g = mesh.device, mesh.group("model")
    ops = {
        "all_reduce": lambda: dist.all_reduce(
            torch.ones(4, device=dev), group=g),
        "broadcast": lambda: dist.broadcast(
            torch.ones(4, device=dev), src=0, group=g),
        "all_gather": lambda: dist.all_gather(
            [torch.zeros(4, device=dev) for _ in range(2)],
            torch.ones(4, device=dev), group=g),
        "reduce_scatter": lambda: dist.reduce_scatter(
            torch.zeros(4, device=dev),
            [torch.ones(4, device=dev) for _ in range(2)], group=g),
    }
    out = {}
    for name, op in ops.items():
        try:
            op()
            torch.cuda.synchronize()
            out[name] = "ok"
        except RuntimeError as e:
            out[name] = f"{type(e).__name__}: {str(e)[:200]}"
        dist.barrier(group=mesh.cpu_group)
    return out


def allreduce_ms(mesh) -> dict:
    """Mean host milliseconds of one all-reduce of each partial, on the
    CUDA tensor and through a host copy."""
    dev, g = mesh.device, mesh.group("model")
    out = {}
    for label, shape in SHAPES.items():
        x = torch.randn(*shape, device=dev)

        def on_card():
            dist.all_reduce(x, group=g)

        def via_host():
            h = x.cpu()
            dist.all_reduce(h, group=g)
            x.copy_(h)

        for how, fn in (("cuda tensor", on_card), ("host copy", via_host)):
            for _ in range(20):
                fn()
            torch.cuda.synchronize()
            dist.barrier(group=mesh.cpu_group)
            t0 = time.perf_counter()
            for _ in range(200):
                fn()
            torch.cuda.synchronize()
            out[f"{label}, {how}"] = (time.perf_counter() - t0) / 200 * 1e3
    return out


def both(mesh) -> dict:
    return {"ops": gloo_ops(mesh), "ms": allreduce_ms(mesh)}


def _nccl_rank(rank, init, out):
    try:
        torch.cuda.set_device(0)
        dist.init_process_group("nccl", init_method=init, world_size=2,
                                rank=rank)
        t = torch.ones(4, device="cuda:0")
        dist.all_reduce(t)
        torch.cuda.synchronize()
        out.put((rank, "ok"))
    except RuntimeError as e:
        out.put((rank, f"{type(e).__name__}: {str(e)[:300]}"))


def nccl_shared_card() -> list:
    """Two NCCL ranks on card 0: what each reports (90 s at most)."""
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    tmp = tempfile.mkdtemp(prefix="repro-nccl-")
    init = "file://" + os.path.join(tmp, "rendezvous")
    procs = [ctx.Process(target=_nccl_rank, args=(r, init, out),
                         daemon=True) for r in range(2)]
    got = []
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + 90
        while len(got) < 2 and time.monotonic() < deadline:
            try:
                got.append(out.get(timeout=1))
            except queue.Empty:
                pass
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
            p.join()
        shutil.rmtree(tmp, ignore_errors=True)
    return sorted(got) or ["no answer in 90 s"]


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("tp_collectives: no CUDA device")
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.serving import tp

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    print(json.dumps({"card": card, "torch": torch.__version__}),
          flush=True)
    ranks = tp.launch(both, 2, devices=["cuda:0", "cuda:0"],
                      backend="gloo", timeout=300)
    for r, res in enumerate(ranks):
        print(json.dumps({"rank": r, "gloo_cuda_ops": res["ops"],
                          "allreduce_ms": res["ms"]}), flush=True)
    print(json.dumps({"nccl_two_ranks_one_card": nccl_shared_card()}),
          flush=True)
    try:
        make_mesh(1, 2, devices=["cuda:0", "cuda:0"], backend="nccl")
        refused = None
    except ValueError as e:
        refused = str(e)
    print(json.dumps({"make_mesh_nccl_shared_card": refused}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
