"""Pipeline parallelism demo (paper §7.1 "PipelineParallel"): a 2-stage
GPipe-style microbatch schedule over point-to-point sends, trained end to
end, and checked against the sequential run.

The port's twin of ``examples/pipeline_parallel.py``: the port's
``core.pipeline`` (``make_pipeline_mesh``, ``pipeline_apply``) on 2 ranks
started by ``launch.mesh.launch_ranks``, one process a stage, which
share the one device over gloo.  Each stage holds the 8 x (64, 64)
stacked weights and runs its 4 layers; the schedule hands activations
forward and gradients back with ``batch_isend_irecv``.  Rank 0 reports.

Run on the card:  PYTHONPATH=src python examples/torch/pipeline_parallel.py
Run on the CPU:   PYTHONPATH=src python examples/torch/pipeline_parallel.py \\
                      --device cpu
(A file, not ``python -``: each rank is a ``spawn``ed process that
imports this script.)
"""
import argparse

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.pipeline import make_pipeline_mesh, pipeline_apply
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import launch_ranks

N_STAGES, N_MICRO = 2, 8
L, D, MB = 8, 64, 4                       # 8 layers -> 4 per stage


def stage_fn(params, h):
    for i in range(params.shape[0]):
        h = torch.tanh(h @ params[i])
    return h


def stage_main(mesh, steps):
    """One stage: the forward against the sequential run, the loss and
    gradient through the pipeline, then ``steps`` steps of SGD."""
    dev = mesh.device
    rng = np.random.default_rng(0)
    w = torch.tensor(rng.standard_normal((L, D, D)) * 0.2,
                     dtype=torch.float32, device=dev)
    x = torch.tensor(rng.standard_normal((N_MICRO, MB, D)),
                     dtype=torch.float32, device=dev)
    tgt = torch.tensor(rng.standard_normal((N_MICRO, MB, D)),
                       dtype=torch.float32, device=dev)
    pmesh = make_pipeline_mesh(N_STAGES, devices=[dev] * N_STAGES)
    out = {"shape": pmesh.shape}

    with torch.no_grad():
        y = pipeline_apply(stage_fn, w, x, pmesh)
        ref = torch.stack([stage_fn(w, x[i]) for i in range(N_MICRO)])
    out["err"] = float(torch.max(torch.abs(y - ref)))

    # train THROUGH the pipeline (it is differentiable end to end); each
    # stage's gradient is nonzero on its own layers: the whole gradient
    # is their sum over the stages
    def value_and_grad(w):
        w = w.detach().requires_grad_(True)
        loss = torch.mean((pipeline_apply(stage_fn, w, x, pmesh) - tgt)
                          ** 2)
        (g,) = torch.autograd.grad(loss, [w])
        dist.all_reduce(g, group=pmesh.group)
        return float(loss.detach()), g

    loss, g = value_and_grad(w)
    out["loss"], out["grad_norm"] = loss, float(torch.linalg.norm(g))
    for _ in range(steps):
        _, g = value_and_grad(w)
        w = w - 0.05 * g
    with torch.no_grad():
        out["final"] = float(torch.mean(
            (pipeline_apply(stage_fn, w, x, pmesh) - tgt) ** 2))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--steps", type=int, default=10)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())

    ranks = launch_ranks(stage_main, N_STAGES, 1,
                         devices=[device] * N_STAGES, backend="gloo",
                         args=(args.steps,),
                         threads=1 if device.type == "cpu" else None)
    r = ranks[0]
    print(f"pipeline mesh: {r['shape']}  microbatches={N_MICRO}")
    print(f"forward max |pipeline - sequential| = {r['err']:.2e}")
    assert r["err"] < 1e-5
    print(f"loss={r['loss']:.4f}  grad_norm={r['grad_norm']:.4f}")
    print(f"after {args.steps} steps: loss={r['final']:.4f} (decreasing)")
    assert r["final"] < r["loss"], "the loss must fall"
    assert all(k["final"] == r["final"] for k in ranks), \
        "the stages must hold the same weights"


if __name__ == "__main__":
    main()
