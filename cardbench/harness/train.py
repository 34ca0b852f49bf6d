"""The training driver: one general loop for every training mix.

Set-up builds one object, the port's training step
(``training.train_step.make_train_step``) with its parameters (drawn on the
device from the seed) and AdamW state, and drives it from the seed through
its first steps on the window's own feed: their losses, the first
gradient as AdamW got it (its first moment after one step, over ``1 -
b1``) and the parameters' change after them are kept for the check.  The
window then runs that same object on, one step after another, each ending
in a synchronize; rows differ from step to step.

Afterwards the program's state is freed and the reference (float32, TF32
off) runs the same first steps from the same weights and rows.
"""
from __future__ import annotations

import gc

import numpy as np
import torch

from harness import mix as mixmod
from harness import weights
from harness.clock import now
from harness.port import check_layout, import_port, model_config
from harness.spec import family, reference
from harness.trace import Profiled


def _at(tree, path: str):
    for part in path.split("."):
        tree = tree[int(part)] if part.isdigit() else tree[part]
    return tree


def device_batch(mix: dict, vocab: int, seed: int, step: int, device,
                 rows: slice | None = None) -> dict:
    b = mixmod.train_batch(mix, vocab, seed, step)
    if rows is not None:
        b = {k: v[rows] for k, v in b.items()}
    return {k: torch.from_numpy(v).to(device) for k, v in b.items()}


def run(cell, seed: int, seconds: float, trace: bool, device,
        fault: str | None = None) -> dict:
    import_port()
    from repro_torch.configs.base import RunConfig
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import single_device_mesh
    from repro_torch.optim import OptimizerConfig, init_opt_state
    from repro_torch.training.train_step import make_train_step

    device = torch.device(device)
    conf, mix = cell.config, cell.traffic
    vocab = family(conf).vocab(conf)
    cfg = model_config(conf, "bfloat16", "float32")
    opt = OptimizerConfig(**mix["optimizer"])
    run_cfg = RunConfig(use_kernels=True, remat=mix["remat"],
                        microbatches=int(mix["microbatches"]))
    step_fn = make_train_step(cfg, run_cfg, single_device_mesh(device), opt)
    flat = weights.make(conf, seed, device, torch.float32)
    check_layout(cfg, flat)
    params = weights.tree(flat)
    state = init_opt_state(params, opt)
    sync = (lambda: torch.cuda.synchronize(device)) \
        if device.type == "cuda" else (lambda: None)
    B = int(mix["batch"])

    def step(i: int):
        nonlocal params, state
        if fault == "frozen":          # returns its state unchanged
            return {"loss": torch.tensor(float("nan"))}
        rows = slice(0, B // 2) if fault == "half" else None
        batch = device_batch(mix, vocab, seed, i, device, rows)
        params, state, m = step_fn(params, state, batch)
        return m

    # ---- set-up: the first steps, read for the check
    first = int(mix["first_steps"])
    losses, grad_norms = [], {}
    for i in range(1, first + 1):
        m = step(i)
        losses.append(float(m["loss"]))
        if i == 1:
            for p in flat:
                g = _at(state["m"], p) / (1 - opt.b1) \
                    if fault != "frozen" else torch.zeros(())
                grad_norms[p] = float(torch.linalg.vector_norm(g.float()))
    init = weights.make(conf, seed, device, torch.float32)
    change = {p: float(torch.linalg.vector_norm(flat[p] - init[p]))
              for p in flat}
    del init
    sync()
    setup_peak = torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else 0
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)

    # ---- the window
    steps = []
    traced = None
    i = first
    t0 = now()
    t_end = t0 + seconds
    closing = False                    # the window closed; the traced step
    while True:
        i += 1
        prof = Profiled(device) if closing else None
        if prof is not None:
            launches0 = ops.launch_counts()
            prof.__enter__()
        ts = now()
        m = step(i)
        loss = float(m["loss"])        # ends the step in a synchronize
        te = now()
        if prof is not None:
            prof.__exit__(None, None, None)
            te = now()
            traced = {"ops": prof.ops, "wall_s": prof.wall_s,
                      "launches": {k: v - launches0[k] for k, v in
                                   ops.launch_counts().items()}}
        steps.append({"t0": ts, "t1": te, "tokens": B * int(mix["seq_len"]),
                      "loss": loss, "traced": prof is not None})
        if closing or te >= t_end and not trace:
            break
        closing = te >= t_end
    sync()
    window_peak = torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else 0
    rec = {
        "kind": "train", "config": conf, "traffic": mix,
        "window": {"t0": t0, "t1": [s for s in steps if not s["traced"]][-1]
                   ["t1"], "close": t_end},
        "steps": steps, "trace": traced,
        "memory_peak_bytes": max(setup_peak, window_peak),
        "window_peak_bytes": window_peak,
        "program": {"losses": losses, "grad_norms": grad_norms,
                    "change": change},
    }
    del params, state, step_fn, flat
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return rec


def reference_run(rec: dict, seed: int, device, use=None) -> dict:
    """The first steps in float32 from the same weights and rows: each
    step's loss, the first step's clipped gradient norm by leaf, the
    parameters' change by leaf after them.  ``use``: a control's product
    weights.  Rows run one at a time, layers recomputed, to fit beside
    the optimizer state."""
    from reference import common

    common.no_tf32()
    ref = reference(rec["config"])
    use = use or common.exact
    conf, mix = rec["config"], rec["traffic"]
    vocab = family(conf).vocab(conf)
    opt = mix["optimizer"]
    W = weights.make(conf, seed, device, torch.float32)
    for t in W.values():
        t.requires_grad_(True)
    m = {k: torch.zeros_like(t) for k, t in W.items()}
    v = {k: torch.zeros_like(t) for k, t in W.items()}
    n_mb = int(mix["microbatches"])
    B = int(mix["batch"])
    b = B // n_mb
    losses, first_norms = [], None
    for i in range(1, int(mix["first_steps"]) + 1):
        batch = device_batch(mix, vocab, seed, i, device)
        batch["tokens"] = batch["tokens"].long()
        batch["labels"] = batch["labels"].long()
        loss = 0.0
        for mb in range(n_mb):
            rows = range(mb * b, (mb + 1) * b)
            count = float(batch["loss_mask"][mb * b:(mb + 1) * b].sum())
            for r in rows:
                part = ref.loss_sum(W, conf, batch["tokens"][r:r + 1],
                                    batch["labels"][r:r + 1],
                                    batch["loss_mask"][r:r + 1], use) \
                    / (max(count, 1.0) * n_mb)
                part.backward()
                loss += float(part.detach())
        grads = {k: t.grad for k, t in W.items()}
        norms = common.adamw({k: t.data for k, t in W.items()}, grads, m, v,
                             i, opt)
        for t in W.values():
            t.grad = None
        losses.append(loss)
        if i == 1:
            first_norms = norms
    del m, v
    final = {k: t.detach() for k, t in W.items()}
    init = weights.make(conf, seed, device, torch.float32)
    change = {k: float(torch.linalg.vector_norm(final[k] - init[k]))
              for k in final}
    del W, final, init
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return {"losses": losses, "grad_norms": first_norms, "change": change}


def judge(prog: dict, ref: dict, rel_floor: float = 1e-3) -> dict:
    """The numbers compared: the worst step's relative loss gap; the worst
    leaf's gap of first-gradient norms and of change norms, each against
    the larger of that leaf's reference norm and the median leaf's.
    Leaves whose reference gradient is under ``rel_floor`` of the median
    leaf's (nought to rounding) are left out of the change.  Also the
    first step's loss gap and the median leaf's gaps, and the worst
    leaves by name, for the readings the limits are set from."""
    losses = [abs(a - b) / abs(b) for a, b in
              zip(prog["losses"], ref["losses"])]
    gr = ref["grad_norms"]
    med_g = float(np.median(list(gr.values())))
    grad = {k: abs(prog["grad_norms"][k] - gr[k]) / max(gr[k], med_g)
            for k in gr}
    kept = [k for k in gr if gr[k] >= rel_floor * med_g]
    cr = ref["change"]
    med_c = float(np.median([cr[k] for k in kept]))
    change = {k: abs(prog["change"][k] - cr[k]) / max(cr[k], med_c)
              for k in kept}

    def worst(d):
        return max(d, key=lambda k: d[k])

    return {"loss_gap": max(losses), "grad_gap": max(grad.values()),
            "change_gap": max(change.values()),
            "loss_gap_first": losses[0],
            "grad_gap_median": float(np.median(list(grad.values()))),
            "change_gap_median": float(np.median(list(change.values()))),
            "grad_worst": worst(grad), "change_worst": worst(change),
            "left_out": sorted(set(gr) - set(kept))}


def check(rec: dict, seed: int, device, limits: dict, use=None) -> dict:
    return judge(rec["program"], reference_run(rec, seed, device, use))


def attempted(rec: dict) -> tuple:
    steps = rec["steps"]
    return len(steps), sum(1 for s in steps if not np.isfinite(s["loss"]))
