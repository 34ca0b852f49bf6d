"""The training driver over ranks: one process a card, for a mix of
``"kind": "train_ranks"``.

``launch`` starts ``ranks`` processes through the port's launcher
(``launch.mesh.launch_ranks``), joined over NCCL with one card each, as
``repro_torch.launch.train --backend nccl`` starts them (on the CPU, for
the tests, over gloo), each with the port's ``(data=ranks, model=1)``
mesh.  Every rank draws the whole float32 weights from the seed, as
``weights.make`` does (the same bits on every rank), keeps its shard of
the mix's strategy and ZeRO stage (``Layout.shard``) and frees the rest
before its AdamW state is made.  Rank r feeds its rows of the global
packed batch (``Layout.batch_rows``).  Set-up drives that one training
step through its first steps on the window's own feed, as
``harness/train.py`` does; the window runs it on, each step ending in a
synchronize on every rank, with rank 0 holding the clock and deciding
when the window closes.  With ``--trace 1`` every rank profiles one step
after the window: rank 0's trace is kept, with the busy time averaged
over the ranks, and rank 0's port tracer (``make_train_step(...,
tracer=)``) gives the run's spans.

The record is ``harness/train.py``'s: a step's tokens are the global
batch's; ``memory_peak_bytes`` is the highest rank's; the program's
per-leaf norms of the first gradient (from AdamW's first moment) and of
the change after the first steps are each rank's shard norms combined
as the square root of the summed squares, a shard held by several ranks
counted once.

The mix names the ranks, the strategy and ZeRO stage, the bf16 knobs of
the gathers and reductions, and may name the ranks' ``compute_dtype``
(bfloat16 unless it does; the CPU tests compute in float32, so that four
ranks and one rank differ by summation order only).  Faults planted for
``calibrate.py``: ``half`` (each rank feeds half its rows), ``frozen``
(a step returns its state unchanged) and ``exchange`` (the gradients'
reduce-scatter between the ranks left out).

The check runs once the ranks have ended: the float32 reference
(``reference/<family>.py``, TF32 off) recomputes the first steps on the
same global rows, with its leaves and AdamW state placed layer by layer
over the cards (the embedding with the first layers on the first card,
the head with the last layers on the last), and is compared as
``harness/train.py::judge`` compares.
"""
from __future__ import annotations

import contextlib
import gc
import json
import math
import re
import statistics

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from harness import mix as mixmod
from harness import weights
from harness.clock import now
from harness.port import check_layout, import_port, model_config
from harness.spec import family, reference
from harness.trace import Profiled, busy_us
from harness.train import judge

f32 = torch.float32
#: rows of a block of the reference (more fill the expert products'
#: tiles better; fewer keep a block's logits and activations small)
BLOCK_ROWS = 2


def rank_devices(mix: dict, device) -> tuple:
    """``(devices, backend)`` of the mix's ranks: a card each over NCCL,
    or all on the CPU over gloo."""
    n = int(mix["ranks"])
    if torch.device(device).type == "cuda":
        return [f"cuda:{i}" for i in range(n)], "nccl"
    return [str(torch.device(device))] * n, "gloo"


def dotted(keystr: str) -> str:
    """``['layers'][0]['attn']['wq']`` -> ``layers.0.attn.wq``."""
    return ".".join(a or b for a, b in
                    re.findall(r"\['([^']*)'\]|\[(\d+)\]", keystr))


def run(cell, seed: int, seconds: float, trace: bool, device,
        fault: str | None = None) -> dict:
    return launch(cell, seed, seconds, trace, device, [fault])[0]


def launch(cell, seed: int, seconds: float, trace: bool, device,
           faults: list) -> list:
    """One launch of the ranks running each of ``faults`` (None: the
    program as it is) in turn; a record for each."""
    import_port()
    from repro_torch.launch.mesh import launch_ranks

    devices, backend = rank_devices(cell.traffic, device)
    cpu = torch.device(device).type == "cpu"
    per_rank = launch_ranks(_rank_main, len(devices), 1, devices=devices,
                            backend=backend,
                            args=(cell, seed, seconds, trace, list(faults)),
                            threads=1 if cpu else 2)
    return [merge([r[j] for r in per_rank]) for j in range(len(faults))]


def combine(parts: list) -> dict:
    """Per-leaf norms from the ranks' squared shard norms."""
    return {k: math.sqrt(sum(p[k] for p in parts)) for k in parts[0]}


def merge(parts: list) -> dict:
    """Rank 0's record with the ranks' peaks, norms and busy times."""
    rec = dict(parts[0]["rec"])
    rec["memory_peak_bytes"] = max(p["memory_peak_bytes"] for p in parts)
    rec["window_peak_bytes"] = max(p["window_peak_bytes"] for p in parts)
    rec["program"] = {"losses": rec.pop("losses"),
                      "grad_norms": combine([p["grad_sq"] for p in parts]),
                      "change": combine([p["change_sq"] for p in parts])}
    if rec["trace"] is not None:
        rec["trace"]["busy_s"] = statistics.mean(p["busy_s"] for p in parts)
        rec["trace"]["busy_s_ranks"] = [p["busy_s"] for p in parts]
    return rec


def _rank_main(mesh, cell, seed: int, seconds: float, trace: bool,
               faults: list) -> list:
    out = []
    for fault in faults:
        with _planted(fault):
            out.append(_rank_run(mesh, cell, seed, seconds, trace, fault))
    return out


@contextlib.contextmanager
def _planted(fault: str | None):
    """``exchange``: the exchange between the ranks left out where the
    gradients meet, each rank keeping its own rows' part of its shard
    (the port's ZeRO reduce-scatter, ``core.zero._reduce_scatter_dim``,
    made a slice) for the run."""
    if fault != "exchange":
        yield
        return
    import torch.distributed as dist
    from repro_torch.core import zero

    real = zero._reduce_scatter_dim

    def own_part(t, dim, group, n):
        return t.chunk(n, dim=dim)[dist.get_rank(group)].contiguous()

    zero._reduce_scatter_dim = own_part
    try:
        yield
    finally:
        zero._reduce_scatter_dim = real


def _sq_change(p: torch.Tensor, init: torch.Tensor) -> float:
    """Squared norm of ``p - init`` (``init`` on the host), a slice of
    dim 0 at a time so that the difference fits beside the state."""
    if p.ndim == 0:
        return float(p - init.to(p.device)) ** 2
    step = max(1, (1 << 26) // max(1, p[0].numel()))
    total = 0.0
    for r in range(0, p.shape[0], step):
        d = p[r:r + step] - init[r:r + step].to(p.device)
        total += float(torch.linalg.vector_norm(d)) ** 2
    return total


def _rank_run(mesh, cell, seed: int, seconds: float, trace: bool,
              fault: str | None) -> dict:
    import torch.distributed as dist

    import_port()
    from repro_torch.configs.base import RunConfig
    from repro_torch.kernels import ops
    from repro_torch.monitoring import Tracer
    from repro_torch.optim import OptimizerConfig
    from repro_torch.training.train_step import (
        init_opt_state_sharded, make_train_step,
    )
    from repro_torch.tree import leaves, leaves_with_path

    device = mesh.device
    cuda = device.type == "cuda"
    lead = mesh.rank == 0
    conf, mix = cell.config, cell.traffic
    vocab = family(conf).vocab(conf)
    cfg = model_config(conf, mix.get("compute_dtype", "bfloat16"),
                       "float32")
    opt = OptimizerConfig(**mix["optimizer"])
    run_cfg = RunConfig(use_kernels=True, strategy=mix["strategy"],
                        zero_stage=int(mix["zero_stage"]),
                        gather_bf16=bool(mix["gather_bf16"]),
                        grad_reduce_bf16=bool(mix["grad_reduce_bf16"]),
                        remat=mix["remat"],
                        microbatches=int(mix["microbatches"]))
    tracer = Tracer(clock=now, max_spans=1 << 20) if trace and lead else None
    step_fn = make_train_step(cfg, run_cfg, mesh, opt, local_batch=True,
                              tracer=tracer)
    layout = step_fn.layout
    flat = weights.make(conf, seed, device, f32)
    check_layout(cfg, flat)
    params = layout.shard(weights.tree(flat))
    del flat
    if cuda:
        torch.cuda.empty_cache()
    paths = [dotted(p) for p, _ in leaves_with_path(params)]
    init = [p.detach().to("cpu", copy=True) for p in leaves(params)]
    state = init_opt_state_sharded(params, opt, layout)
    sync = (lambda: torch.cuda.synchronize(device)) if cuda \
        else (lambda: None)
    B, S = int(mix["batch"]), int(mix["seq_len"])
    start, count = layout.batch_rows(B)
    mine = slice(start, start + (count // 2 if fault == "half" else count))

    def step(i: int):
        nonlocal params, state
        if fault == "frozen":          # returns its state unchanged
            return {"loss": torch.tensor(float("nan"))}
        b = mixmod.train_batch(mix, vocab, seed, i)
        batch = {k: torch.from_numpy(v[mine]).to(device)
                 for k, v in b.items()}
        params, state, m = step_fn(params, state, batch)
        return m

    # ---- set-up: the first steps, read for the check
    losses, grad_sq = [], {}
    for i in range(1, int(mix["first_steps"]) + 1):
        m = step(i)
        losses.append(float(m["loss"]))
        if i == 1:
            for path, leaf, mt in zip(paths, layout.leaves,
                                      leaves(state["m"])):
                g = float(torch.linalg.vector_norm(mt.float())) \
                    / (1 - opt.b1)
                grad_sq[path] = g * g if layout.owned(leaf) else 0.0
    change_sq = {
        path: (_sq_change(p, p0) if leaf.data_dim is not None
               or layout.d == 0 else 0.0)
        for path, leaf, p, p0 in zip(paths, layout.leaves, leaves(params),
                                     init)}
    del init
    sync()
    setup_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)

    # ---- the window: rank 0's clock decides, every rank follows
    done = torch.zeros(1, dtype=f32, device=device)
    flag = torch.zeros(1, dtype=torch.int32, device=device)
    steps = []
    traced, busy = None, None
    i = int(mix["first_steps"])
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
        loss = float(m["loss"])        # this rank's step has ended
        dist.all_reduce(done)          # ... and every rank's
        float(done)
        te = now()
        if prof is not None:
            prof.__exit__(None, None, None)
            busy = busy_us(prof.ops) / 1e6
            te = now()
            traced = {"ops": prof.ops, "wall_s": prof.wall_s,
                      "launches": {k: v - launches0[k] for k, v in
                                   ops.launch_counts().items()}}
        steps.append({"t0": ts, "t1": te, "tokens": B * S, "loss": loss,
                      "traced": prof is not None})
        if lead:
            flag.fill_(2 if closing or te >= t_end and not trace
                       else int(te >= t_end))
        dist.broadcast(flag, src=0)
        code = int(flag)
        if code == 2:
            break
        closing = code == 1
    sync()
    window_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    out = {"memory_peak_bytes": max(setup_peak, window_peak),
           "window_peak_bytes": window_peak, "grad_sq": grad_sq,
           "change_sq": change_sq, "busy_s": busy}
    if lead:
        untraced = [s for s in steps if not s["traced"]]
        out["rec"] = {
            "kind": "train_ranks", "config": conf, "traffic": mix,
            "ranks": layout.world,
            "window": {"t0": t0, "t1": untraced[-1]["t1"], "close": t_end},
            "steps": steps, "trace": traced, "losses": losses,
            "spans": tracer.export() if tracer is not None else None,
        }
    del params, state, step_fn
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    return out


# ------------------------------------------------------------ the check ----

def _place(flat: dict, ref, homes: list, first, last) -> dict:
    """The reference's leaves, ``{(path, layer): tensor}``: a stacked
    leaf's layer ``i`` (kept ``(1, ...)``, so AdamW decays it as the
    stacked leaf is decayed) on ``homes[i]``, the embedding on ``first``,
    the final norm and head on ``last``; each a copy of its own, so that
    the drawn buffer frees."""
    out = {}
    for path in list(flat):
        t = flat.pop(path)
        if path.startswith(ref.L):
            for i, dev in enumerate(homes):
                out[(path, i)] = t[i:i + 1].to(dev, copy=True)
        else:
            dev = first if path.startswith("embed.") else last
            out[(path, None)] = t.to(dev, copy=True)
    return out


def _rows_of_microbatches(mix: dict) -> list:
    """The global rows of each microbatch, as the ranks take them
    (``local_batch``): microbatch i is every rank's i-th share of its
    rows."""
    n, B, n_mb = int(mix["ranks"]), int(mix["batch"]), \
        int(mix["microbatches"])
    count = B // n
    b = count // n_mb
    return [[r * count + mb * b + j for r in range(n) for j in range(b)]
            for mb in range(n_mb)]


def _blocks(mix: dict, conf: dict, mask: np.ndarray) -> list:
    """``(rows, w_xent, w_balance, w_z)`` of every block of rows (a slice
    of the global batch): whole token groups of one rank's microbatch,
    each term weighted as the step's loss weighs it (a mean over the
    microbatch's tokens counted, its groups, its tokens; the microbatches
    averaged)."""
    S, n_mb = int(mix["seq_len"]), int(mix["microbatches"])
    m = conf["port_moe"]
    gs = m["group_size"]
    least = gs // math.gcd(gs, S)      # rows that hold whole groups
    per_rank = int(mix["batch"]) // int(mix["ranks"]) // n_mb
    if per_rank % least:
        raise ValueError(f"a rank's {per_rank} rows of {S} tokens are not "
                         f"whole groups of {gs}")
    k = least * max(1, BLOCK_ROWS // least)
    if per_rank % k:
        k = least
    out = []
    for rows in _rows_of_microbatches(mix):
        counted = max(float(mask[rows].sum()), 1.0)
        tokens = len(rows) * S
        w = (1.0 / (counted * n_mb), m["balance_coef"] * gs / (tokens * n_mb),
             m["router_z_coef"] / (tokens * n_mb))
        out += [(slice(rows[j], rows[j] + k), *w)
                for j in range(0, len(rows), k)]
    return out


def _loss_and_grads(P, ref, conf, use, stages, batch, blocks) -> float:
    """One step's loss; its gradients accumulated into the leaves.

    Every block runs forward through the stages (a card's layers, each
    recomputed in the backward pass), its head at once (forward and
    backward, so that its logits never pile up); then every block runs
    backward through the stages, last to first.  The host only queues
    work and each card runs its own queue, so while one card works on a
    block the next works on the block before: the cards overlap as a
    pipeline's stages do."""
    first, last = stages[0][0], stages[-1][0]
    fixed = {path: t for (path, i), t in P.items() if i is None}
    by_layer: dict = {}
    for (path, i), t in P.items():
        if i is not None:
            by_layer.setdefault(i, []).append((path[len(ref.L):], t))

    def run_layer(x, i):
        return ref.layer({name: t[0] for name, t in by_layer[i]}, conf, x,
                         use)

    # the rows reach the cards once, before any work is queued: a copy
    # from the host's memory waits for its card's queue to drain
    tokens = torch.from_numpy(batch["tokens"]).to(first).long()
    labels = torch.from_numpy(batch["labels"]).to(last).long()
    mask = torch.from_numpy(batch["loss_mask"]).to(last)
    held, parts = [], []
    for rows, wx, wb, wz in blocks:
        x = fixed["embed.tok"][tokens[rows]]
        ins, outs, auxs = [], [], []
        for k, (dev, ids) in enumerate(stages):
            if k:
                x = x.detach().to(dev).requires_grad_(True)
            ins.append(x)
            aux = torch.zeros((), dtype=f32, device=dev)
            for i in ids:
                x, balance, z = checkpoint(run_layer, x, i,
                                           use_reentrant=False,
                                           preserve_rng_state=False)
                aux = aux + wb * balance + wz * z
            outs.append(x)
            auxs.append(aux)
        h = x.detach().requires_grad_(True)
        xent = ref.head_xent(fixed, conf, h, labels[rows], mask[rows], use) \
            * wx
        xent.backward()
        parts.append(xent.detach() + sum(a.detach().to(last) for a in auxs))
        held.append((ins, outs, auxs, h))
    for ins, outs, auxs, h in held:
        g = h.grad
        for k in reversed(range(len(stages))):
            torch.autograd.backward([outs[k], auxs[k]],
                                    [g, torch.ones_like(auxs[k])])
            if k:
                g = ins[k].grad.to(stages[k - 1][0])
    del held
    return float(sum(parts))


def reference_run(rec: dict, seed: int, device, use=None) -> dict:
    """The first steps in float32 from the same weights and global rows:
    each step's loss, the first step's clipped gradient norm by leaf, the
    parameters' change by leaf after them.  ``use``: a control's product
    weights.  AdamW is ``common.adamw`` on each card's leaves, with the
    clipping scale taken over every card's gradient first."""
    from reference import common

    common.no_tf32()
    ref = reference(rec["config"])
    use = use or common.exact
    conf, mix = rec["config"], rec["traffic"]
    vocab = family(conf).vocab(conf)
    opt = mix["optimizer"]
    # the ranks' cards, each once
    devs = [torch.device(d) for d in dict.fromkeys(rank_devices(mix,
                                                                device)[0])]
    n_layers = conf["num_hidden_layers"]
    homes = [devs[i * len(devs) // n_layers] for i in range(n_layers)]
    stages = [(d, [i for i in range(n_layers) if homes[i] == d])
              for d in devs if d in homes]
    P = _place(weights.make(conf, seed, devs[0], f32), ref, homes, devs[0],
               devs[-1])
    if devs[0].type == "cuda":
        torch.cuda.empty_cache()
    for t in P.values():
        t.requires_grad_(True)
    m = {k: torch.zeros_like(t) for k, t in P.items()}
    v = {k: torch.zeros_like(t) for k, t in P.items()}
    unclipped = dict(opt, clip_norm=float("inf"))
    losses, first_norms = [], None
    for step in range(1, int(mix["first_steps"]) + 1):
        batch = mixmod.train_batch(mix, vocab, seed, step)
        losses.append(_loss_and_grads(P, ref, conf, use, stages, batch,
                                      _blocks(mix, conf, batch["loss_mask"])))
        grads = {k: t.grad for k, t in P.items()}
        gnorm = torch.sqrt(sum(torch.sum(g * g).to(devs[0])
                               for g in grads.values()))
        scale = torch.clamp(opt["clip_norm"] / (gnorm + 1e-9), max=1.0)
        norms = {}
        for dev in devs:
            keys = [k for k, t in P.items() if t.device == dev]
            for k in keys:
                grads[k].mul_(scale.to(dev))
            norms.update(common.adamw(
                {k: P[k].data for k in keys}, {k: grads[k] for k in keys},
                {k: m[k] for k in keys}, {k: v[k] for k in keys}, step,
                unclipped))
        for t in P.values():
            t.grad = None
        del grads
        if step == 1:
            first_norms = _by_leaf(norms)
    del m, v
    change = _change(P, weights.make(conf, seed, devs[0], f32))
    del P
    gc.collect()
    if devs[0].type == "cuda":
        torch.cuda.empty_cache()
    return {"losses": losses, "grad_norms": first_norms, "change": change}


def _change(P: dict, init: dict) -> dict:
    """Per-leaf norms of the placed leaves' change from ``init``."""
    sq: dict = {}
    for (path, i), t in P.items():
        t0 = init[path] if i is None else init[path][i:i + 1]
        d = float(torch.linalg.vector_norm(t.detach() - t0.to(t.device)))
        sq[path] = sq.get(path, 0.0) + d * d
    return {k: math.sqrt(s) for k, s in sq.items()}


def _by_leaf(norms: dict) -> dict:
    """Per-leaf norms from the per-layer ones, ``{(path, layer): norm}``."""
    sq: dict = {}
    for (path, _), n in norms.items():
        sq[path] = sq.get(path, 0.0) + n * n
    return {k: math.sqrt(s) for k, s in sq.items()}


#: the float32 reference of the last seed and cell checked in this
#: process, by what it is a function of: the records of one seed (the
#: program's, the control's, each planted fault's, as ``calibrate.py``
#: checks them one after another) are held to one reference run
_EXACT: dict = {}


def exact_reference(rec: dict, seed: int, device) -> dict:
    key = (int(seed), str(device), json.dumps(rec["config"], sort_keys=True),
           json.dumps(rec["traffic"], sort_keys=True))
    if key not in _EXACT:
        _EXACT.clear()
        _EXACT[key] = reference_run(rec, seed, device)
    return _EXACT[key]


def check(rec: dict, seed: int, device, limits: dict, use=None) -> dict:
    """The numbers ``correct`` compares (``harness/train.py::judge``);
    with ``use`` (a control's products) those of the reference run so, in
    the program's place."""
    ref = exact_reference(rec, seed, device)
    if use is None:
        return judge(rec["program"], ref)
    return judge(reference_run(rec, seed, device, use), ref)


def attempted(rec: dict) -> tuple:
    steps = rec["steps"]
    return len(steps), sum(1 for s in steps if not np.isfinite(s["loss"]))
