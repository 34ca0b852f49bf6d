"""Production dry run — the port of the JAX package's
``launch/dryrun.py``: for every (architecture x input shape x mesh), what
one rank of the production mesh (16 x 16 ranks, or 2 x 16 x 16 with a
``pod`` axis) holds, computes and sends in one step, without a card.

The JAX dry run lowers the step on 512 placeholder CPU devices and reads
XLA's analyses.  The port has no compiler to ask: it runs one rank's
eager program on the ``meta`` device — by design, not as a fallback —
inside a ``torch.distributed`` world on the fake backend of the
production mesh's size (``launch.mesh.virtual_world``), so every
collective returns at once and no number is computed, no card touched and
no kernel launched.  It runs the route the ``RunConfig`` names:
``default_run_config`` leaves ``use_kernels`` False (the JAX
``use_pallas`` defaults to False too), and a kernel would refuse a meta
tensor.  For each combination rank ``--rank`` runs

  * train shapes: ``training.make_train_step``'s step once, on its shards
    of the parameters and optimizer state and its rows of the batch;
  * prefill shapes: ``models.model.prefill`` under the training layout,
    as the JAX dry run does (ZeRO-3 gathers at use, the TP points);
  * decode shapes: ``serving.make_serve_step``'s step,

and records around that run:

  * **collectives** — every ``torch.distributed`` collective called, by
    kind, with the bytes handed over (each call's input, as
    ``chip_smoke.py``'s ``timed_collectives`` counts them), its result
    bytes and its group size, and the census of ``launch.hlo``;
  * **flops** — the formulas of ``torch.utils.flop_counter`` (those
    ``FlopCounterMode`` applies), op by op.  Python loops run every
    layer and microbatch, so the count is exact per step:
    ``cost.method`` reads ``"counted (eager, every layer)"``.  The
    JAX dry run's unrolled probes exist because XLA counts a ``while``
    body once, and have no counterpart here;
  * **HBM bytes** — each aten op's input and output bytes, views
    excluded: the eager program's traffic, an upper bound on what a
    fused program moves;
  * **memory** — ``argument_bytes`` (the rank's params, optimizer state
    and batch, or cache), ``output_bytes`` and ``peak_bytes``, the most
    bytes live at once over the run, each storage rounded up to 512
    bytes as the card's caching allocator rounds a block.

One dispatch mode (:class:`Meter`) does the counting, flops included:
``FlopCounterMode``'s own mode stacked on a second one slowed a
full-size step markedly, and each mode sees every op.

One JSON per combination goes to ``--outdir`` with every key the JAX
records carry (``devices`` is the world size), so
``benchmarks/bench_roofline.py``'s ``table()`` renders them under
``REPRO_DRYRUN_DIR=results/dryrun_torch``.  The roofline constants are
the H100's data-sheet peaks (``launch.hlo``): a reckoning, not a card
speed.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun [--arch ID ...] \\
      [--shape NAME ...] [--mesh single|multi|both] [--outdir DIR] \\
      [--rank R] [--keep-going]
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import inspect
import json
import math
import os
import time
import traceback
import weakref

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from repro_torch.configs import (
    ARCH_IDS, INPUT_SHAPES, default_run_config, get_config,
    get_reduced_config, shape_for,
)
from repro_torch.launch import hlo as H
from repro_torch.launch.mesh import (
    PRODUCTION_SHAPES, make_production_mesh, virtual_world,
)

#: the collectives the recorder wraps: ``torch.distributed`` name -> the
#: JAX census's op
COLLECTIVES = {
    "all_reduce": "all-reduce",
    "all_gather": "all-gather",
    "all_gather_into_tensor": "all-gather",
    "reduce_scatter": "reduce-scatter",
    "reduce_scatter_tensor": "reduce-scatter",
    "all_to_all": "all-to-all",
    "all_to_all_single": "all-to-all",
    "batch_isend_irecv": "collective-permute",
}
#: the caching allocator's block granularity on the card
_BLOCK = 512
#: allocation-only ops: no bytes move
_NO_TRAFFIC = ("empty", "empty_like", "empty_strided", "new_empty",
               "new_empty_strided")


def nbytes(x) -> int:
    """Bytes of a tensor, or of a list of tensors."""
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (list, tuple)):
        return sum(nbytes(t) for t in x)
    return 0


def handed_bytes(name: str, args: tuple) -> int:
    """Bytes a ``torch.distributed`` collective call hands over: its
    input, or list of inputs (a ``batch_isend_irecv``: the tensors it
    sends)."""
    if name == "batch_isend_irecv":
        return sum(nbytes(op.tensor) for op in args[0]
                   if getattr(op.op, "__name__", "") != "irecv")
    return nbytes(args[0] if name == "all_reduce" else args[1])


class _Done:
    """A finished request, for the point-to-point sends the recorder
    answers itself."""

    def wait(self, *_a, **_kw):
        return True

    def is_completed(self):
        return True


@contextlib.contextmanager
def record_collectives(records: list):
    """Record every collective of ``COLLECTIVES`` that code run inside
    the block calls: one dict a call with ``name``, ``op`` (the census's),
    ``handed`` (:func:`handed_bytes`, as ``chip_smoke.py``'s
    ``timed_collectives`` counts them), ``result`` (bytes of the output)
    and ``group`` (its size).  A ``batch_isend_irecv`` records one
    ``collective-permute`` a send (its tensor's bytes, what the peer
    receives), and the recorder answers it without sending: the fake
    backend runs no point-to-point op."""
    orig = {name: getattr(dist, name) for name in COLLECTIVES
            if hasattr(dist, name)}

    def wrap(name, fn):
        sig = inspect.signature(fn)

        def call(*a, **kw):
            bound = sig.bind(*a, **kw)
            group = bound.arguments.get("group")
            if name == "batch_isend_irecv":
                ops = a[0] if a else kw["p2p_op_list"]
                for op in ops:
                    if getattr(op.op, "__name__", "") != "irecv":
                        size = nbytes(op.tensor)
                        records.append(dict(
                            name=name, op=COLLECTIVES[name], handed=size,
                            result=size, group=2))
                return [_Done() for _ in ops]
            records.append(dict(name=name, op=COLLECTIVES[name],
                                handed=handed_bytes(name, a),
                                result=nbytes(a[0]),
                                group=dist.get_world_size(group)))
            return fn(*a, **kw)
        return call

    for name, fn in orig.items():
        setattr(dist, name, wrap(name, fn))
    try:
        yield records
    finally:
        for name, fn in orig.items():
            setattr(dist, name, fn)


def _tensors(x):
    """The tensors of an aten op's arguments or outputs: a tensor, or
    lists and tuples of them (nested one deep)."""
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for y in x:
            if isinstance(y, torch.Tensor):
                yield y
            elif isinstance(y, (list, tuple)):
                yield from (z for z in y if isinstance(z, torch.Tensor))


class Meter(TorchDispatchMode):
    """One rank's step as it runs, op by op: its flops, its traffic and
    the bytes live at once.

    * ``flops`` — each aten op through the formulas of
      ``torch.utils.flop_counter`` (the ``flop_registry`` that
      ``FlopCounterMode`` reads, applied in this one mode);
    * ``traffic`` — each op's input and output bytes, views and
      allocations excluded;
    * ``peak`` — a storage counts from the op that creates it to its
      release, rounded up to the allocator's block; ``args`` (the step's
      arguments) are live from the start, and ``argument_bytes`` are
      their distinct storages' bytes.

    Storages are keyed by their ``StorageImpl`` (``_cdata``); a storage's
    Python object lives as long as the storage, so a weak reference to it
    marks the release."""

    def __init__(self, args):
        super().__init__()
        probe = torch.empty(1, device="meta")
        if probe.untyped_storage() is not probe.untyped_storage():
            raise RuntimeError("Meter: this torch does not keep one Python "
                               "object a storage; live bytes untracked")
        self.flops = 0
        self.traffic = 0
        self.live = {}                 # _cdata -> (bytes, weak reference)
        self.live_bytes = 0
        self.peak = 0
        self._ops = {}                 # op -> (moves bytes?, flop formula)
        self._track(_tensors(tree_flatten(args)[0]))
        self.argument_bytes = self.unique_bytes(args)

    def _track(self, tensors) -> None:
        """Register the storages of ``tensors`` not yet live."""
        for t in tensors:
            st = t.untyped_storage()
            key = st._cdata
            if key in self.live:
                continue
            size = -(-st.nbytes() // _BLOCK) * _BLOCK
            self.live[key] = (size, weakref.ref(
                st, lambda _ref, key=key: self._release(key)))
            self.live_bytes += size
        if self.live_bytes > self.peak:
            self.peak = self.live_bytes

    def _release(self, key):
        entry = self.live.pop(key, None)
        if entry is not None:
            self.live_bytes -= entry[0]

    @staticmethod
    def unique_bytes(tree) -> int:
        """Bytes of the distinct storages of ``tree``'s tensors."""
        seen, total = set(), 0
        for t in tree_flatten(tree)[0]:
            if isinstance(t, torch.Tensor):
                st = t.untyped_storage()
                if st._cdata not in seen:
                    seen.add(st._cdata)
                    total += st.nbytes()
        return total

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        op = self._ops.get(func)
        if op is None:
            packet = func.overloadpacket
            op = self._ops[func] = (
                not func.is_view and packet.__name__ not in _NO_TRAFFIC,
                flop_registry.get(packet))
        moves, formula = op
        if formula is not None:
            self.flops += formula(*args, **kwargs, out_val=out)
        if moves:
            self.traffic += sum(nbytes(t) for t in _tensors(args)) + sum(
                nbytes(t) for t in _tensors(out)) + sum(
                nbytes(t) for t in _tensors(tuple(kwargs.values())))
        self._track(_tensors(out))
        return out


def _batch_divisor(mesh) -> int:
    return mesh.shape.get("data", 1) * mesh.shape.get("pod", 1)


def build_step(cfg, run, shape, mesh):
    """(step, args): the step this rank runs for ``shape`` and its
    arguments on ``meta``."""
    if shape.kind == "train":
        from repro_torch.optim import OptimizerConfig
        from repro_torch.training import (
            make_train_step, train_step_lowering_args,
        )
        opt = OptimizerConfig(state_dtype=run.opt_state_dtype)
        step = make_train_step(cfg, run, mesh, opt, local_batch=True)
        return step, train_step_lowering_args(cfg, run, mesh, shape, opt)
    if shape.kind == "prefill":
        from repro_torch.models.inputs import input_specs
        from repro_torch.serving.serve_step import make_prefill_step

        step = make_prefill_step(cfg, run, mesh, shape.global_batch,
                                 shape.seq_len)
        rows = step.layout.local_batch
        batch = {k: torch.empty((rows,) + tuple(s.shape[1:]), dtype=s.dtype,
                                device="meta")
                 for k, s in input_specs(cfg, shape).items()
                 if k not in ("labels", "loss_mask")}
        return step, (step.layout.params(), batch)
    from repro_torch.serving import make_serve_step, serve_step_lowering_args
    step = make_serve_step(cfg, run, mesh, shape.global_batch, shape.seq_len)
    return step, serve_step_lowering_args(cfg, run, mesh, shape)


def count_step(step, args) -> dict:
    """Run ``step(*args)`` once on ``meta`` under the recorder and the
    meter: its collectives, flops, traffic and memory."""
    records = []
    meter = Meter(args)
    with record_collectives(records), meter:
        out = step(*args)
    calls: dict = {}
    for r in records:
        calls[r["name"]] = calls.get(r["name"], 0) + 1
    return {"records": records, "calls": calls,
            "handed_bytes": sum(r["handed"] for r in records),
            "flops": float(meter.flops),
            "hbm_bytes": float(meter.traffic),
            "argument_bytes": meter.argument_bytes,
            "output_bytes": meter.unique_bytes(out),
            "peak_bytes": meter.peak}


def model_flops_global(cfg, shape) -> int:
    """MODEL_FLOPS of one step: 6 * N_active * D for train, 2 * N_active
    * D for inference steps."""
    tokens = (shape.global_batch * shape.seq_len
              if shape.kind != "decode" else shape.global_batch)
    mult = 6 if shape.kind == "train" else 2
    return mult * cfg.active_param_count() * tokens


def record_head(arch_id, shape_name, mesh_kind, mesh, cfg, run, tag="",
                overrides=None, rank=0) -> dict:
    """The record's fields that the configuration fixes (the JAX
    ``run_one``'s, with this rank)."""
    return {
        "arch": arch_id, "shape": shape_name, "mesh": mesh_kind,
        "tag": tag, "overrides": dict(overrides or {}),
        "mesh_shape": dict(mesh.shape), "rank": rank,
        "strategy": run.strategy, "zero_stage": run.zero_stage,
        "microbatches": run.microbatches,
        "params": cfg.param_count(),
        "active_params": cfg.active_param_count(),
        "sliding_window": cfg.sliding_window,
    }


def combo(arch_id: str, shape_name: str, mesh, overrides=None,
          reduced: bool = False):
    """(cfg, run, shape) of one (arch, shape) on ``mesh``, as the JAX
    ``lower_combo`` makes them (``reduced``: the arch's reduced config, for
    a rehearsal on the CPU)."""
    shape = INPUT_SHAPES[shape_name]
    get = get_reduced_config if reduced else get_config
    cfg = shape_for(get(arch_id), shape)
    run = default_run_config(cfg, shape, batch_divisor=_batch_divisor(mesh))
    if overrides:
        run = dataclasses.replace(run, **overrides)
    return cfg, run, shape


def analyze(counted: dict, mesh, cfg, shape) -> dict:
    """The JAX ``analyze``'s record fields from one counted step."""
    n_chips = mesh.devices.size
    census = H.collective_census((r["op"], r["result"], r["group"])
                                 for r in counted["records"])
    flops, hbm = counted["flops"], counted["hbm_bytes"]
    link = census.total_link_bytes
    cost = {"flops_per_device": flops, "hbm_bytes_per_device": hbm,
            "link_bytes_per_device": link}
    out: dict = {"devices": n_chips, "cost_raw": dict(cost),
                 "collectives_raw": census.summary()}
    out["collectives"] = {"calls": counted["calls"],
                          "handed_bytes": counted["handed_bytes"]}
    arg, peak = counted["argument_bytes"], counted["peak_bytes"]
    out["memory"] = {"argument_bytes": arg,
                     "output_bytes": counted["output_bytes"],
                     "temp_bytes": peak - arg, "peak_bytes": peak}
    out["cost"] = dict(
        cost, by_op_link_bytes={op: agg["link_bytes"]
                                for op, agg in census.by_op.items()},
        method="counted (eager, every layer)",
        hbm_note="every aten op's inputs and outputs, views excluded: the "
                 "eager program's traffic, an upper bound on a fused one's")
    out["roofline"] = H.roofline_terms(flops, hbm, link)
    model_flops = model_flops_global(cfg, shape)
    out["model_flops_global"] = model_flops
    total = flops * n_chips
    out["useful_flops_ratio"] = model_flops / total if total else 0.0
    return out


def dry_run(cfg, run, shape, mesh) -> dict:
    """Build this rank's step on ``mesh`` (a mesh of a
    ``virtual_world``), count it and analyze it."""
    step, args = build_step(cfg, run, shape, mesh)
    return count_step(step, args)


def run_one(arch_id: str, shape_name: str, mesh_kind: str, outdir: str,
            overrides=None, tag: str = "", rank: int = 0,
            reduced: bool = False) -> dict:
    """Dry-run one combination as rank ``rank`` of the production mesh
    and write its record; returns the record."""
    t0 = time.time()
    world = math.prod(PRODUCTION_SHAPES[mesh_kind == "multi"][0])
    with virtual_world(rank, world):
        mesh = make_production_mesh(multi_pod=(mesh_kind == "multi"))
        cfg, run, shape = combo(arch_id, shape_name, mesh, overrides,
                                reduced)
        step, args = build_step(cfg, run, shape, mesh)
        t_lower = time.time() - t0
        counted = count_step(step, args)
        rec = record_head(arch_id, shape_name, mesh_kind, mesh, cfg, run,
                          tag, overrides, rank)
        rec.update(analyze(counted, mesh, cfg, shape))
    rec["lower_s"] = round(t_lower, 1)
    rec["total_s"] = round(time.time() - t0, 1)
    os.makedirs(outdir, exist_ok=True)
    suffix = f"__{tag}" if tag else ""
    fname = f"{arch_id}__{shape_name}__{mesh_kind}{suffix}.json"
    with open(os.path.join(outdir, fname), "w") as f:
        json.dump(rec, f, indent=1)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="repro_torch.launch.dryrun")
    ap.add_argument("--arch", nargs="*", default=ARCH_IDS)
    ap.add_argument("--shape", nargs="*", default=list(INPUT_SHAPES))
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="single")
    ap.add_argument("--outdir", default="results/dryrun_torch")
    ap.add_argument("--keep-going", action="store_true")
    ap.add_argument("--rank", type=int, default=0,
                    help="the rank of the production mesh whose program "
                    "runs (default 0)")
    ap.add_argument("--tag", default="", help="suffix for the output JSON")
    ap.add_argument("--seq-parallel", action="store_true")
    ap.add_argument("--gather-bf16", action="store_true")
    ap.add_argument("--moe-defer-combine", action="store_true")
    ap.add_argument("--grad-reduce-bf16", action="store_true")
    ap.add_argument("--micro", type=int, default=None)
    ap.add_argument("--strategy", default=None)
    ap.add_argument("--remat", default=None)
    args = ap.parse_args(argv)

    overrides = {}
    if args.seq_parallel:
        overrides["seq_parallel"] = True
    if args.gather_bf16:
        overrides["gather_bf16"] = True
    if args.moe_defer_combine:
        overrides["moe_defer_combine"] = True
    if args.grad_reduce_bf16:
        overrides["grad_reduce_bf16"] = True
    if args.micro is not None:
        overrides["microbatches"] = args.micro
    if args.strategy:
        overrides["strategy"] = args.strategy
    if args.remat:
        overrides["remat"] = args.remat

    meshes = {"single": ["single"], "multi": ["multi"],
              "both": ["single", "multi"]}[args.mesh]
    failures = []
    for arch in args.arch:
        for shape in args.shape:
            for mk in meshes:
                tag = f"{arch} x {shape} x {mk}"
                try:
                    rec = run_one(arch, shape, mk, args.outdir,
                                  overrides=overrides, tag=args.tag,
                                  rank=args.rank)
                    r = rec["roofline"]
                    print(f"[ok] {tag:55s} "
                          f"C={r['compute_s']:.3e}s "
                          f"M={r['memory_s']:.3e}s "
                          f"N={r['collective_s']:.3e}s "
                          f"-> {r['bottleneck']:10s} "
                          f"useful={rec['useful_flops_ratio']:.2f} "
                          f"peak={rec['memory']['peak_bytes'] / 2**30:.2f}"
                          f"GiB ({rec['total_s']}s)", flush=True)
                except Exception as e:   # noqa: BLE001
                    failures.append((tag, repr(e)))
                    print(f"[FAIL] {tag}: {e}", flush=True)
                    if not args.keep_going:
                        traceback.print_exc()
                        return 1
    if failures:
        print(f"\n{len(failures)} failures:")
        for tag, err in failures:
            print(f"  {tag}: {err}")
        return 1
    print("\nall dry-run combinations ran on meta OK")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
