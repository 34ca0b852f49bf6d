"""Scenarios of ``tests/test_torch_tp_serving.py`` and the function its
tensor-parallel ranks run.

This module imports no JAX: each rank is a process of its own
(``repro_torch.serving.tp.launch``, ``spawn``), which imports it by name.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

#: engine options of each scenario (``kernels``: the kernels' route —
#: ``use_kernels`` in the port, ``use_pallas`` in the JAX package;
#: ``heads3``: 3 heads = 3 kv heads, which 2 shards do not divide) and its
#: request set
SCENARIOS = {
    "dense": (dict(), "basic"),
    "paged": (dict(kv_page_size=8), "basic"),
    "budgeted": (dict(kv_page_size=8, max_batch_tokens=16), "long"),
    "prefix": (dict(kv_page_size=8, prefix_cache=True), "prefix"),
    "speculative": (dict(kv_page_size=8, speculate=2), "repeat"),
    "starved": (dict(kv_page_size=8, kv_pages=4), "basic"),
    "kernels": (dict(kv_page_size=8, kernels=True), "basic"),
    "heads3": (dict(kv_page_size=8, heads3=True), "basic"),
}

NUM_SLOTS, CACHE_LEN = 2, 64


def request_specs(kind: str) -> list:
    """(prompt, max_new_tokens) of a request set, all greedy.  "prefix":
    the third prompt starts with the first one's two complete 8-line pages;
    "long": a 30-token prompt that a 16-token budget prefills in two
    chunks; "repeat": repeated phrases for the n-gram drafts."""
    basic = [(np.arange(1, 9), 6), (np.arange(3, 17), 5)]
    if kind == "basic":
        out = basic
    elif kind == "long":
        out = basic + [(np.arange(20, 50), 4)]
    elif kind == "prefix":
        out = [(np.arange(3, 19), 6), (np.arange(1, 9), 5),
               (np.concatenate([np.arange(3, 19), [40, 41, 42]]), 4)]
    elif kind == "repeat":
        out = [(np.tile([5, 6, 7, 8], 4), 8), (np.tile([9, 10, 11], 5), 6)]
    else:
        raise ValueError(kind)
    return [(np.asarray(p, np.int32), n) for p, n in out]


def torch_options(options: dict):
    """The port's engine options and RunConfig of a scenario."""
    from repro_torch.configs import RunConfig

    options = dict(options)
    kernels = options.pop("kernels", False)
    options.pop("heads3", None)
    return options, RunConfig(use_kernels=kernels)


def scenario_cfg(cfg, options: dict):
    if options.get("heads3"):
        return dataclasses.replace(cfg, num_heads=3, num_kv_heads=3)
    return cfg


def serve_torch(cfg, params, options: dict, kind: str, mesh=None,
                device="cpu", admission=None):
    """Serve a request set through the port's engine; returns the engine
    and the requests."""
    from repro_torch.serving import DecodeEngine, Request

    opts, run = torch_options(options)
    eng = DecodeEngine(cfg, params, num_slots=NUM_SLOTS, cache_len=CACHE_LEN,
                       run=run, mesh=mesh,
                       device=None if mesh is not None else device,
                       admission=admission, prefill_buckets="auto", **opts)
    reqs = [Request(rid=i, prompt=p, max_new_tokens=n)
            for i, (p, n) in enumerate(request_specs(kind))]
    for r in reqs:
        eng.submit(r)
    eng.run_to_completion()
    return eng, reqs


def prefill_logits(eng, prompt) -> np.ndarray:
    """The logits at the prompt's last position of a one-request prefill
    padded to the first bucket, through the engine's (sharded) weights
    under its reduction scope."""
    from repro_torch.models.model import prefill

    tokens = np.zeros(eng.prefill_buckets[0], np.int32)
    tokens[:len(prompt)] = prompt
    with torch.no_grad(), eng.tp_scope():
        logits, _ = prefill(
            eng.params, {"tokens": torch.from_numpy(tokens)[None]}, eng.cfg,
            eng.run, last_pos=len(prompt) - 1)
    return logits[0, -1].float().numpy()


def _one_decode_step(cfg, params, mesh, dtype):
    """All-reduces of one decode step of a dense engine of 2 slots in
    ``dtype``: (counts by point, dtypes reduced)."""
    import torch.distributed as dist

    from repro_torch.models.model import decode_step
    from repro_torch.serving import DecodeEngine

    c = dataclasses.replace(cfg, dtype=dtype)
    eng = DecodeEngine(c, params, num_slots=2, cache_len=16, mesh=mesh)
    seen = []
    real = dist.all_reduce

    def record(t, *a, **k):
        seen.append(str(t.dtype))
        return real(t, *a, **k)

    dist.all_reduce = record
    try:
        with torch.no_grad(), eng.tp_scope():
            decode_step(eng.params, eng.cache,
                        torch.zeros((2, 1), dtype=torch.int64),
                        torch.zeros(2, dtype=torch.int64), c, eng.run)
    finally:
        dist.all_reduce = real
    return dict(eng.tp_counts), sorted(set(seen))


def rank_main(mesh, cfg, np_params, np_params3) -> dict:
    """Every scenario on this rank (weights: numpy trees of the JAX
    init), then the reduction counts of one decode step, the lockstep
    clock under per-rank clocks a day apart, and a deliberate
    divergence."""
    from repro_torch.monitoring.metrics import METRIC_SERVE_PREFIX_HITS
    from repro_torch.serving import AdmissionController, Request
    from repro_torch.serving import DecodeEngine
    from repro_torch.weights import params_from_jax

    params = params_from_jax(np_params)
    params3 = params_from_jax(np_params3)
    out = {}
    for name, (options, kind) in SCENARIOS.items():
        c, p = ((scenario_cfg(cfg, options), params3)
                if options.get("heads3") else (cfg, params))
        eng, reqs = serve_torch(c, p, options, kind, mesh=mesh)
        out[name] = {
            "outputs": [list(r.output) for r in reqs],
            "done": all(r.done for r in reqs),
            "in_use": ([int(n) for n in eng.pool_view.in_use_vector()]
                       if eng.paging is not None else None),
            "index_pages": (eng.prefix.nodes if eng.prefix is not None
                            else 0),
            "tp_stats": eng.tp_stats(),
            "counts": dict(eng.tp_counts),
            "cache_heads": [int(layer["k"].shape[3])
                            for layer in eng.cache["layers"]],
            "logits": prefill_logits(eng, reqs[0].prompt),
            "spec_rounds": eng.spec_stats["rounds"],
            "hits": int(eng.metrics.counter(
                METRIC_SERVE_PREFIX_HITS).value()),
            "starvations": int(eng.metrics.counter(
                "serve_page_starvations").value()),
            "chunks": eng.serve_stats["prefill_chunks"],
        }
    out["step"] = {
        "float32": _one_decode_step(cfg, params, mesh, "float32"),
        "bfloat16": _one_decode_step(cfg, params, mesh, "bfloat16"),
        "heads3": _one_decode_step(scenario_cfg(cfg, {"heads3": True}),
                                   params3, mesh, "float32"),
    }
    # wall-clock decay with clocks a day apart: rank 0's clock rules
    day = 86_400.0 * mesh.rank
    adm = AdmissionController(wall_clock_decay=True,
                              clock=lambda: 1e6 + day + _tick())
    adm.add_tenant("a", shares=1)
    adm.add_tenant("b", shares=1)
    eng, reqs = serve_torch(cfg, params, {"kv_page_size": 8}, "basic",
                            mesh=mesh, admission=adm)
    out["clock"] = {"outputs": [list(r.output) for r in reqs],
                    "usage": dict(adm.tree.usage),
                    "last_decay": adm.tree._last_decay}
    # after a step in lockstep, rank 1's host state moves a position on:
    # the next decode call must refuse on both ranks
    eng = DecodeEngine(cfg, params, num_slots=NUM_SLOTS, cache_len=CACHE_LEN,
                       mesh=mesh)
    for i, (p, n) in enumerate(request_specs("basic")):
        eng.submit(Request(rid=i, prompt=p, max_new_tokens=n))
    eng.step()
    if mesh.rank == 1:
        eng.pos[1] += 1
    try:
        eng.step()
        out["diverged"] = None
    except RuntimeError as e:
        out["diverged"] = str(e)
    return out


_T = [0.0]


def _tick() -> float:
    """A clock that advances 100 s a reading (decay is visible)."""
    _T[0] += 100.0
    return _T[0]
