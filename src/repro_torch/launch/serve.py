"""`python -m repro_torch.launch.serve` — the port's serving entry point:
spin up the DecodeEngine on an architecture and push a synthetic request
load through it, reporting throughput and latency — per tenant when
``--tenants`` carves the engine into fair-share slices.

Runs on the CUDA device unless ``--device cpu`` is given; with no CUDA
device and no explicit CPU request it raises.  Attention runs through the
hand-written CUDA kernels on the card.

The engine's serving modes have the JAX CLI's flags: ``--prefix-cache``
(with ``--shared-prefix N`` to give the synthetic requests a common system
prompt), ``--max-batch-tokens [T]``, ``--speculate [K]`` with
``--spec-source`` and ``--draft-model``, ``--no-fused`` and ``--trace
OUT_JSON``.  The first three imply ``--kv-paging 16``.

Tensor-parallel serving, as in the JAX CLI: ``--tp N`` runs N ranks
(``serving.tp.launch``), each a process holding 1/N of the attention
heads and of d_ff, one card a rank over NCCL; with ``--device cpu`` the N
ranks are gloo processes on the CPU.  Fewer cards than N run tp=1 with
the JAX CLI's warning.  Rank 0's output is printed.

Elastic serving, as in the JAX CLI: ``--replicas N`` puts N engines behind
the prefix-affinity router (``--affinity``, ``--spill-factor F``; round
robin otherwise), and ``--autoscale`` runs them as scavenger jobs of a
small simulated cluster (nodes of ``gpu: 4``) whose autoscaler drains one
replica when a high-QOS batch job preempts it.  The weights are cast to
the compute dtype once, before any engine is built, so every replica on
the card reads the same weight set.
"""
from __future__ import annotations

import argparse
import contextlib
import io
import time

import numpy as np
import torch

from repro_torch.cluster import (
    Cluster, Node, Partition, ResourceRequest,
)
from repro_torch.cluster.commands import sdiag
from repro_torch.configs import ARCH_IDS, PORT_ARCH_IDS, RunConfig, \
    get_config, get_reduced_config
from repro_torch.device import resolve_device
from repro_torch.models import init_params
from repro_torch.models.model import cast_for_compute, compute_dtype
from repro_torch.monitoring import MetricsRegistry, Tracer
from repro_torch.monitoring.metrics import (
    METRIC_SERVE_PREFIX_EVICTIONS, METRIC_SERVE_PREFIX_HITS,
    METRIC_SERVE_PREFIX_MISSES, METRIC_SERVE_PREFIX_REUSED_TOKENS,
    METRIC_SERVE_TENANT_TOKENS,
)
from repro_torch.serving import (
    AdmissionController, Autoscaler, DecodeEngine, Request, Router,
)
from repro_torch.serving import tp as tp_mod

#: page size that --prefix-cache, --max-batch-tokens and --speculate fall
#: back to when --kv-paging is absent
DEFAULT_PAGE_SIZE = 16


def resolve_paging(args) -> int:
    """--prefix-cache, --max-batch-tokens and --speculate need the paged
    KV cache: with no explicit page size the default kicks in, and the CLI
    says so."""
    if args.kv_paging:
        return args.kv_paging
    for flag, on in (("--prefix-cache", args.prefix_cache),
                     ("--max-batch-tokens",
                      args.max_batch_tokens is not None),
                     ("--speculate", bool(args.speculate))):
        if on:
            print(f"[serve] {flag} implies --kv-paging: using "
                  f"{DEFAULT_PAGE_SIZE}-line pages")
            return DEFAULT_PAGE_SIZE
    return 0


def resolve_tp(requested: int, n_devices: int) -> int:
    """``--tp`` with a graceful fallback: fewer visible devices than the
    requested shard count downgrades to tp=1 with a warning (and a hint
    at the forced-host-device recipe) instead of crashing the deploy.
    The JAX CLI's function and message, word for word; the port's way to
    rehearse N shards on the CPU is ``--device cpu``, whose N gloo ranks
    are the forced host devices' counterpart."""
    if requested <= 1:
        return 1
    if n_devices < requested:
        print(f"[serve] --tp {requested}: only {n_devices} device(s) "
              f"visible — running tp=1 (set XLA_FLAGS="
              f"--xla_force_host_platform_device_count={requested} before "
              f"import to fake devices on CPU)")
        return 1
    return requested


def parse_tenants(spec: str, shares: str = "") -> dict[str, int]:
    """``alice:8,bob:1`` (or ``--tenants alice,bob --shares 8,1``) ->
    {"alice": 8, "bob": 1}."""
    out: dict[str, int] = {}
    names = [p.strip() for p in spec.split(",") if p.strip()]
    extra = [s.strip() for s in shares.split(",") if s.strip()] if shares \
        else []
    for i, part in enumerate(names):
        name, _, inline = part.partition(":")
        if inline:
            share = int(inline)
        elif i < len(extra):
            share = int(extra[i])
        else:
            share = 1
        assert share >= 1, f"tenant {name!r}: shares must be >= 1"
        out[name] = share
    return out


def parse_buckets(spec: str):
    """``auto`` -> power-of-two buckets, ``off`` -> exact-length prefill,
    ``32,64,128`` -> explicit bucket lengths."""
    spec = spec.strip().lower()
    if spec in ("", "off", "none"):
        return None
    if spec == "auto":
        return "auto"
    return tuple(int(p) for p in spec.split(",") if p.strip())


def make_requests(args, cfg, names, qos_cycle) -> list:
    """The synthetic workload (the JAX CLI's): per-request prompt lengths,
    tenants and QOS are a pure function of ``--seed``; ``--shared-prefix
    N`` puts the same N-token system prompt ahead of every prompt (a
    phrase of 8 tokens repeated under ``--speculate``, with the prompt's
    tail back inside it, so prompt-lookup drafts have material)."""
    rng = np.random.default_rng(args.seed)
    assert args.shared_prefix < args.cache_len, "--shared-prefix too long"
    system = rng.integers(2, cfg.vocab_size,
                          args.shared_prefix).astype(np.int32)
    if args.speculate and args.shared_prefix >= 8:
        phrase = system[:8]
        system = np.tile(phrase, -(-args.shared_prefix // 8))[
            :args.shared_prefix]
    requests = []
    for rid in range(args.requests):
        plen = int(rng.integers(4, args.cache_len // 4))
        prompt = rng.integers(2, cfg.vocab_size, plen).astype(np.int32)
        if args.shared_prefix:
            prompt = np.concatenate([system, prompt])[:args.cache_len - 1]
            if args.speculate and args.shared_prefix >= 8:
                prompt = np.concatenate([prompt, system[:8]])[
                    :args.cache_len - 1]
        requests.append(Request(
            rid=rid,
            prompt=prompt,
            max_new_tokens=args.max_new,
            temperature=float(rid % 2) * 0.8,
            tenant=names[rid % len(names)],
            qos=qos_cycle[rid % len(qos_cycle)]))
    return requests


def elastic_factory(args, cfg, params, metrics, kv_paging: int, device):
    """The replica factory of ``--replicas``/``--autoscale``: an engine
    wired to the admission controller the router gives it.  ``params``
    must already be in the compute dtype (``cast_for_compute``), so that
    the engine's own cast returns the same tensors and every replica
    shares one weight set."""
    def make_engine(admission):
        return DecodeEngine(
            cfg, params, num_slots=args.slots, cache_len=args.cache_len,
            metrics=metrics, admission=admission,
            run=RunConfig(use_kernels=True), seed=args.seed,
            decode_chunk=args.decode_chunk, fused=not args.no_fused,
            prefill_buckets=parse_buckets(args.prefill_buckets),
            kv_page_size=kv_paging, kv_pages=args.kv_pages,
            prefix_cache=args.prefix_cache,
            max_batch_tokens=args.max_batch_tokens, device=device)
    return make_engine


def start_elastic(args, make_engine, metrics, tenants: dict):
    """The router over ``--replicas`` engines; with ``--autoscale``, a
    simulated cluster of ``max(replicas, 2)`` nodes of ``gpu: 4`` whose
    autoscaler starts the replicas as scavenger jobs (one node each).
    Returns ``(router, autoscaler, cluster)``, the last two None without
    ``--autoscale``."""
    router = Router(make_engine,
                    replicas=0 if args.autoscale else args.replicas,
                    policy="affinity" if args.affinity else "rr",
                    spill_factor=args.spill_factor, metrics=metrics)
    for name, share in tenants.items():
        router.add_tenant(name, shares=share)
    autoscaler = cluster = None
    if args.autoscale:
        n_nodes = max(args.replicas, 2)
        nodes = [Node(name=f"n{i:02d}", cpus=16, mem_mb=65536,
                      gres={"gpu": 4}) for i in range(n_nodes)]
        cluster = Cluster(nodes, [Partition(
            name="serve", nodes=tuple(nd.name for nd in nodes),
            default=True)])
        autoscaler = Autoscaler(
            router, cluster,
            req=ResourceRequest(nodes=1, gres_per_node={"gpu": 4},
                                time_limit_s=36_000),
            min_replicas=1, max_replicas=max(args.replicas, 1))
        autoscaler.tick()
        print(f"[serve] autoscaler: probe saw "
              f"{autoscaler.stats['last_probe']} idle node(s), started "
              f"{len(router.replicas)} replica(s) as scavenger jobs")
    return router, autoscaler, cluster


def run_waves(args, server, requests, autoscaler=None,
              cluster=None) -> float:
    """Push ``requests`` through ``server`` (an engine or the router) in
    ``--bursts`` waves, three steps after each wave but the last; with an
    autoscaler, after the first wave a high-QOS batch job preempts one
    replica's job and the next tick drains that replica (its requests
    resume elsewhere with their partial output).  Runs to completion;
    returns the wall seconds."""
    bursts = max(args.bursts, 1)
    per_wave = -(-len(requests) // bursts)       # ceil division
    t0 = time.perf_counter()
    for w in range(bursts):
        for req in requests[w * per_wave:(w + 1) * per_wave]:
            server.submit(req)
        if w < bursts - 1:
            for _ in range(3):                    # let the wave decode a bit
                server.step()
        if autoscaler is not None and w == 0 and len(server.replicas) > 1:
            cluster.submit("batch-train", ResourceRequest(
                nodes=1, gres_per_node={"gpu": 4}), qos="high",
                run_time_s=600.0)
            autoscaler.tick()
            print(f"[serve] batch pressure: drained down to "
                  f"{len(server.replicas)} replica(s), "
                  f"{server.stats['resubmitted']} request(s) re-routed")
    server.run_to_completion()
    return time.perf_counter() - t0


def _serve_elastic(args, cfg, params, metrics, tenants, kv_paging, device,
                   requests) -> int:
    """--replicas/--autoscale: N engines behind the prefix-affinity
    router, optionally as scavenger jobs in a small simulated cluster
    with the autoscaler driving the replica count."""
    if args.tp > 1:
        print("[serve] --replicas/--autoscale path ignores --tp, "
              "--speculate and --trace (single-engine features)")
    elif args.speculate or args.trace:
        print("[serve] --replicas/--autoscale path ignores --speculate "
              "and --trace (single-engine features)")
    make_engine = elastic_factory(args, cfg, params, metrics, kv_paging,
                                  device)
    router, autoscaler, cluster = start_elastic(args, make_engine, metrics,
                                                tenants)
    wall = run_waves(args, router, requests, autoscaler, cluster)
    total = int(metrics.counter("serve_tokens_generated").value())
    busy = max(router.busy_seconds().values())
    st = router.stats
    print(f"served {len(requests)} requests on {len(router.replicas)} "
          f"replica(s), {total} tokens in {wall:.1f}s "
          f"({total / wall:,.1f} tok/s wall, busiest replica "
          f"{busy:.1f}s busy)")
    print(f"router: policy {router.policy}, {st['routed']} routed, "
          f"{st['affinity_hits']} affinity hits, {st['spills']} spills, "
          f"{st['drains']} drains ({st['resubmitted']} re-routed)")
    if args.prefix_cache:
        hits = int(metrics.counter(METRIC_SERVE_PREFIX_HITS).value())
        misses = int(metrics.counter(METRIC_SERVE_PREFIX_MISSES).value())
        reused = int(metrics.counter(
            METRIC_SERVE_PREFIX_REUSED_TOKENS).value())
        print(f"prefix cache (all replicas): {hits} hits / {misses} "
              f"misses, {reused} prompt tokens reused")
    print(sdiag(cluster=cluster, router=router, autoscaler=autoscaler))
    return 0


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="repro_torch.launch.serve")
    ap.add_argument("--arch", default="stablelm-3b",
                    choices=ARCH_IDS + PORT_ARCH_IDS)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--cache-len", type=int, default=256)
    ap.add_argument("--max-new", type=int, default=24)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--decode-chunk", type=int, default=8,
                    help="tokens generated per decode call (one host sync "
                         "per chunk); 1 = per-token chunks")
    ap.add_argument("--no-fused", action="store_true",
                    help="use the per-token host sampling loop")
    ap.add_argument("--prefill-buckets", default="auto",
                    help="'auto' (power-of-two), 'off', or comma lengths "
                         "e.g. 32,64,128 — prompts pad to the next bucket")
    ap.add_argument("--tp", type=int, default=1, metavar="N",
                    help="tensor-parallel serving over N ranks: the "
                         "weights, the decode calls and the KV cache "
                         "shard over a (1, N) mesh's 'model' axis, one "
                         "card a rank (gloo processes with --device cpu); "
                         "f32 greedy output stays as at --tp 1 (falls "
                         "back to 1 when fewer cards are visible)")
    ap.add_argument("--kv-paging", type=int, default=0, metavar="PAGE_SIZE",
                    help="paged KV cache with PAGE_SIZE-line pages "
                         "(0 = dense per-slot cache)")
    ap.add_argument("--kv-pages", type=int, default=None,
                    help="page-pool size override (default: dense-budget "
                         "equivalent, slots*cache_len/page_size + null)")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="radix prefix cache: requests sharing a prompt "
                         "prefix map the same KV pages read-only and "
                         "prefill only their suffix (implies --kv-paging "
                         f"{DEFAULT_PAGE_SIZE})")
    ap.add_argument("--shared-prefix", type=int, default=0, metavar="N",
                    help="prepend the same N-token system prompt to every "
                         "synthetic request (exercises --prefix-cache)")
    ap.add_argument("--max-batch-tokens", type=int, nargs="?", const=512,
                    default=None, metavar="T",
                    help="token-budgeted iterations mixing decode lanes "
                         "and prefill chunks under a T-token budget, so "
                         "long prompts stop blocking short ones (bare "
                         "flag: T=512; implies --kv-paging "
                         f"{DEFAULT_PAGE_SIZE})")
    ap.add_argument("--speculate", type=int, nargs="?", const=4,
                    default=0, metavar="K",
                    help="speculative decoding: draft up to K tokens per "
                         "lane and verify them in one call — greedy "
                         "output stays identical, temperature uses "
                         "rejection sampling (bare flag: K=4; implies "
                         f"--kv-paging {DEFAULT_PAGE_SIZE})")
    ap.add_argument("--spec-source", default="ngram",
                    choices=("ngram", "model"),
                    help="draft source: 'ngram' prompt lookup, or 'model' "
                         "(a small draft model with its own dense cache)")
    ap.add_argument("--draft-model", default=None, choices=ARCH_IDS,
                    metavar="ARCH",
                    help="with --spec-source model: the architecture to "
                         "draft with (reduced; must share the target's "
                         "vocabulary).  Default: a 1-layer shrink of the "
                         "target config")
    ap.add_argument("--trace", default="", metavar="OUT_JSON",
                    help="record request-lifecycle spans, write a Chrome "
                         "trace-event JSON (Perfetto, chrome://tracing) "
                         "and print sdiag's admission, serve-step, "
                         "speculation and SLO sections")
    ap.add_argument("--tenants", default="",
                    help="tenant:shares list, e.g. alice:8,bob:1 "
                         "(empty: single default tenant)")
    ap.add_argument("--shares", default="",
                    help="shares for --tenants given as bare names, "
                         "e.g. --tenants alice,bob --shares 8,1")
    ap.add_argument("--qos", default="",
                    help="comma list of QOS tiers cycled across requests "
                         "(e.g. high,scavenger); empty = all 'normal'")
    ap.add_argument("--bursts", type=int, default=1,
                    help="submit the workload in N bursts with a few "
                         "decode steps between waves")
    ap.add_argument("--replicas", type=int, default=1, metavar="N",
                    help="elastic serving: N decode-engine replicas "
                         "behind the router; replicas share one "
                         "fair-share ledger and one GrpTRES scope")
    ap.add_argument("--affinity", action="store_true",
                    help="prefix-affinity routing (consistent hash on "
                         "the first prompt page, spill to least-loaded); "
                         "default with --replicas is round-robin")
    ap.add_argument("--spill-factor", type=float, default=2.0,
                    help="with --affinity: shed to the least-loaded "
                         "replica once the affine one's queue runs this "
                         "many num_slots deeper (default 2.0)")
    ap.add_argument("--autoscale", action="store_true",
                    help="run replicas as scavenger jobs in a small "
                         "simulated cluster: the autoscaler grows to "
                         "--replicas while idle nodes exist and drains "
                         "replicas when a batch job preempts them")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; 'cpu' runs the "
                         "kernels' plain versions)")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    device = resolve_device(args.device)
    tp = resolve_tp(args.tp, args.tp if device.type == "cpu"
                    else torch.cuda.device_count())
    if tp > 1 and not (args.replicas > 1 or args.autoscale):
        if device.type == "cpu":
            devices, backend = ["cpu"] * tp, "gloo"
            threads = max(1, torch.get_num_threads() // tp)
        else:
            devices, backend = [f"cuda:{i}" for i in range(tp)], "nccl"
            threads = None
        outs = tp_mod.launch(_serve_rank, tp, devices=devices,
                             backend=backend, args=(args,), threads=threads)
        print(outs[0], end="")
        return 0
    return serve(args, device)


def _serve_rank(mesh, args) -> str:
    """One rank of ``--tp``: the whole serve run on the rank's device;
    returns what it printed (rank 0's is the CLI's output)."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        serve(args, mesh.device, mesh)
    return out.getvalue()


def serve(args, device, mesh=None) -> int:
    """The serve run of ``args`` on ``device`` (one rank of ``mesh``
    under ``--tp``): build the weights from the seed, serve the synthetic
    requests, print the report."""
    cfg = (get_reduced_config(args.arch) if args.reduced
           else get_config(args.arch))
    # cast once: the engine's own cast then returns these tensors, and
    # the replicas of --replicas share them
    params = cast_for_compute(init_params(cfg, args.seed, device),
                              compute_dtype(cfg))
    metrics = MetricsRegistry()
    tenants = parse_tenants(args.tenants, args.shares) if args.tenants \
        else {"default": 1}
    kv_paging = resolve_paging(args)
    names = list(tenants)
    qos_cycle = [q.strip() for q in args.qos.split(",") if q.strip()] \
        or ["normal"]
    requests = make_requests(args, cfg, names, qos_cycle)
    if args.replicas > 1 or args.autoscale:
        return _serve_elastic(args, cfg, params, metrics, tenants,
                              kv_paging, device, requests)
    tracer = Tracer(metrics=metrics) if args.trace else None
    admission = AdmissionController(tracer=tracer)
    for name, share in tenants.items():
        admission.add_tenant(name, shares=share)
    draft_cfg = None
    if args.draft_model is not None:
        draft_cfg = get_reduced_config(args.draft_model)
        assert draft_cfg.vocab_size == cfg.vocab_size, \
            "--draft-model must share the target's vocabulary"
    engine = DecodeEngine(cfg, params, num_slots=args.slots,
                          cache_len=args.cache_len, metrics=metrics,
                          admission=admission,
                          run=RunConfig(use_kernels=True),
                          seed=args.seed,
                          decode_chunk=args.decode_chunk,
                          fused=not args.no_fused,
                          prefill_buckets=parse_buckets(args.prefill_buckets),
                          kv_page_size=kv_paging,
                          kv_pages=args.kv_pages,
                          prefix_cache=args.prefix_cache,
                          max_batch_tokens=args.max_batch_tokens,
                          tracer=tracer,
                          speculate=args.speculate,
                          spec_source=args.spec_source,
                          draft_model=draft_cfg,
                          mesh=mesh,
                          device=device)
    del params              # the rank's shard is all that stays under --tp
    wall = run_waves(args, engine, requests)
    total = int(metrics.counter("serve_tokens_generated").value())
    mode = ("host loop" if args.no_fused
            else f"fused chunk={args.decode_chunk}")
    print(f"served {args.requests} requests, {total} tokens in {wall:.1f}s "
          f"({total / wall:,.1f} tok/s, {args.slots} slots, {mode}, "
          f"{device})")
    if engine.prefill_buckets:
        print(f"prefill buckets {engine.prefill_buckets}: "
              f"{len(engine.prefill_lengths)} bucket lengths used")
    if engine.paging is not None:
        print(f"paged KV: {engine.paging.page_size}-line pages, pool "
              f"{engine.paging.usable_pages} pages "
              f"(high-water {engine.allocator.high_water}, "
              f"{int(metrics.counter('serve_page_starvations').value())} "
              f"starvation requeues)")
    if engine.tp.tp > 1:
        ps = engine.tp.psums_per_token(cfg)
        print(f"tensor parallel: {engine.tp.describe(cfg)} on "
              f"{len(engine.tp.devices())} devices, "
              f"{sum(ps.values())} psums/token "
              f"(attn {ps['attn_out']}, mlp {ps['mlp_out']})")
    if engine.max_batch_tokens is not None:
        st = engine.serve_stats
        spent = st["decode_tokens"] + st["prefill_tokens"]
        cap = st["iterations"] * engine.max_batch_tokens
        print(f"chunked prefill: budget {engine.max_batch_tokens} "
              f"tok/step, {st['iterations']} iterations, fill "
              f"{spent}/{cap} ({spent / cap if cap else 0:.0%}), "
              f"{st['prefill_chunks']} prefill chunks (bucket lengths "
              f"{sorted(engine.chunk_lengths)})")
    if engine.speculate:
        st = engine.spec_stats
        rate = st["accepted"] / st["proposed"] if st["proposed"] else 0.0
        per_round = st["emitted"] / st["rounds"] if st["rounds"] else 0.0
        print(f"speculative decoding: k={engine.speculate} "
              f"({args.spec_source}), {st['rounds']} verify rounds, "
              f"accepted {st['accepted']}/{st['proposed']} drafts "
              f"({rate:.0%}), {per_round:.2f} tokens/round")
    if engine.prefix is not None:
        hits = int(metrics.counter(METRIC_SERVE_PREFIX_HITS).value())
        misses = int(metrics.counter(METRIC_SERVE_PREFIX_MISSES).value())
        reused = int(metrics.counter(
            METRIC_SERVE_PREFIX_REUSED_TOKENS).value())
        evicted = int(metrics.counter(METRIC_SERVE_PREFIX_EVICTIONS).value())
        print(f"prefix cache: {hits} hits / {misses} misses, {reused} "
              f"prompt tokens reused, {evicted} pages evicted, "
              f"{engine.prefix.nodes} pages cached")
    if len(names) > 1 and total:
        tok = metrics.counter(METRIC_SERVE_TENANT_TOKENS)
        parts = []
        for name in names:
            n = int(tok.value(tenant=name))
            parts.append(f"{name}[{tenants[name]}sh]={n} "
                         f"({n / total:.0%})")
        print("per-tenant tokens: " + "  ".join(parts))
    print(f"decode p50 "
          f"{metrics.histogram('serve_decode_seconds').quantile(0.5)*1e3:.1f}"
          f"ms  p99 "
          f"{metrics.histogram('serve_decode_seconds').quantile(0.99)*1e3:.1f}"
          f"ms")
    if tracer is not None:
        data = tracer.export_chrome(args.trace)
        print(f"trace: {len(data['traceEvents'])} events -> {args.trace} "
              f"(load in ui.perfetto.dev)")
        print(sdiag(admission=admission, tracer=tracer, engine=engine))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
