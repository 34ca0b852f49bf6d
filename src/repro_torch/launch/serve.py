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
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.cluster.commands import sdiag
from repro_torch.configs import ARCH_IDS, RunConfig, get_config, \
    get_reduced_config
from repro_torch.device import resolve_device
from repro_torch.models import init_params
from repro_torch.monitoring import MetricsRegistry, Tracer
from repro_torch.monitoring.metrics import (
    METRIC_SERVE_PREFIX_EVICTIONS, METRIC_SERVE_PREFIX_HITS,
    METRIC_SERVE_PREFIX_MISSES, METRIC_SERVE_PREFIX_REUSED_TOKENS,
    METRIC_SERVE_TENANT_TOKENS,
)
from repro_torch.serving import AdmissionController, DecodeEngine, Request

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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="repro_torch.launch.serve")
    ap.add_argument("--arch", default="stablelm-3b", choices=ARCH_IDS)
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
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; 'cpu' runs the "
                         "kernels' plain versions)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = (get_reduced_config(args.arch) if args.reduced
           else get_config(args.arch))
    params = init_params(cfg, args.seed, device)
    metrics = MetricsRegistry()
    tenants = parse_tenants(args.tenants, args.shares) if args.tenants \
        else {"default": 1}
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
                          kv_page_size=resolve_paging(args),
                          kv_pages=args.kv_pages,
                          prefix_cache=args.prefix_cache,
                          max_batch_tokens=args.max_batch_tokens,
                          tracer=tracer,
                          speculate=args.speculate,
                          spec_source=args.spec_source,
                          draft_model=draft_cfg,
                          device=device)
    del params                               # the engine holds its cast copy
    names = list(tenants)
    qos_cycle = [q.strip() for q in args.qos.split(",") if q.strip()] \
        or ["normal"]
    requests = make_requests(args, cfg, names, qos_cycle)
    bursts = max(args.bursts, 1)
    per_wave = -(-len(requests) // bursts)       # ceil division
    t0 = time.perf_counter()
    for w in range(bursts):
        for req in requests[w * per_wave:(w + 1) * per_wave]:
            engine.submit(req)
        if w < bursts - 1:
            for _ in range(3):                    # let the wave decode a bit
                engine.step()
    engine.run_to_completion()
    wall = time.perf_counter() - t0
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
