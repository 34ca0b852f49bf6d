"""`python -m repro_torch.launch.serve` — the port's serving entry point:
spin up the DecodeEngine on an architecture and push a synthetic request
load through it, reporting throughput and latency — per tenant when
``--tenants`` carves the engine into fair-share slices.

Runs on the CUDA device unless ``--device cpu`` is given; with no CUDA
device and no explicit CPU request it raises.  Attention runs through the
hand-written CUDA kernels on the card.
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.configs import ARCH_IDS, RunConfig, get_config, \
    get_reduced_config
from repro_torch.device import resolve_device
from repro_torch.models import init_params
from repro_torch.monitoring import MetricsRegistry
from repro_torch.monitoring.metrics import METRIC_SERVE_TENANT_TOKENS
from repro_torch.serving import AdmissionController, DecodeEngine, Request


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
    """The synthetic workload: per-request prompt lengths, tenants and QOS
    are a pure function of ``--seed`` (the JAX CLI's workload without its
    shared-prefix option)."""
    rng = np.random.default_rng(args.seed)
    requests = []
    for rid in range(args.requests):
        plen = int(rng.integers(4, args.cache_len // 4))
        prompt = rng.integers(2, cfg.vocab_size, plen).astype(np.int32)
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
    ap.add_argument("--prefill-buckets", default="auto",
                    help="'auto' (power-of-two), 'off', or comma lengths "
                         "e.g. 32,64,128 — prompts pad to the next bucket")
    ap.add_argument("--kv-paging", type=int, default=0, metavar="PAGE_SIZE",
                    help="paged KV cache with PAGE_SIZE-line pages "
                         "(0 = dense per-slot cache)")
    ap.add_argument("--kv-pages", type=int, default=None,
                    help="page-pool size override (default: dense-budget "
                         "equivalent, slots*cache_len/page_size + null)")
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
    admission = AdmissionController()
    for name, share in tenants.items():
        admission.add_tenant(name, shares=share)
    engine = DecodeEngine(cfg, params, num_slots=args.slots,
                          cache_len=args.cache_len, metrics=metrics,
                          admission=admission,
                          run=RunConfig(use_kernels=True),
                          seed=args.seed,
                          decode_chunk=args.decode_chunk,
                          prefill_buckets=parse_buckets(args.prefill_buckets),
                          kv_page_size=args.kv_paging,
                          kv_pages=args.kv_pages,
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
    print(f"served {args.requests} requests, {total} tokens in {wall:.1f}s "
          f"({total / wall:,.1f} tok/s, {args.slots} slots, fused "
          f"chunk={args.decode_chunk}, {device})")
    if engine.prefill_buckets:
        print(f"prefill buckets {engine.prefill_buckets}: "
              f"{len(engine.prefill_lengths)} bucket lengths used")
    if engine.paging is not None:
        print(f"paged KV: {engine.paging.page_size}-line pages, pool "
              f"{engine.paging.usable_pages} pages "
              f"(high-water {engine.allocator.high_water}, "
              f"{int(metrics.counter('serve_page_starvations').value())} "
              f"starvation requeues)")
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
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
