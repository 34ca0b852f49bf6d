"""Batched serving with continuous batching: submit a stream of requests,
decode them through shared KV-cache slots, report throughput + latency
quantiles (the serving-engine role that TensorRT plays in the guide's GPU
world).

The port's twin of ``examples/serve_batch.py``: reduced stablelm-3b
through the port's ``DecodeEngine`` (prefill and decode attention
through the hand-written kernels on the card, their plain versions on
the CPU).

Run on the card:  PYTHONPATH=src python examples/torch/serve_batch.py \\
                      [--requests 16]
Run on the CPU:   PYTHONPATH=src python examples/torch/serve_batch.py \\
                      --device cpu [--requests 4 --max-new 8]
"""
import argparse
import time

import numpy as np

from repro_torch.configs import get_reduced_config
from repro_torch.device import resolve_device
from repro_torch.models import init_params
from repro_torch.monitoring import MetricsRegistry
from repro_torch.serving import DecodeEngine, Request


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=24)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = get_reduced_config("stablelm-3b")
    params = init_params(cfg, 0, device)
    metrics = MetricsRegistry()
    engine = DecodeEngine(cfg, params, num_slots=args.slots,
                          cache_len=256, metrics=metrics, device=device)

    rng = np.random.default_rng(0)
    reqs = []
    for i in range(args.requests):
        plen = int(rng.integers(8, 48))
        reqs.append(Request(
            rid=i, prompt=rng.integers(0, cfg.vocab_size, plen).astype(
                np.int32),
            max_new_tokens=args.max_new,
            temperature=0.0 if i % 2 == 0 else 0.8))
        engine.submit(reqs[-1])

    t0 = time.perf_counter()
    n_steps = 0
    while engine.step() > 0 or engine.queue:
        n_steps += 1
    dt = time.perf_counter() - t0

    toks = int(metrics.counter("serve_tokens_generated").value())
    print(f"{args.requests} requests through {args.slots} slots: "
          f"{toks} tokens in {dt:.1f}s -> {toks / dt:,.1f} tok/s "
          f"({n_steps} batched steps)")
    print(f"decode p50 "
          f"{metrics.histogram('serve_decode_seconds').quantile(0.5)*1e3:.0f}"
          f"ms  p90 "
          f"{metrics.histogram('serve_decode_seconds').quantile(0.9)*1e3:.0f}"
          f"ms")
    for r in reqs[:3]:
        print(f"req {r.rid}: prompt[{len(r.prompt)}] -> {r.output[:8]}...")
    assert all(r.done for r in reqs)


if __name__ == "__main__":
    main()
