"""Tensor-parallel serving: shard the model and the paged KV pool over a
2-way ``model`` axis of ranks, then decode the same workload at TP=1 and
TP=2 and check the greedy outputs match token for token (the engine
reduces in float32, so an f32 model decodes the same at any TP degree).

The port's twin of ``examples/tp_serving.py``: reduced stablelm-3b in
f32 through the port's ``DecodeEngine``.  TP=1 runs in this process;
TP=``--tp`` runs on that many ranks (``serving.tp.launch``: one process a
rank, each holding its shard of the heads and of ``d_ff``, one
all-reduce at attention-out and one at MLP-down a layer).  The ranks
share the one device over gloo: NCCL takes one rank per card.

Run on the card:  PYTHONPATH=src python examples/torch/tp_serving.py \\
                      [--tp 2]
Run on the CPU:   PYTHONPATH=src python examples/torch/tp_serving.py \\
                      --device cpu [--requests 4 --max-new 8]
(A file, not ``python -``: each rank is a ``spawn``ed process that
imports this script.)
"""
import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs import get_reduced_config
from repro_torch.device import resolve_device
from repro_torch.models import init_params
from repro_torch.serving import DecodeEngine, Request
from repro_torch.serving.tp import launch


def serve(cfg, args, device, mesh=None):
    """The workload through one engine (this rank's shard under
    ``mesh``): (engine, requests, seconds)."""
    params = init_params(cfg, 0, device)
    engine = DecodeEngine(cfg, params, num_slots=4, cache_len=128,
                          decode_chunk=4, kv_page_size=16, mesh=mesh,
                          device=device)
    rng = np.random.default_rng(0)
    reqs = [Request(rid=i,
                    prompt=rng.integers(0, cfg.vocab_size,
                                        int(rng.integers(8, 32))).astype(
                                            np.int32),
                    max_new_tokens=args.max_new)
            for i in range(args.requests)]
    for r in reqs:
        engine.submit(r)
    t0 = time.perf_counter()
    while engine.step() > 0 or engine.queue:
        pass
    return engine, reqs, time.perf_counter() - t0


def serve_rank(mesh, cfg, args):
    """One rank of the TP run: its outputs, shard stats and seconds."""
    engine, reqs, dt = serve(cfg, args, mesh.device, mesh)
    return {"outputs": [list(r.output) for r in reqs],
            "stats": engine.tp_stats(), "seconds": dt}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--tp", type=int, default=2)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())

    # f32 so TP=1 and TP=N decode the same tokens (bf16 keeps ~1-ulp
    # logit noise from the reassociated all-reduce)
    cfg = dataclasses.replace(get_reduced_config("stablelm-3b"),
                              dtype="float32")

    _, base, base_dt = serve(cfg, args, device)
    ranks = launch(serve_rank, args.tp, devices=[device] * args.tp,
                   backend="gloo", args=(cfg, args),
                   threads=1 if device.type == "cpu" else None)
    st = ranks[0]["stats"]
    ps = st["psums_per_token"]
    print(f"plan: {st['plan']}")
    print(f"devices: {', '.join(st['devices'])}")
    print(f"psums/token: {sum(ps.values())} "
          f"(attn_out {ps['attn_out']}, mlp_out {ps['mlp_out']})")
    for k, n in enumerate(st.get("kv_pages_in_use", [])):
        print(f"KV pool shard {k}: {n}/{st['kv_pages_total']} pages "
              f"in use (each holds 1/{st['tp']} of every page's heads)")
    for note in st["notices"]:
        print(f"notice: {note}")

    toks = sum(len(r.output) for r in base)
    tp_dt = ranks[0]["seconds"]
    print(f"{args.requests} requests, {toks} tokens: "
          f"tp=1 {base_dt:.1f}s, tp={args.tp} {tp_dt:.1f}s")
    same = all(b.output == out for rank in ranks
               for b, out in zip(base, rank["outputs"]))
    print(f"greedy outputs identical across TP degrees: {same}")
    assert same, "f32 TP decode must match TP=1 token-for-token"


if __name__ == "__main__":
    main()
