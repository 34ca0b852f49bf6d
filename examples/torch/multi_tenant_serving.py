"""Multi-tenant serving tour: one decode engine, two tenants, one ledger.

The port's twin of ``examples/multi_tenant_serving.py`` (itself the
serving twin of ``examples/multi_tenant.py``), on reduced stablelm-3b
through the port's ``DecodeEngine``: the same ``repro_torch.policy``
fair-share machinery that orders the batch queue drives request
admission in the continuous-batching engine:

* tenants are accounts — ``prod`` (8 shares) vs ``research`` (1 share) in
  one :class:`~repro_torch.policy.FairShareTree`;
* every admitted slot is picked by the ``2^(-usage/shares)`` multifactor
  priority, and every generated token / resident KV-cache line charges the
  tenant's account — so sustained load converges to the share ratio;
* research rides the ``scavenger`` QOS: discounted billing, but a blocked
  ``high`` request from prod evicts one of its slots; the victim requeues
  with its partial output retained and resumes where it stopped.

The engine runs the fused decode path (``decode_chunk=4``): each
``engine.step()`` below generates FOUR tokens per slot in one call, with
sampling and stop handling on the device.  Admission, ledger charges
(batched per chunk) and QOS preemption happen at chunk boundaries, so the
blocked ``high`` request below waits at most one chunk before evicting
its victim.

A :class:`~repro_torch.monitoring.Tracer` rides along: every request's
SUBMIT/QUEUED/PREFILL/DECODE/PREEMPT/RESUME/FINISH lifecycle lands as
spans — the preemption below shows up as TWO decode segments on the
victim's lane — and the derived SLO histograms power the per-tenant
TTFT/ITL report printed at the end.  ``tracer.export_chrome(path)``
writes the timeline for ui.perfetto.dev; ``--trace`` on
``repro_torch.launch.serve`` does the same.

Run on the card:  PYTHONPATH=src python examples/torch/multi_tenant_serving.py
Run on the CPU:   PYTHONPATH=src python \\
                      examples/torch/multi_tenant_serving.py --device cpu \\
                      [--load-steps 40]
"""
import argparse

import numpy as np

from repro_torch.cluster import commands
from repro_torch.configs import get_reduced_config
from repro_torch.device import resolve_device
from repro_torch.models import init_params
from repro_torch.models.model import cast_for_compute, compute_dtype
from repro_torch.monitoring import MetricsRegistry, Tracer
from repro_torch.monitoring.metrics import (
    METRIC_SERVE_PREEMPTIONS, METRIC_SERVE_TENANT_TOKENS,
)
from repro_torch.serving import AdmissionController, DecodeEngine, Request


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--load-steps", type=int, default=250,
                    help="engine steps of the sustained-load window")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = get_reduced_config("stablelm-3b")
    # cast once: the four engines below share one set of compute weights
    params = cast_for_compute(init_params(cfg, 0, device),
                              compute_dtype(cfg))
    metrics = MetricsRegistry()
    tracer = Tracer(metrics=metrics)           # opt-in lifecycle tracing

    print("== tenants: prod (8 shares) vs research (1 share) ==")
    admission = AdmissionController(tracer=tracer)
    admission.add_tenant("prod", shares=8)
    admission.add_tenant("research", shares=1)
    engine = DecodeEngine(cfg, params, num_slots=2, cache_len=128,
                          metrics=metrics, admission=admission,
                          decode_chunk=4, prefill_buckets="auto",
                          tracer=tracer, device=device)

    rng = np.random.default_rng(0)

    def req(rid, tenant, qos="normal", max_new=8):
        return Request(rid=rid,
                       prompt=rng.integers(0, cfg.vocab_size, 12).astype(
                           np.int32),
                       max_new_tokens=max_new, tenant=tenant, qos=qos)

    print("== research scavenges both slots while prod is idle ==")
    sweeps = [req(i, "research", qos="scavenger", max_new=48)
              for i in range(2)]
    for r in sweeps:
        engine.submit(r)
    for _ in range(6):
        engine.step()
    print(f"scavenger progress: "
          f"{[len(r.output) for r in sweeps]} tokens decoded\n")

    print("== a blocked high-QOS prod request preempts one slot ==")
    urgent = req(10, "prod", qos="high", max_new=8)
    engine.submit(urgent)
    engine.step()
    victim = next(r for r in sweeps if r.preemptions)
    print(f"evictions: "
          f"{metrics.counter(METRIC_SERVE_PREEMPTIONS).value():.0f}  "
          f"(victim rid={victim.rid} keeps {len(victim.output)} tokens)\n")

    engine.run_to_completion()                 # drain the sweeps
    assert urgent.done and all(r.done for r in sweeps)
    segs = tracer.spans(name="DECODE",
                        track=("serving:research", f"req {victim.rid}"))
    print(f"victim's trace: {len(segs)} decode segments "
          f"(preempt -> resume split on one request lane)\n")

    print("== sustained load converges toward the 8:1 share ratio ==")
    tok = metrics.counter(METRIC_SERVE_TENANT_TOKENS)
    base = {t: tok.value(tenant=t) for t in ("prod", "research")}
    rid = 20
    for _ in range(args.load_steps):
        for tenant in ("prod", "research"):
            while admission.queued(tenant) < 3:
                engine.submit(req(rid, tenant, max_new=4))
                rid += 1
        engine.step()

    prod_t = tok.value(tenant="prod") - base["prod"]
    res_t = tok.value(tenant="research") - base["research"]
    print(f"tokens this window: prod={prod_t:.0f} research={res_t:.0f} "
          f"(ratio {prod_t / max(res_t, 1):.1f}:1 — research entered the "
          f"window over-served from scavenging, so fair-share claws back "
          f"above 8:1 before settling)")
    engine.run_to_completion()                 # drain the tail quietly
    print("\n== the shared ledger (what sshare would report) ==")
    for name in ("prod", "research"):
        print(f"{name:<10} usage={admission.tree.usage[name]:10.1f} "
              f"fairshare={admission.tree.fair_share_factor(name):.4f}")

    print("\n== per-tenant SLO percentiles (sdiag's serving section) ==")
    print(tracer.slo.format_report())

    print("\n== continuous batching: a mixed-length burst ==")
    # Classic admission prefills a whole prompt in one shot, so the
    # 360-token batch prompt below would head-of-line block the three
    # interactive shorts submitted right behind it.  A token budget
    # (``max_batch_tokens``) packs prefill CHUNKS into the leftover of
    # every decode step instead: the shorts promote after one chunk and
    # stream tokens while the long prompt is still mid-prefill — short
    # TTFT stays flat no matter how long the longest resident prompt is.
    budgeted = DecodeEngine(cfg, params, num_slots=4, cache_len=512,
                            metrics=metrics, admission=admission,
                            decode_chunk=4, kv_page_size=16,
                            max_batch_tokens=64, device=device)
    long_req = Request(rid=900, prompt=rng.integers(
        0, cfg.vocab_size, 360).astype(np.int32),
        max_new_tokens=4, tenant="research", qos="scavenger")
    shorts = [Request(rid=901 + i, prompt=rng.integers(
        0, cfg.vocab_size, 8 + 2 * i).astype(np.int32),
        max_new_tokens=12, tenant="prod") for i in range(3)]
    budgeted.submit(long_req)                  # the would-be blocker...
    for r in shorts:
        budgeted.submit(r)                     # ...and the burst behind it
    steps = 0
    while not all(r.output for r in shorts):
        budgeted.step()
        steps += 1
    part = next(p for p in budgeted._partials if p.req is long_req)
    print(f"after {steps} step(s): every short is decoding "
          f"({[len(r.output) for r in shorts]} tokens) while the long "
          f"prompt is {part.pos_filled}/{len(long_req.prompt)} prefilled")
    budgeted.run_to_completion()
    assert long_req.done and all(r.done for r in shorts)

    print("\n== serve-step utilization (sdiag's budgeted section) ==")
    print(commands.sdiag(engine=budgeted))

    print("\n== speculative decoding: draft-and-verify ==")
    # Prompt-lookup speculation: the engine drafts k tokens per lane
    # from the request's own repeats (and a cross-request index fed at
    # finish), then verifies them all in ONE target call — greedy
    # output is bit-identical, wrong drafts only cost speed.  The
    # repetitive prompt below is the friendly regime: most rounds
    # accept several drafts, so tokens-per-call climbs above 1.
    spec = DecodeEngine(cfg, params, num_slots=2, cache_len=128,
                        metrics=metrics, admission=admission,
                        decode_chunk=4, kv_page_size=16, speculate=4,
                        device=device)
    phrase = rng.integers(0, cfg.vocab_size, 6).astype(np.int32)
    looped = Request(rid=950, prompt=np.concatenate([phrase] * 4),
                     max_new_tokens=24, tenant="prod")
    spec.submit(looped)
    spec.run_to_completion()
    plain = DecodeEngine(cfg, params, num_slots=2, cache_len=128,
                         decode_chunk=4, kv_page_size=16, device=device)
    check = Request(rid=951, prompt=looped.prompt.copy(),
                    max_new_tokens=24, tenant="prod")
    plain.submit(check)
    plain.run_to_completion()
    assert looped.output == check.output, "speculation changed output"
    st = spec.spec_stats
    print(f"{len(looped.output)} tokens, {st['emitted']} of them from "
          f"{st['rounds']} verify rounds "
          f"({st['emitted'] / max(st['rounds'], 1):.1f} tokens/round), "
          f"accepted {st['accepted']}/{st['proposed']} drafts — output "
          f"bit-identical to plain decoding")
    print(commands.sdiag(engine=spec))


if __name__ == "__main__":
    main()
