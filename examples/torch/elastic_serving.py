"""Elastic serving tour: batch and serving contend for one cluster.

The port's twin of ``examples/elastic_serving.py``, on reduced
stablelm-3b replicas of the port's ``DecodeEngine``.  The elastic tier
in one sitting — serving replicas are *scavenger jobs* inside the SLURM
simulation, so batch training and interactive decode negotiate nodes
through the cluster's own policy machinery:

* **scale up** — the :class:`~repro_torch.serving.Autoscaler` probes
  ``Cluster.capacity_now`` ("largest replica-shaped job that starts
  immediately", slurm_now-style) and grows the
  :class:`~repro_torch.serving.Router`'s fleet into idle nodes, one
  ``kind="serve_replica"`` scavenger placeholder job per replica;
* **prefix affinity** — the router consistent-hashes each request's
  first prompt page (SHA-1 ring, 64 vnodes/replica), so everyone
  sharing a system prompt lands on the replica whose radix prefix
  cache already holds those pages;
* **contention** — a high-QOS training job preempts one placeholder
  through the cluster's QOS machinery; the next autoscaler tick drains
  that replica: in-flight requests are evicted with partial output
  retained, re-routed through the surviving ring, and finish with
  greedy outputs bit-identical to an undisturbed run (one engine of the
  same options serving the same requests; checked);
* **scale back up** — training ends, the probe sees idle nodes again,
  and the fleet regrows.

Every replica shares one set of compute weights, cast once before the
router is built, and runs on the one device in this process.

``sdiag`` prints the router and autoscaler sections after each act.
The same flow is available from the CLI:

    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --replicas 2 --affinity --autoscale --prefix-cache

Run on the card:  PYTHONPATH=src python examples/torch/elastic_serving.py
Run on the CPU:   PYTHONPATH=src python examples/torch/elastic_serving.py \\
                      --device cpu
"""
import argparse

import numpy as np

from repro_torch.cluster import (
    ResourceRequest, commands, provision, tpu_pod_spec,
)
from repro_torch.configs import get_reduced_config
from repro_torch.device import resolve_device
from repro_torch.models import init_params
from repro_torch.models.model import cast_for_compute, compute_dtype
from repro_torch.monitoring import MetricsRegistry
from repro_torch.serving import Autoscaler, DecodeEngine, Request, Router


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = get_reduced_config("stablelm-3b")
    params = cast_for_compute(init_params(cfg, 0, device),
                              compute_dtype(cfg))
    metrics = MetricsRegistry()

    # -- the cluster: 4 hosts, serving will scavenge whatever is idle --
    cluster = provision(tpu_pod_spec(hosts_x=4, hosts_y=1))

    def make_engine(admission, metrics=metrics):
        return DecodeEngine(cfg, params, num_slots=2, cache_len=128,
                            metrics=metrics, admission=admission,
                            decode_chunk=4, kv_page_size=16,
                            prefix_cache=True, device=device)

    router = Router(make_engine, replicas=0, policy="affinity",
                    metrics=metrics)
    router.add_tenant("chat", shares=4)
    scaler = Autoscaler(
        router, cluster,
        req=ResourceRequest(nodes=1, gres_per_node={"tpu": 4},
                            time_limit_s=36_000),
        min_replicas=1, max_replicas=3)

    print("== act 1: the autoscaler scavenges the idle pod ==")
    scaler.tick()
    print(f"replicas: {sorted(router.replicas)}  "
          f"(probe saw {scaler.stats['last_probe']} idle node(s))")
    print(commands.squeue(cluster), "\n")

    # -- two user populations, each behind a shared system prompt --
    rng = np.random.default_rng(0)
    sys_a = rng.integers(0, cfg.vocab_size, 48).astype(np.int32)
    sys_b = rng.integers(0, cfg.vocab_size, 48).astype(np.int32)

    def chat(rid, system):
        tail = rng.integers(0, cfg.vocab_size, 6).astype(np.int32)
        return Request(rid=rid, prompt=np.concatenate([system, tail]),
                       max_new_tokens=8, tenant="chat")

    print("== act 2: shared-prefix traffic routes by affinity ==")
    reqs = [chat(i, sys_a if i % 2 == 0 else sys_b) for i in range(8)]
    placed = [router.submit(r) for r in reqs]
    print(f"placement (A=even, B=odd rids): {placed}")
    router.step()                              # some partial output
    print(f"affinity hits: {router.stats['affinity_hits']}/"
          f"{router.stats['routed']}\n")

    print("== act 3: high-QOS training takes nodes back ==")
    cluster.submit("train-ft", ResourceRequest(
        nodes=3, gres_per_node={"tpu": 4}, time_limit_s=7200),
        user="alice", qos="high", run_time_s=600)
    scaler.tick()                              # reaps the lost placeholder
    print(f"preemptions: {cluster.preemptions_total}; "
          f"replicas now: {sorted(router.replicas)}; "
          f"{scaler.stats['requeued_requests']} in-flight request(s) "
          f"re-routed with partial output retained")
    router.run_to_completion()
    done = sum(r.done for r in reqs)
    moved = [r.rid for r in reqs if r.preemptions]
    # the undisturbed run: one engine of the same options, the same
    # requests, nothing drained
    ref = [Request(rid=r.rid, prompt=r.prompt.copy(),
                   max_new_tokens=r.max_new_tokens, tenant="chat")
           for r in reqs]
    single = make_engine(None, metrics=MetricsRegistry())
    for r in ref:
        single.submit(r)
    single.run_to_completion()
    same = all(r.output == q.output for r, q in zip(reqs, ref))
    print(f"finished {done}/{len(reqs)}; drained mid-decode: {moved} "
          f"(outputs bit-identical to an undisturbed run: {same})\n")
    assert done == len(reqs) and moved and same, \
        "the drained requests must finish as an undisturbed run does"

    print(commands.sdiag(cluster=cluster, router=router,
                         autoscaler=scaler), "\n")

    print("== act 4: training ends, the fleet regrows ==")
    cluster.run()                              # drive batch to completion
    scaler.tick()
    print(f"replicas: {sorted(router.replicas)}  "
          f"(scale-ups total: {scaler.stats['scale_ups']})")


if __name__ == "__main__":
    main()
