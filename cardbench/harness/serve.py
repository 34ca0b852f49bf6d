"""The serving driver: one general client for every serving mix.

Set-up draws the weights on the device from the seed, builds the engine
as ``repro_torch.launch.serve`` builds it, runs one request through every
prefill bucket the mix can reach (and, for shared prefixes, the prefixes
themselves, which fill the prefix cache), then the warm-start requests.
The window then drives ``DecodeEngine.submit``/``step`` from the client's
side: a closed loop sends a client's next request as soon as its last one
is seen finished; an open loop sends each request at the first step
boundary after it is due.  Times are the client's: a token is seen when
the ``step()`` that produced it returns.

After the window the engine and its weights are freed and a sample of
the finished requests (the longest among them) is held to the reference:
the widest gap by which a served token's reference logit lies below the
reference's best at that position.
"""
from __future__ import annotations

import gc
import time

import numpy as np
import torch

from harness import mix as mixmod
from harness import weights
from harness.clock import now
from harness.port import check_layout, import_port, model_config
from harness.spec import family, reference
from harness.trace import Profiled


class Client:
    """What the client knows of one request."""
    __slots__ = ("req", "due", "first", "end", "seen", "prompt", "warm")

    def __init__(self, req, due: float, prompt: int, warm: bool = False):
        self.req, self.due, self.prompt, self.warm = req, due, prompt, warm
        self.first = self.end = None
        self.seen = 0

    def record(self) -> dict:
        return {"due": self.due, "first": self.first,
                "end": self.end, "n_out": self.seen, "prompt": self.prompt,
                "warm": self.warm, "rid": self.req.rid}


def _buckets_reached(lo: int, hi: int, cache_len: int) -> list:
    """One prompt length per power-of-two prefill bucket that a prompt of
    ``lo..hi`` tokens can land in (the engine's ``auto`` buckets)."""
    out, b = [], 32
    while True:
        top = min(b, cache_len)
        if top >= lo and (not out or out[-1] < hi):
            out.append(min(top, hi))
        if b >= hi or b >= cache_len:
            return out
        b *= 2


def plant_token_fault(engine_module, vocab: int):
    """A fault for the tests and the control runs: every decode call's last
    token of each lane is replaced by the next id where it is produced."""
    real = engine_module.decode_n

    def altered(*a, **k):
        toks, *rest = real(*a, **k)
        toks = toks.clone()
        toks[:, -1] = (toks[:, -1] + 1) % vocab
        return (toks, *rest)

    engine_module.decode_n = altered
    return lambda: setattr(engine_module, "decode_n", real)


def run(cell, seed: int, seconds: float, trace: bool, device,
        fault: str | None = None) -> dict:
    import_port()
    import repro_torch.serving.engine as engine_module
    from repro_torch.configs.base import RunConfig
    from repro_torch.kernels import ops
    from repro_torch.monitoring import MetricsRegistry, Tracer
    from repro_torch.monitoring.metrics import \
        METRIC_SERVE_PREFIX_REUSED_TOKENS
    from repro_torch.serving import DecodeEngine, Request

    device = torch.device(device)
    conf, mix = cell.config, cell.traffic
    eng = mix["engine"]
    vocab = family(conf).vocab(conf)
    cfg = model_config(conf, "bfloat16", "bfloat16")
    flat = weights.make(conf, seed, device, torch.bfloat16)
    check_layout(cfg, flat)
    metrics = MetricsRegistry()
    tracer = Tracer(clock=now, max_spans=1 << 20, metrics=metrics) \
        if trace else None
    undo = plant_token_fault(engine_module, vocab) if fault == "token" \
        else None
    engine = DecodeEngine(
        cfg, weights.tree(flat), num_slots=eng["slots"],
        cache_len=eng["cache_len"], run=RunConfig(use_kernels=True),
        metrics=metrics, seed=int(seed) & (2**63 - 1),
        decode_chunk=eng["decode_chunk"], fused=True,
        prefill_buckets="auto", kv_page_size=eng["page_size"],
        prefix_cache=bool(eng["prefix_cache"]), tracer=tracer, device=device)
    sync = (lambda: torch.cuda.synchronize(device)) \
        if device.type == "cuda" else (lambda: None)

    def request(r: mixmod.ServeRequest):
        return Request(rid=r.index, prompt=r.prompt, max_new_tokens=r.max_new,
                       temperature=0.0)

    # ---- set-up: every prefill shape the mix reaches, then the warm start
    stream = mixmod.ServeStream(mix, vocab, seed)
    rng = mixmod.rng_for(seed, 9)
    warm_shapes = []
    pre = stream.prefixes
    user = mix["prompt"]
    for n in _buckets_reached(user["min"], user["max"], eng["cache_len"]):
        ids = rng.integers(mixmod.FIRST_ID, vocab, n).astype(np.int32)
        warm_shapes.append(np.concatenate([pre[0], ids]) if pre else ids)
    setup = [Request(rid=-10_000 - i, prompt=p, max_new_tokens=2)
             for i, p in enumerate(pre)]
    setup += [Request(rid=-20_000 - i, prompt=p,
                      max_new_tokens=eng["decode_chunk"] + 1)
              for i, p in enumerate(warm_shapes)]
    for r in setup:
        engine.submit(r)
    engine.run_to_completion()
    clients: list = []
    inflight: list = []
    for r in stream.warm():
        c = Client(request(r), 0.0, len(r.prompt), warm=True)
        engine.submit(c.req)
        clients.append(c)
        inflight.append(c)
    if inflight:
        engine.step()                 # every slot prefilled, one chunk
        for c in inflight:
            c.seen = len(c.req.output)
        inflight[:] = [c for c in inflight if not c.req.done]
    sync()
    reused0 = metrics.counter(METRIC_SERVE_PREFIX_REUSED_TOKENS).value()

    # ---- the window
    closed = mix["loop"] == "closed"
    chunk = eng["decode_chunk"]
    steps: list = []
    waiting = None                    # next open-loop request, not yet due
    reused = 0
    traced = None
    closing = False                   # the window closed; the traced step
    t0 = now()
    t_end = t0 + seconds

    def send(r, due):
        c = Client(request(r), due, len(r.prompt))
        engine.submit(c.req)
        clients.append(c)
        inflight.append(c)

    if closed:
        for _ in range(int(mix["clients"]) - len(inflight)):
            send(stream.next(), t0)
    while True:
        if not closed:
            while True:
                if waiting is None:
                    waiting = stream.next()
                if t0 + waiting.due > now():
                    break
                send(waiting, t0 + waiting.due)
                waiting = None
            if not inflight:
                if t0 + waiting.due >= t_end or closing:
                    break
                # nothing to serve: wait for the next arrival
                time.sleep(max(0.0, t0 + waiting.due - now()))
                continue
        before = [c.seen for c in inflight]
        # the profiled step follows the window, so that the profiler's own
        # start and stop delay no request the window measures
        prof = Profiled(device) if closing else None
        if prof is not None:
            launches0 = ops.launch_counts()
            prof.__enter__()
        ts = now()
        engine.step()
        te = now()
        if prof is not None:
            prof.__exit__(None, None, None)
            te = now()
            traced = {"ops": prof.ops, "wall_s": prof.wall_s,
                      "launches": {k: v - launches0[k] for k, v in
                                   ops.launch_counts().items()}}
        step = {"t0": ts, "t1": te, "tokens": 0, "decode_tokens": 0,
                "decode_ctx": 0, "token_steps": 0, "traced": prof is not None,
                "lines": [[] for _ in range(chunk)] if prof is not None
                else None}
        still = []
        for c, n0 in zip(inflight, before):
            n = len(c.req.output)
            if n > n0:
                if n0 == 0:
                    c.first = te
                # outputs n0..n-1; index 0 came from the prefill, index m
                # >= 1 from a decode step that attended prompt + m lines
                lo = max(n0, 1)
                for j, m in enumerate(range(lo, n)):
                    step["decode_ctx"] += c.prompt + m
                    if step["lines"] is not None and j < chunk:
                        step["lines"][j].append(c.prompt + m)
                step["decode_tokens"] += n - lo
                step["tokens"] += n - n0
                c.seen = n
            if c.req.done:
                c.end = te
            else:
                still.append(c)
        if step["decode_tokens"]:
            step["token_steps"] = chunk
        steps.append(step)
        finished = len(inflight) - len(still)
        inflight[:] = still
        if closing:
            break
        if te >= t_end:
            reused = metrics.counter(
                METRIC_SERVE_PREFIX_REUSED_TOKENS).value() - reused0
            if not trace:
                break
            closing = True
        if closed:
            for _ in range(finished):
                send(stream.next(), te)
    window = [st for st in steps if not st["traced"]]
    t_close = window[-1]["t1"] if window else now()
    if not closed:
        # requests that fell due before the close but were never sent
        while waiting is not None and t0 + waiting.due < t_end:
            c = Client(request(waiting), t0 + waiting.due, len(waiting.prompt))
            clients.append(c)
            waiting = stream.next()
    sync()
    peak = torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else 0

    # program spans (traced runs): prefill time inside each step, admits
    prefills, admits = [], {}
    if tracer is not None:
        spans = tracer.spans() + tracer.open_spans()
        for s in spans:
            if s.name == "PREFILL" and s.end is not None:
                prefills.append((s.start, s.end, s.attrs.get("tokens", 0),
                                 s.attrs.get("prefix_pages", 0)))
            if s.cat == "request":
                for e in s.events:
                    if e.name == "ADMIT":
                        admits.setdefault(s.attrs.get("rid"), e.ts)
        for st in steps:
            st["prefill_s"] = sum(e - s for s, e, *_ in prefills
                                  if st["t0"] <= s and e <= st["t1"])
    rec = {
        "kind": "serve", "config": conf, "traffic": mix,
        "window": {"t0": t0, "t1": t_close, "close": t_end},
        "requests": [c.record() | {"admit": admits.get(c.req.rid)}
                     for c in clients],
        "steps": steps, "prefills": prefills,
        "page_size": eng["page_size"],
        "counters": {"prefix_reused_tokens": reused},
        "trace": traced, "memory_peak_bytes": peak,
    }
    finished = [c for c in clients if c.end is not None]
    outputs = {c.req.rid: (np.asarray(c.req.prompt, np.int64),
                           np.asarray(c.req.output, np.int64))
               for c in finished}
    if undo is not None:
        undo()
    del engine, flat, tracer
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    rec["finished"] = outputs
    return rec


def sample(rec: dict, count: int, seed: int) -> list:
    """The finished requests the check reads: the one with the most served
    tokens, and ``count - 1`` more drawn from the seed."""
    fin = rec["finished"]
    if not fin:
        return []
    rids = sorted(fin)
    longest = max(rids, key=lambda r: (len(fin[r][1]), r))
    rest = [r for r in rids if r != longest]
    pick = mixmod.rng_for(seed, 7).permutation(len(rest))[:count - 1]
    return [longest] + [rest[i] for i in sorted(pick)]


def reference_gaps(rec: dict, rids: list, seed: int, device,
                   use=None) -> dict:
    """Per sampled request, each served token's gap below the reference's
    best logit (``use``: the product weights of a control instead).  The
    weights are drawn again from the seed and read in float32."""
    from reference import common

    common.no_tf32()
    conf = rec["config"]
    ref_model = reference(conf)
    W = {k: v.float() for k, v in weights.make(
        conf, seed, device, torch.bfloat16).items()}
    gaps = {}
    with torch.no_grad():
        for rid in rids:
            prompt, out = rec["finished"][rid]
            seq = torch.from_numpy(np.concatenate([prompt, out[:-1]])).to(
                device)
            served = torch.from_numpy(out).to(device)
            ref = ref_model.logits(W, conf, seq, len(prompt) - 1)
            if use is None:
                tok = served
            else:
                tok = ref_model.logits(W, conf, seq, len(prompt) - 1,
                                       use=use).argmax(-1)
            best = ref.max(-1).values
            gaps[rid] = (best - ref.gather(-1, tok[:, None])[:, 0]).cpu()
    del W
    return gaps


def check(rec: dict, seed: int, device, limits: dict, use=None) -> dict:
    """The numbers compared for a served cell: ``gap_max``, the widest
    gap over every served token of the sample (logits, not sampled
    tokens: with random weights the best logit flips on rounding)."""
    rids = sample(rec, int(limits["sample"]), seed)
    if not rids:
        return {"gap_max": float("inf"), "tokens_checked": 0}
    gaps = reference_gaps(rec, rids, seed, device, use)
    every = torch.cat([gaps[r] for r in rids])
    return {"gap_max": float(every.max()), "tokens_checked": int(every.numel())}


def attempted(rec: dict) -> tuple:
    """Requests attempted in the window and those that failed (a request
    the engine dropped: sent, and neither finished nor still in flight,
    cannot happen without an error, which ends the run)."""
    w = rec["window"]
    tried = [r for r in rec["requests"]
             if r["warm"] or w["t0"] <= r["due"] < w["close"]]
    return len(tried), 0
