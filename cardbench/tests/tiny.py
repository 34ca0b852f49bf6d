"""Tiny cells for the CPU tests: a cell of ``BENCHMARK.json`` with its
configuration's widths and its mix's sizes cut down, its limits kept."""
from __future__ import annotations

import dataclasses

from harness.spec import resolve

#: the widths of a tiny model, by the configuration's family
WIDTHS = {"dense": {"hidden_size": 64, "intermediate_size": 96,
                    "num_attention_heads": 4, "num_key_value_heads": 4,
                    "head_dim": 16, "num_hidden_layers": 2,
                    "vocab_size": 256}}
SERVE = {"clients": 4, "block": 8,
         "engine": {"slots": 4, "cache_len": 128, "page_size": 16,
                    "prefix_cache": True, "decode_chunk": 4}}
TRAIN = {"batch": 4, "seq_len": 64, "block": 8}
#: an open-loop mix with shared prefixes (no cell of BENCHMARK.json runs
#: one yet): Poisson arrivals, 8 system prompts of Zipf popularity, each
#: request its own turn after one
OPEN_LOOP = {"kind": "serve", "loop": "open", "rate": 8.0, "block": 64,
             "schedule_seed": 0,
             "prefixes": {"count": 8, "length": 1536, "zipf_s": 1.1},
             "prompt": {"dist": "loguniform", "min": 32, "max": 256},
             "output": {"dist": "uniform", "min": 16, "max": 64},
             "sampling": "greedy, no stop token",
             "engine": {"slots": 64, "cache_len": 2048, "page_size": 16,
                        "prefix_cache": True, "decode_chunk": 8}}


def tiny(workload: str, **traffic):
    """The cell cut down; ``workload`` ``open_loop`` is the decode cell's
    model and limits under :data:`OPEN_LOOP`."""
    full = resolve("stablelm-3b.decode" if workload == "open_loop"
                   else workload)
    if workload == "open_loop":
        full = dataclasses.replace(full, name=workload, traffic=OPEN_LOOP)
    conf = dict(full.config)
    conf.update(WIDTHS[conf["family"]])
    mix = dict(full.traffic)
    if mix["kind"] == "serve":
        mix.update(SERVE)
        mix["prompt"] = {"dist": "loguniform", "min": 8, "max": 40}
        mix["output"] = {"dist": "uniform", "min": 16, "max": 48}
        if "prefixes" in mix:
            mix["prefixes"] = dict(mix["prefixes"], length=32)
            mix["rate"] = 40.0
    else:
        mix.update(TRAIN)
        mix["docs"] = {"dist": "lomax", "mean": 24}
    mix.update(traffic)
    return dataclasses.replace(full, config=conf, traffic=mix)
