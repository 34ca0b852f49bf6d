"""Model FLOPs of every token the window processed outside the profiled
sub-window (the prompts' prefills, counted from the engine's PREFILL
spans, and the decoded tokens), over those steps' wall time x the bf16
peak, in %.

Per token, from the configuration's published widths by its family file
(``families/<family>.py``): 2 x the weights of its products, plus its
attention over its context; the output head once for each decoded token
and once a prefill.  Pad rows of bucketed prefills and cached prefix tokens are not
work the inputs need."""
from harness.readers import untraced
from harness.spec import family, peaks


def read(rec):
    c = rec["config"]
    fam = family(c)
    body, out, pair = fam.body_flops(c), fam.head_flops(c), fam.pair_flops(c)
    steps = [s for s in untraced(rec) if "prefill_s" in s]
    if not steps:
        return None
    ps = rec["page_size"]
    flops = 0.0
    for s in steps:
        flops += s["decode_tokens"] * (body + out) + pair * s["decode_ctx"]
        for t0, t1, tokens, prefix_pages in rec["prefills"]:
            if s["t0"] <= t0 and t1 <= s["t1"]:
                start = prefix_pages * ps
                n = tokens - start
                flops += n * body + out + fam.mixer_flops(c, n, start)
    wall = sum(s["t1"] - s["t0"] for s in steps)
    return 100.0 * flops / (wall * peaks()["bf16_flops_per_s"])
