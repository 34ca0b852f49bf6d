"""The attention kernel's share of its roofline in the traced training
step: the least time of one forward call at the step's shapes
(``roofline/flash_attention.py``) times the port's launch counter, over
the kernel's device time, in %.  Over ranks, rank 0's trace and
launches, whose calls each take its own rows of a microbatch."""
from harness.readers import least_s, roofline_percent
from harness.spec import family, kernel_work


def read(rec):
    t, c, mix = rec.get("trace"), rec["config"], rec["traffic"]
    calls = t["launches"].get("flash_attention", 0) if t else 0
    if not calls:
        return None
    rows = mix["batch"] // rec.get("ranks", 1) // mix["microbatches"]
    one = least_s(*kernel_work("flash_attention").work(
        rows, mix["seq_len"], *family(c).attention_heads(c)))[0]
    return roofline_percent(rec, "flash_attention", calls * one)
