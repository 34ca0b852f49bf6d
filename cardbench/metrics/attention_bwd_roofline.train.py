"""The attention backward's share of its roofline in the traced training
step: the least time of one backward call at the step's shapes
(``roofline/attention_bwd.py``) times the port's ``attention_bwd``
counter (wrapper calls, one a layer's backward, three launches each),
over the device time of the ``attn_bwd_`` kernels, in %.  Over ranks,
rank 0's trace and calls, each on its own rows of a microbatch.  None
where the program has no such counter or made no call."""
from harness.readers import least_s, roofline_percent
from harness.spec import family, kernel_work


def read(rec):
    t, c, mix = rec.get("trace"), rec["config"], rec["traffic"]
    calls = t["launches"].get("attention_bwd", 0) if t else 0
    if not calls:
        return None
    rows = mix["batch"] // rec.get("ranks", 1) // mix["microbatches"]
    one = least_s(*kernel_work("attention_bwd").work(
        rows, mix["seq_len"], *family(c).attention_heads(c)))[0]
    return roofline_percent(rec, "attention_bwd", calls * one)
