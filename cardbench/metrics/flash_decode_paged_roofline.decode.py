"""The paged decode kernel's share of its roofline over the traced
sub-window: per call (a layer of a token step) the least time of the work
its live lanes need (``roofline/flash_decode_paged.py``, counted from the
client's requests: a lane decoding output m of a prompt of P tokens has
P + m live lines), summed, over the device time of the kernel, in %."""
from harness.readers import least_s, roofline_percent
from harness.spec import family, kernel_work


def read(rec):
    c = rec["config"]
    traced = [s for s in rec["steps"] if s["traced"]]
    if not traced:
        return None
    k = kernel_work("flash_decode_paged")
    heads = family(c).attention_heads(c)
    total = 0.0
    for s in traced:
        for lanes in s["lines"]:
            if lanes:
                total += c["num_hidden_layers"] * least_s(
                    *k.work(lanes, *heads))[0]
    return roofline_percent(rec, "flash_decode_paged", total)
