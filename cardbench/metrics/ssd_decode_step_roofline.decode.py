"""The SSD decode-step kernel's share of its roofline over the traced
sub-window: per token step, one call a Mamba-2 layer over the lanes that
decoded a token in it (``roofline/ssd_decode_step.py``, counted from the
client's requests), the least time of that work summed, over the device
time of the kernel, in %.  Nothing where the program launches no such
kernel."""
from harness.readers import least_s, roofline_percent
from harness.spec import family, kernel_work
from harness.trace import matching_us


def read(rec):
    c = rec["config"]
    traced = [s for s in rec["steps"] if s["traced"]]
    t = rec.get("trace")
    k = kernel_work("ssd_decode_step")
    if not traced or not t or matching_us(t["ops"], k.PATTERNS) <= 0:
        return None
    fam = family(c)
    _, layers = fam.layer_counts(c)
    shape = fam.ssm_shape(c)
    total = 0.0
    for s in traced:
        for lanes in s["lines"]:
            if lanes:
                total += layers * least_s(*k.work(len(lanes), *shape))[0]
    return roofline_percent(rec, "ssd_decode_step", total)
