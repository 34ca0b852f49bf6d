"""Model FLOPs of the window's training steps outside the profiled
sub-window, over those steps' wall time x the bf16 peak x the cards the
ranks use (one where the record names no ranks), in %.  Forward and
backward: 3 x the forward's FLOPs over the global batch; recomputation
is not counted.

The forward's FLOPs come from the configuration's published widths by
its family file (``families/<family>.py``, ``forward_flops``): 2 x the
weights of its products a token (for sparse experts, at the active
widths: the routed experts a token takes and the shared one), its
sequence mixer's work over the causal rows, and the output head."""
from harness.readers import untraced
from harness.spec import family, peaks


def read(rec):
    steps = untraced(rec)
    mix, c = rec["traffic"], rec["config"]
    per_step = family(c).forward_flops(c, mix["batch"], mix["seq_len"])
    wall = sum(s["t1"] - s["t0"] for s in steps)
    return 100.0 * 3 * per_step * len(steps) / \
        (wall * rec.get("ranks", 1) * peaks()["bf16_flops_per_s"])
