"""Host-clock time of the window's engine steps outside the profiled
sub-window, less the engine's PREFILL spans inside them, per token step
run (a fused chunk runs ``decode_chunk`` token steps)."""
from harness.readers import untraced


def read(rec):
    steps = [s for s in untraced(rec) if "prefill_s" in s]
    n = sum(s["token_steps"] for s in steps)
    if not n:
        return None
    return 1e3 * sum(s["t1"] - s["t0"] - s["prefill_s"] for s in steps) / n
