"""The SSD decode-step kernel (``kernels/csrc/ssd_decode.cu``,
``ssd_decode_step_kernel``): the work one call needs, counted from the
lanes that decode a token in it, never from the kernel's launch
parameters.

Per lane: read its float32 (H, P, N) state once and write it once; read
its x (H x P), B and C (N each), all bfloat16, and its float32 dt (H);
write its y (H x P, bfloat16); flops 6 H P N (the state's decay and
input, its product with C).  A and D (H each, float32) are read once a
call."""

PATTERNS = ("ssd_decode_step_kernel",)
STATE_BYTES = 4
BYTES = 2


def work(lanes: int, H: int, P: int, N: int) -> tuple:
    """``(flops, bytes)`` of one call over ``lanes`` decoding lanes."""
    flops = 6 * H * P * N * lanes
    per_lane = (2 * STATE_BYTES * H * P * N + BYTES * (2 * H * P + 2 * N)
                + STATE_BYTES * H)
    return flops, lanes * per_lane + 2 * STATE_BYTES * H
