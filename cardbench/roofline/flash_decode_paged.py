"""The paged decode attention kernel (``kernels/csrc/flash_decode.cu``,
``split_decode_kernel<.., true>``): the work one call needs, counted from
the requests' live lines, never from the kernel's launch parameters.

Per lane with ``c`` live lines: read its roped query (H x Dh) once, each
live K and V line (K heads x Dh each) once, write its output (H x Dh);
multiply-adds ``2 H Dh c`` for q.k and as many for p.v.  All bfloat16."""

PATTERNS = ("split_decode_kernel",)
BYTES = 2


def work(lines, H: int, K: int, Dh: int) -> tuple:
    """``(flops, bytes)`` of one call over lanes with ``lines`` live lines
    each."""
    total = sum(lines)
    flops = 4 * H * Dh * total
    nbytes = BYTES * (2 * K * Dh * total + 2 * H * Dh * len(lines))
    return flops, nbytes
