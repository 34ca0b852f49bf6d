"""The causal prefill/training attention kernel
(``kernels/csrc/flash_attention.cu``): the work one forward call needs.

q (B, S, H, Dh), k and v (B, S, K, Dh) read once, o (B, S, H, Dh)
written once, bfloat16; over the causal pairs (S (S + 1) / 2 a head and
row) 2 Dh flops for q.k and 2 Dh for p.v."""

PATTERNS = ("flash_attention",)
BYTES = 2


def work(B: int, S: int, H: int, K: int, Dh: int) -> tuple:
    pairs = S * (S + 1) // 2
    flops = 4 * Dh * pairs * H * B
    nbytes = BYTES * B * S * Dh * (2 * H + 2 * K)
    return flops, nbytes
