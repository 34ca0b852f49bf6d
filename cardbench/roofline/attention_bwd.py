"""The backward of causal attention (``kernels/csrc/attention_bwd.cu``):
the least work of one backward call.

Five products over the causal pairs (S (S + 1) / 2 a head and row), each
2 Dh flops a pair: S = QK^T, dP = dO V^T, dV = P^T dO, dK = dS^T Q,
dQ = dS K.  q, dO (B, S, H, Dh) and k, v (B, S, K, Dh) read once, dq
(B, S, H, Dh) and dk, dv (B, S, K, Dh) written once, bfloat16."""

PATTERNS = ("attn_bwd_",)
BYTES = 2


def work(B: int, S: int, H: int, K: int, Dh: int) -> tuple:
    pairs = S * (S + 1) // 2
    flops = 10 * Dh * pairs * H * B
    nbytes = BYTES * B * S * Dh * (3 * H + 4 * K)
    return flops, nbytes
