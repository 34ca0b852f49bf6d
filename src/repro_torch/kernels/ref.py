"""Plain PyTorch versions of the kernels.

They re-derive the math as naively as possible, as the JAX package's
``kernels/ref.py`` does, in the model layout.  Each computes in f32 and
casts the output to the input's dtype, as the kernels do.  The CPU path of
``kernels.ops`` runs them, the backward of a kernel recomputes its plain
version under autograd, and ``chip_smoke.py`` holds each CUDA kernel
against its plain version on the card.
"""
from __future__ import annotations

import torch

f32 = torch.float32


def _attend(q, k, v, mask):
    """q: (B, Sq, H, Dh); k/v: (B, Sk, K, Dh); mask broadcastable to
    (B, H, Sq, Sk).  f32 softmax, output in q's dtype."""
    H, Dh = q.shape[2], q.shape[3]
    G = H // k.shape[2]
    kk = k.to(f32).repeat_interleave(G, dim=2)
    vv = v.to(f32).repeat_interleave(G, dim=2)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.to(f32), kk) * (Dh ** -0.5)
    logits = logits.masked_fill(~mask, float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", probs, vv)
    return o.to(q.dtype)


def attention_ref(q, k, v, window=None):
    """Naive causal (+ sliding window) attention.

    q: (B, S, H, Dh); k/v: (B, S, K, Dh), H % K == 0."""
    S = q.shape[1]
    pos = torch.arange(S, device=q.device)
    mask = pos[None, :] <= pos[:, None]
    if window is not None:
        mask &= (pos[:, None] - pos[None, :]) < window
    return _attend(q, k, v, mask[None, None])


def decode_attention_ref(q, k, v, pos, window=None):
    """Naive single-query decode attention over a dense cache.

    q: (B, 1, H, Dh); k/v: (B, S, K, Dh); pos: (B,) int.  Without
    ``window`` slot i holds position i and sequence b attends slots
    [0, pos_b].  With ``window`` the cache is a ring of S slots: slot i
    holds position ``pos - ((pos - i) mod S)``, attended when written
    (>= 0) and inside the window (the mask of the TPU kernel,
    ``flash_decode.py:70-79``)."""
    S = k.shape[1]
    slot = torch.arange(S, device=q.device)[None, :]
    p = pos.to(torch.int64)[:, None]
    if window is None:
        valid = slot <= p
    else:
        slot_pos = p - torch.remainder(p - slot, S)
        valid = (slot_pos >= 0) & ((p - slot_pos) < window)
    return _attend(q, k, v, valid[:, None, None, :])


def paged_decode_attention_ref(q, k, v, page_table, pos):
    """Naive paged decode attention.

    q: (B, 1, H, Dh); k/v: (num_pages, page_size, K, Dh) shared pool;
    page_table: (B, n_pages) int (0 = null page); pos: (B,) int.
    Gathers the logical (B, n_pages * page_size, K, Dh) view through the
    page table, then defers to :func:`decode_attention_ref`."""
    B, n_pages = page_table.shape
    ps, K, Dh = k.shape[1], k.shape[2], k.shape[3]
    idx = page_table.to(torch.int64)
    kd = k[idx].reshape(B, n_pages * ps, K, Dh)
    vd = v[idx].reshape(B, n_pages * ps, K, Dh)
    return decode_attention_ref(q, kd, vd, pos)


def ssd_scan_ref(x, dt, a, Bm, Cm, chunk: int):
    """The chunked SSD scan of the TPU kernel ``_ssd_kernel``, in the model
    layout and differentiable.

    x: (B, S, H, P); dt and a = dt * A: (B, S, H), float32; Bm/Cm:
    (B, S, N); S % chunk == 0.  All in f32 (x dt included); y in x's
    dtype.  The arithmetic is :func:`ssd_chunks`'."""
    y, _ = ssd_chunks(x.to(f32) * dt.to(f32)[..., None], a, Bm, Cm, chunk)
    return y.to(x.dtype)


def ssd_chunks(xdt, a, Bm, Cm, chunk: int, init_state=None):
    """The chunked SSD algorithm on x * dt, shared by the kernel's plain
    version (:func:`ssd_scan_ref`) and the model's reference route
    (``models.ssm.ssd_chunked``, which rounds x dt to x's dtype and pads a
    ragged S first).

    xdt: (B, S, H, P) float32; a = dt * A: (B, S, H); Bm/Cm: (B, S, N);
    S % chunk == 0; init_state: (B, H, P, N) or None (zeros).  Per chunk,
    with cs = cumsum(a): ``y = ((C B^T) * L) @ xdt + (C state^T) *
    exp(cs)``, where ``L[q, k] = exp(cs[q] - cs[k])`` for k <= q, and the
    (P, N) f32 state becomes ``state * exp(cs[-1]) + (xdt exp(cs[-1] -
    cs))^T B``.  Returns (y (B, S, H, P) f32, final state (B, H, P, N)
    f32).  No tensor holds both a Q x Q pair and the P axis: the masked
    decays are (B, nc, H, Q, Q) and meet xdt in a batched product."""
    B, S, H, P = xdt.shape
    N = Bm.shape[-1]
    Q = chunk
    if S % Q:
        raise ValueError(f"ssd_chunks: S={S} is not a multiple of the "
                         f"chunk {Q}")
    nc = S // Q
    dev = xdt.device
    xdt = xdt.to(f32).reshape(B, nc, Q, H, P)
    xdt = xdt.permute(0, 1, 3, 2, 4)                       # (B,nc,H,Q,P)
    cs = a.to(f32).reshape(B, nc, Q, H).permute(0, 1, 3, 2).cumsum(-1)
    Bc = Bm.to(f32).reshape(B, nc, Q, N)
    Cc = Cm.to(f32).reshape(B, nc, Q, N)

    # ---- within each chunk
    causal = torch.ones(Q, Q, dtype=torch.bool, device=dev).tril()
    seg = cs[..., :, None] - cs[..., None, :]              # (B,nc,H,Q,Q)
    # the exponent is masked before exp: above the diagonal it is positive
    L = torch.exp(torch.where(causal, seg, float("-inf")))
    scores = Cc @ Bc.transpose(-1, -2)                     # (B,nc,Q,Q)
    y = (scores[:, :, None] * L) @ xdt                     # (B,nc,H,Q,P)

    # ---- the state carried across chunks
    in_decay = torch.exp(cs[..., -1:] - cs)                # (B,nc,H,Q)
    chunk_states = (xdt * in_decay[..., None]).transpose(-1, -2) \
        @ Bc[:, :, None]                                   # (B,nc,H,P,N)
    chunk_decay = torch.exp(cs[..., -1])                   # (B,nc,H)
    state = (torch.zeros(B, H, P, N, dtype=f32, device=dev)
             if init_state is None else init_state.to(f32))
    y_off = []
    for c in range(nc):
        y_off.append((Cc[:, c, None] @ state.transpose(-1, -2))
                     * torch.exp(cs[:, c])[..., None])     # (B,H,Q,P)
        state = state * chunk_decay[:, c, :, None, None] + chunk_states[:, c]
    y = y + torch.stack(y_off, dim=1)
    return y.permute(0, 1, 3, 2, 4).reshape(B, S, H, P), state


def ssd_ref(x, dt, A, Bm, Cm):
    """Naive sequential SSD recurrence (token by token, exact): the oracle
    of the JAX package's ``kernels/ref.py::ssd_ref``.

    x: (B, S, H, P); dt: (B, S, H) post-softplus; A: (H,); Bm/Cm:
    (B, S, N).  Returns y: (B, S, H, P) in x's dtype."""
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    xf, dtf = x.to(f32), dt.to(f32)
    Bf, Cf, Af = Bm.to(f32), Cm.to(f32), A.to(f32)
    state = torch.zeros(B, H, P, N, dtype=f32, device=x.device)
    ys = []
    for t in range(S):
        decay = torch.exp(dtf[:, t] * Af)                  # (B,H)
        dBx = torch.einsum("bh,bhp,bn->bhpn", dtf[:, t], xf[:, t], Bf[:, t])
        state = state * decay[..., None, None] + dBx
        ys.append(torch.einsum("bhpn,bn->bhp", state, Cf[:, t]))
    return torch.stack(ys, dim=1).to(x.dtype)
