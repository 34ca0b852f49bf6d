"""Draft sources for speculative decoding — the port of the JAX package's
``serving/spec.py``: the acceptance rules and the n-gram source are
copies (they are numpy only); the draft-model source runs the port's
``prefill``/``decode_step``/``decode_n``.

The engine's speculative step needs, per live slot, up to ``k`` proposed
next tokens.  Two sources implement one small interface:

  * :class:`NgramDraftSource` — prompt-lookup drafts: match the slot's
    current suffix against (a) its *own* context (prompt + tokens emitted
    so far) and (b) a cross-request :class:`NgramIndex` fed with finished
    requests' sequences (the radix prefix index tells us *pages* repeat;
    this tells us *continuations* repeat).  Free — no extra model, no
    extra dispatches — and very effective on repeat-heavy workloads.
  * :class:`ModelDraftSource` — a tiny autoregressive draft model (a
    shrunk config from :func:`draft_config`) with its own dense KV cache,
    advanced with the same ``decode_n`` loop as the target.

Acceptance lives here too: :func:`greedy_accept` (longest agreeing run —
output bit-identical to non-speculative greedy decode) and
:func:`rejection_sample` (accept token *i* with probability
``min(1, p_target(d_i)/q_draft(d_i))``, resample from the normalized
residual on first rejection — exactly distribution-preserving; with the
point-mass drafts produced here ``q(d_i) = 1`` so the accept probability
is simply ``p_target(d_i)``).

The interface (duck-typed; the engine calls only these):

  begin(slot, ctx)        slot admitted/resumed with token context ``ctx``
                          (prompt + any tokens generated so far, including
                          the last sampled token)
  draft(slot, k)          -> np.int32 array of up to ``k`` proposals
                          (may be shorter, may be empty — the engine
                          falls back to plain decode for empty drafts)
  advance(slot, emitted)  tokens actually emitted this round (accepted
                          run + correction/bonus), in order
  release(slot)           slot vacated (finish, eviction, requeue)
  observe(tokens)         a finished request's full sequence, for
                          cross-request indices
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.configs import RunConfig
from repro_torch.device import resolve_device
from repro_torch.models.init import init_params
from repro_torch.models.model import (
    cast_for_compute, compute_dtype, decode_n, decode_step, init_cache,
    prefill,
)

__all__ = [
    "greedy_accept",
    "rejection_sample",
    "NgramIndex",
    "NgramDraftSource",
    "ModelDraftSource",
    "draft_config",
]


# ------------------------------------------------------------ acceptance ----

def greedy_accept(targets, drafts):
    """Longest agreeing run under greedy decoding.

    ``targets`` is the target model's greedy pick at each verify row
    (length ``k+1``: row ``j`` predicts the token after draft ``j-1``);
    ``drafts`` the ``k`` proposals.  Returns the emitted tokens:
    accepted drafts plus the target's own next token (the correction
    where the first disagreement happened, or the bonus token when every
    draft agreed) — always at least one token, and bit-identical to
    running the target one token at a time.
    """
    targets = np.asarray(targets)
    drafts = np.asarray(drafts)
    m = 0
    while m < len(drafts) and int(targets[m]) == int(drafts[m]):
        m += 1
    return targets[: m + 1].astype(np.int32)


def rejection_sample(rng, probs, drafts):
    """Distribution-preserving acceptance under temperature sampling.

    ``probs`` is the target model's per-row probability vector (already
    temperature-scaled softmax, shape ``(k+1, V)`` float); ``drafts``
    the ``k`` point-mass proposals.  Token ``j`` is accepted with
    probability ``p[j][d_j]`` (the ``min(1, p/q)`` rule with ``q`` a
    point mass); on the first rejection we resample from the residual
    ``p[j]`` with ``d_j`` removed and renormalized, and stop.  If every
    draft is accepted, a bonus token is drawn from the final row.  The
    marginal distribution of each emitted token is exactly the target
    model's — speculation changes speed, not outputs.
    """
    probs = np.asarray(probs, dtype=np.float64)
    emitted = []
    for j, d in enumerate(np.asarray(drafts)):
        d = int(d)
        if rng.random() < probs[j, d]:
            emitted.append(d)
            continue
        residual = probs[j].copy()
        residual[d] = 0.0
        z = residual.sum()
        if z <= 0.0:                       # degenerate row: p was a point
            residual = np.full_like(residual, 1.0 / len(residual))
        else:
            residual /= z
        emitted.append(int(rng.choice(len(residual), p=residual)))
        return np.asarray(emitted, np.int32)
    row = probs[len(drafts)]
    row = row / row.sum()
    emitted.append(int(rng.choice(len(row), p=row)))
    return np.asarray(emitted, np.int32)


# --------------------------------------------------------- n-gram source ----

class NgramIndex:
    """Cross-request suffix -> continuation map, fed at request finish.

    Last-writer-wins per suffix tuple, capacity-bounded with oldest-entry
    eviction (dict insertion order doubles as the LRU list — a refreshed
    key is deleted and re-inserted so it moves to the back).
    """

    def __init__(self, orders=(3, 2), max_continuation: int = 16,
                 capacity: int = 4096):
        self.orders = tuple(sorted(orders, reverse=True))
        self.max_continuation = max_continuation
        self.capacity = capacity
        self._map: dict = {}

    def __len__(self):
        return len(self._map)

    def observe(self, tokens) -> None:
        toks = np.asarray(tokens, np.int32)
        for o in self.orders:
            for i in range(len(toks) - o):
                gram = tuple(int(t) for t in toks[i:i + o])
                cont = toks[i + o:i + o + self.max_continuation].copy()
                if len(cont) == 0:
                    continue
                self._map.pop((o, gram), None)
                self._map[(o, gram)] = cont
        while len(self._map) > self.capacity:
            self._map.pop(next(iter(self._map)))

    def lookup(self, suffix):
        """Longest-order match of ``suffix`` (a token sequence); returns
        the stored continuation (np.int32 array) or None."""
        suffix = [int(t) for t in suffix]
        for o in self.orders:
            if len(suffix) < o:
                continue
            hit = self._map.get((o, tuple(suffix[-o:])))
            if hit is not None:
                return hit
        return None


class _SlotNgrams:
    """Per-slot own-context n-gram maps, built incrementally.

    Values are ``(latest, prev)`` end positions (index just past the
    gram).  The gram formed by the context's own tail always matches
    itself at ``latest == len(ctx)`` — a useless self-match — so lookups
    fall back to ``prev`` in that case.
    """

    def __init__(self, orders, ctx):
        self.orders = orders
        self.ctx = [int(t) for t in np.asarray(ctx).ravel()]
        self.maps = {o: {} for o in orders}
        for t in range(len(self.ctx)):
            self._index_at(t)

    def _index_at(self, t):
        for o in self.orders:
            if t + 1 < o:
                continue
            gram = tuple(self.ctx[t + 1 - o:t + 1])
            m = self.maps[o]
            old = m.get(gram)
            m[gram] = (t + 1, old[0] if old else None)

    def append(self, tokens):
        for t in np.asarray(tokens).ravel():
            self.ctx.append(int(t))
            self._index_at(len(self.ctx) - 1)

    def match(self, k):
        n = len(self.ctx)
        for o in self.orders:
            if n < o:
                continue
            hit = self.maps[o].get(tuple(self.ctx[-o:]))
            if hit is None:
                continue
            latest, prev = hit
            j = prev if latest >= n else latest
            if j is None:
                continue
            cont = self.ctx[j:j + k]
            if cont:
                return np.asarray(cont, np.int32)
        return None


class NgramDraftSource:
    """Prompt-lookup drafting: own context first, shared index second."""

    kind = "ngram"

    def __init__(self, orders=(3, 2), index: NgramIndex | None = None):
        self.orders = tuple(sorted(orders, reverse=True))
        self.index = index if index is not None else NgramIndex(self.orders)
        self._slots: dict[int, _SlotNgrams] = {}

    def begin(self, slot, ctx):
        self._slots[slot] = _SlotNgrams(self.orders, ctx)

    def release(self, slot):
        self._slots.pop(slot, None)

    def advance(self, slot, emitted):
        st = self._slots.get(slot)
        if st is not None:
            st.append(emitted)

    def observe(self, tokens):
        self.index.observe(tokens)

    def draft(self, slot, k):
        st = self._slots.get(slot)
        if st is None:
            return np.zeros((0,), np.int32)
        cont = st.match(k)
        if cont is None:
            hit = self.index.lookup(st.ctx)
            cont = None if hit is None else hit[:k]
        if cont is None:
            return np.zeros((0,), np.int32)
        return np.asarray(cont[:k], np.int32)


# ---------------------------------------------------- draft-model source ----

def draft_config(cfg):
    """A tiny dense config sharing the target's vocabulary/tokenization —
    1 layer, 128-wide — cheap enough that k draft steps cost a fraction
    of one target step."""
    return dataclasses.replace(
        cfg,
        name=f"{cfg.name}-draft",
        family="dense",
        num_layers=1,
        d_model=128,
        num_heads=2,
        num_kv_heads=2,
        head_dim=32,
        d_ff=256,
        sliding_window=None,
        attn_every=1,
        moe=None,
        ssm=None,
        frontend="none",
    )


def _bucket(n: int) -> int:
    b = 8
    while b < n:
        b *= 2
    return b


class ModelDraftSource:
    """A small autoregressive draft model with its own dense KV cache.

    The cache is ``(num_slots, cache_len)`` dense; per slot we track the
    position of the last emitted token, whose KV line is written by the
    *next* draft call (same convention as the engine's decode loop).
    Drafting runs the shared ``decode_n`` loop with every other slot
    masked done — frozen slots re-feed their last (token, pos), so their
    rows stay consistent.  The cache is written in place.

    One wrinkle: when a round is fully accepted (all ``k`` drafts plus
    the bonus token), the line for draft ``k-1`` was never written by
    the k-step loop (it only *fed* drafts ``0..k-2``).  We record a
    per-slot ``pending`` token and catch up with a single extra
    decode_step before the next draft; rounds with any rejection need no
    catch-up because the next loop overwrites the dead lines before
    reading them.

    ``params`` (the JAX draft's weights through ``params_from_jax`` in
    the tests) replaces weights drawn from ``seed``; drafts are greedy, so
    the ``torch.Generator`` that ``decode_n`` draws from never changes a
    proposal.  With ``run.use_kernels`` the prefill and the decode steps
    go through ``flash_attention`` and the dense ``flash_decode``.
    """

    kind = "model"

    def __init__(self, cfg, num_slots, cache_len, seed=0, params=None,
                 run=None, device=None):
        self.cfg = cfg
        self.num_slots = num_slots
        self.cache_len = cache_len
        self.device = resolve_device(device)
        self.run = run if run is not None else RunConfig(use_kernels=True)
        if params is None:
            params = init_params(cfg, seed, self.device)
        self.params = cast_for_compute(params, compute_dtype(cfg))
        self.cache = init_cache(cfg, num_slots, cache_len,
                                device=self.device)
        self.pos = np.zeros(num_slots, np.int32)
        self.last = np.zeros(num_slots, np.int32)
        self.live = np.zeros(num_slots, bool)
        self.pending = {}            # slot -> token needing a catch-up step
        self._gen = torch.Generator(device=self.device).manual_seed(seed)

    def _put(self, a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    # ------------------------------------------------------------ hooks ----
    def begin(self, slot, ctx):
        ctx = np.asarray(ctx, np.int32).ravel()
        assert len(ctx) >= 1
        self.pending.pop(slot, None)
        if len(ctx) > 1:
            # a context longer than the draft cache keeps only its tail,
            # re-based at position 0 — the draft's positions are private
            prior = ctx[:-1][-(self.cache_len - 2):]
            b = _bucket(len(prior))
            padded = np.zeros((1, b), np.int32)
            padded[0, :len(prior)] = prior
            with torch.no_grad():
                _, one = prefill(self.params, {"tokens": self._put(padded)},
                                 self.cfg, self.run)
            # lines past the real prefix are masked by pos until each is
            # overwritten in place by a later draft step
            n = min(b, self.cache_len)
            for dst, src in zip(self.cache["layers"], one["layers"]):
                for name in ("k", "v"):
                    dst[name][:, slot, :n].copy_(src[name][:, 0, :n])
            self.pos[slot] = len(prior)
        else:
            self.pos[slot] = 0
        self.last[slot] = ctx[-1]
        self.live[slot] = True

    def release(self, slot):
        self.live[slot] = False
        self.pending.pop(slot, None)

    def advance(self, slot, emitted):
        emitted = np.asarray(emitted, np.int32).ravel()
        if not self.live[slot] or len(emitted) == 0:
            return
        new_pos = int(self.pos[slot]) + len(emitted)
        if new_pos >= self.cache_len - 1:
            # out of draft-cache room: stop drafting for this slot (the
            # engine falls back to plain decode on empty drafts)
            self.live[slot] = False
            return
        self.pos[slot] = new_pos
        self.last[slot] = emitted[-1]

    def observe(self, tokens):
        pass

    def set_pending(self, slot, token):
        """The round was fully accepted: draft ``k-1``'s KV line was
        never written — feed it once before the next draft."""
        self.pending[slot] = int(token)

    def draft(self, slot, k):
        if (not self.live[slot] or k <= 0
                or int(self.pos[slot]) + k + 2 >= self.cache_len):
            return np.zeros((0,), np.int32)
        B = self.num_slots
        with torch.no_grad():
            tok = self.pending.pop(slot, None)
            if tok is not None:
                # other rows re-feed (last, pos) — the value their own
                # next draft would write there anyway
                t = self.last.copy()
                q = self.pos.copy()
                t[slot] = tok
                q[slot] = self.pos[slot] - 1
                decode_step(self.params, self.cache, self._put(t)[:, None],
                            self._put(q), self.cfg, self.run)
            done = np.ones(B, bool)
            done[slot] = False
            toks, *_ = decode_n(
                self.params, self.cache, self._put(self.last),
                self._put(self.pos), self._put(np.full(B, 1 << 20, np.int32)),
                self._put(done), self._put(np.full(B, -1, np.int32)),
                self._put(np.zeros(B, np.float32)), self._gen, self.cfg,
                self.run, k, self.cache_len)
            return toks[slot].cpu().numpy().astype(np.int32)
