"""The one traffic generator: it reads a mix file (``traffic/<name>.json``)
and makes the cell's requests or training rows from ``--seed``.

Every seed gets the same schedule: the sizes, arrivals and shared-prefix
choices are drawn on stratified grids (the distribution's quantiles at
``(i + 0.5) / block`` for ``i < block``), each block permuted by the
mix's own ``schedule_seed``; ``--seed`` picks the token ids (and the
weights).  In a closed loop the order of sizes decides when requests
finish and how many prefills fall in the window, so a seed that permuted
them would change the work; with one schedule, two seeds differ no more
than two runs of one seed do.

Distributions (``{"dist": ..., "min": ..., "max": ...}``):
``uniform`` (integers, both ends in), ``loguniform`` (integers), and
``lomax`` (``mean`` scale, the packed stream's ``pareto(2) * mean / 2 +
8``, cut at ``4 * mean``).
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

#: token ids 0 and 1 are pad and end-of-document; prompts draw from 2..V-1
FIRST_ID = 2
EOS = 1


def rng_for(seed: int, *stream: int) -> np.random.Generator:
    """An independent generator for one stream of one seed (any size of
    seed: numpy takes the whole integer)."""
    return np.random.default_rng([int(seed) & (2**64 - 1), *stream])


def quantile(dist: dict, q: np.ndarray) -> np.ndarray:
    kind = dist["dist"]
    if kind == "uniform":
        lo, hi = dist["min"], dist["max"]
        return np.floor(lo + q * (hi - lo + 1)).astype(np.int64)
    if kind == "loguniform":
        lo, hi = math.log(dist["min"]), math.log(dist["max"] + 1)
        return np.floor(np.exp(lo + q * (hi - lo))).astype(np.int64)
    if kind == "lomax":
        mean = dist["mean"]
        x = (1.0 - q) ** -0.5 - 1.0            # numpy's pareto(2.0)
        return np.minimum((x * mean / 2).astype(np.int64) + 8, 4 * mean)
    if kind == "exponential":                  # a float: gaps in seconds
        return -np.log1p(-q) * dist["mean"]
    raise ValueError(f"unknown distribution {kind!r}")


def stratified(dist: dict, block: int, rng: np.random.Generator):
    """One block of draws: the ``block`` grid quantiles, permuted."""
    q = (np.arange(block) + 0.5) / block
    return rng.permutation(quantile(dist, q))


def weighted_counts(weights: np.ndarray, n: int) -> np.ndarray:
    """Integer counts summing to ``n`` in proportion to ``weights``
    (largest remainder)."""
    share = weights / weights.sum() * n
    counts = np.floor(share).astype(np.int64)
    rest = n - counts.sum()
    order = np.argsort(-(share - counts), kind="stable")
    counts[order[:rest]] += 1
    return counts


@dataclass
class ServeRequest:
    """One request as the client sends it."""
    index: int
    prompt: np.ndarray          # int32 token ids
    max_new: int
    due: float = 0.0            # seconds after the window opens (open loop)
    prefix: int = -1            # which shared prefix it starts with


class ServeStream:
    """The requests of a serving mix, in the order the clients send them:
    ``warm()`` the requests that fill the slots before the window opens,
    then ``next()`` one at a time."""

    def __init__(self, mix: dict, vocab: int, seed: int):
        self.mix, self.vocab, self.seed = mix, vocab, int(seed)
        self.schedule = int(mix.get("schedule_seed", 0))
        self.block = int(mix.get("block", 128))
        self._buf: list = []
        self._blocks = 0
        self._count = 0
        self._due = 0.0
        pre = mix.get("prefixes")
        self.prefixes = []
        if pre:
            r = rng_for(seed, 1)
            self.prefixes = [r.integers(FIRST_ID, vocab, pre["length"])
                             .astype(np.int32) for _ in range(pre["count"])]

    def _ids(self, rng, n: int) -> np.ndarray:
        return rng.integers(FIRST_ID, self.vocab, int(n)).astype(np.int32)

    def _refill(self):
        mix, n = self.mix, self.block
        rng = rng_for(self.schedule, 2, self._blocks)
        ids = rng_for(self.seed, 5, self._blocks)
        self._blocks += 1
        plen = stratified(mix["prompt"], n, rng)
        out = stratified(mix["output"], n, rng)
        which = np.full(n, -1)
        if self.prefixes:
            zipf = np.arange(1, len(self.prefixes) + 1) \
                ** -float(mix["prefixes"]["zipf_s"])
            which = rng.permutation(np.repeat(
                np.arange(len(self.prefixes)), weighted_counts(zipf, n)))
        gaps = None
        if mix["loop"] == "open":
            gaps = stratified({"dist": "exponential",
                               "mean": 1.0 / mix["rate"]}, n, rng)
        for i in range(n):
            prompt = self._ids(ids, plen[i])
            if which[i] >= 0:
                prompt = np.concatenate([self.prefixes[which[i]], prompt])
            if gaps is not None:
                self._due += float(gaps[i])
            self._buf.append(ServeRequest(self._count, prompt, int(out[i]),
                                          self._due, int(which[i])))
            self._count += 1

    def next(self) -> ServeRequest:
        if not self._buf:
            self._refill()
        return self._buf.pop(0)

    def warm(self) -> list:
        """Closed loop with ``warm_start: remaining_life``: one request a
        client, each as if it had run a while already, so the batch is in
        its steady state when the window opens: its whole output length
        is drawn in proportion to the length (length-biased), its age
        uniformly below it; it sends ``prompt + age`` tokens and asks for
        the rest.  Other mixes start empty."""
        mix = self.mix
        if mix.get("warm_start") != "remaining_life":
            return []
        n = int(mix["clients"])
        rng = rng_for(self.schedule, 3)
        ids = rng_for(self.seed, 6)
        lo, hi = mix["output"]["min"], mix["output"]["max"]
        # n length-biased draws on the grid (a request in flight is more
        # likely a long one), then each one's age below its length
        lengths = np.arange(lo, hi + 1)
        cdf = np.cumsum(lengths) / lengths.sum()
        total = rng.permutation(lengths[np.searchsorted(
            cdf, (np.arange(n) + 0.5) / n)])
        age = np.floor(((rng.permutation(n) + 0.5) / n) * total).astype(int)
        plen = stratified(mix["prompt"], n, rng)
        warm = []
        for i in range(n):
            prompt = self._ids(ids, plen[i] + age[i])
            warm.append(ServeRequest(-1 - i, prompt,
                                     int(total[i] - age[i]), 0.0))
        return warm


def train_batch(mix: dict, vocab: int, seed: int, step: int) -> dict:
    """Rows of packed synthetic documents for step ``step`` (1-based):
    ``{tokens, labels, loss_mask}`` of shape (batch, seq_len), as the
    port's data pipeline packs them (EOS between documents, no loss on
    the token after an EOS).  Every step's rows differ."""
    B, S = int(mix["batch"]), int(mix["seq_len"])
    need = B * (S + 1)
    rng = rng_for(seed, 4, step)
    docs = []
    have = 0
    while have < need:
        lens = stratified(mix["docs"], int(mix.get("block", 64)), rng)
        for n in lens:
            docs.append(rng.integers(FIRST_ID, vocab, int(n)).astype(np.int32))
            docs.append(np.array([EOS], np.int32))
            have += int(n) + 1
            if have >= need:
                break
    rows = np.concatenate(docs)[:need].reshape(B, S + 1)
    tokens, labels = rows[:, :-1].copy(), rows[:, 1:].copy()
    return {"tokens": tokens, "labels": labels,
            "loss_mask": (tokens != EOS).astype(np.float32)}
