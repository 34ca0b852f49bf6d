"""Deterministic synthetic LM data pipeline with per-host sharding, sequence
packing and background prefetch.

The paper's cluster stores datasets on shared storage (§3.1.4) and every node
reads its slice; here the "shared dataset" is a deterministic token stream
(seeded xorshift over document ids), so every host can materialize exactly
its shard with no files — same access pattern, no I/O dependency.  Documents
have Zipf-ish lengths and are *packed* into fixed-length training sequences
with loss masking across document boundaries, which is what production LM
pipelines do.

A copy of the JAX package's ``data/pipeline.py``: numpy only, so both
packages draw the same batches from the same seed.
"""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Iterator, Optional

import numpy as np


@dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    mean_doc_len: int = 512
    num_hosts: int = 1
    host_id: int = 0
    pack: bool = True

    def __post_init__(self):
        assert self.global_batch % self.num_hosts == 0
        assert 0 <= self.host_id < self.num_hosts

    @property
    def host_batch(self) -> int:
        return self.global_batch // self.num_hosts


def _doc_tokens(doc_id: int, cfg: DataConfig) -> np.ndarray:
    """Deterministic pseudo-document: length + content from the doc id."""
    rng = np.random.default_rng((cfg.seed << 32) ^ doc_id)
    length = int(rng.pareto(2.0) * cfg.mean_doc_len / 2) + 8
    length = min(length, 4 * cfg.mean_doc_len)
    # reserve ids 0/1 as pad/eos
    return rng.integers(2, cfg.vocab_size, length, dtype=np.int32)


EOS = 1
PAD = 0


class PackedStream:
    """Packs the deterministic document stream into (seq_len+1)-token rows.

    Each host consumes a disjoint, strided shard of the document id space —
    `host_id + k * num_hosts` — so global determinism holds for any host
    count (the multi-host analogue of a shared filesystem read).
    """

    def __init__(self, cfg: DataConfig, start_doc: int = 0):
        self.cfg = cfg
        self._doc = start_doc * cfg.num_hosts + cfg.host_id
        self._buf = np.empty(0, np.int32)

    def state(self) -> dict:
        """Checkpointable position (resume without replaying)."""
        return {"doc": self._doc, "buf": self._buf.copy()}

    def restore(self, state: dict):
        self._doc = state["doc"]
        self._buf = state["buf"].copy()

    def _fill(self, need: int):
        parts = [self._buf]
        have = len(self._buf)
        while have < need:
            toks = _doc_tokens(self._doc, self.cfg)
            self._doc += self.cfg.num_hosts
            parts.append(toks)
            parts.append(np.array([EOS], np.int32))
            have += len(toks) + 1
        self._buf = np.concatenate(parts)

    def next_batch(self) -> dict:
        """{tokens (B,S), labels (B,S), loss_mask (B,S)} for this host."""
        cfg = self.cfg
        B, S = cfg.host_batch, cfg.seq_len
        need = B * (S + 1)
        self._fill(need)
        rows = self._buf[:need].reshape(B, S + 1)
        self._buf = self._buf[need:]
        tokens = rows[:, :-1]
        labels = rows[:, 1:]
        # no loss on predicting the token after EOS (next doc's first token)
        mask = (tokens != EOS).astype(np.float32)
        return {"tokens": tokens.copy(), "labels": labels.copy(),
                "loss_mask": mask}


class PrefetchLoader:
    """Background-thread prefetch (the pipeline's I/O overlap)."""

    def __init__(self, stream: PackedStream, depth: int = 2):
        self.stream = stream
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        while not self._stop.is_set():
            batch = self.stream.next_batch()
            while not self._stop.is_set():
                try:
                    self._q.put(batch, timeout=0.1)
                    break
                except queue.Full:
                    continue

    def __iter__(self) -> Iterator[dict]:
        return self

    def __next__(self) -> dict:
        return self._q.get()

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2.0)
