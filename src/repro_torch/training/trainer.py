"""Trainer: the paper's §5.2.4 ``train.py`` workload — data pipeline ->
train step -> metrics -> periodic checkpoints, with resume-from-LATEST
(what you want when the scheduler requeues your job after a node drain).
The port of the JAX package's ``training/trainer.py``: it runs in every
rank of a ``launch.mesh.Mesh`` (one process a cell, on the cell's
device; a one-cell mesh on the card unless the caller names another
device).  Every rank reads the same stream and the step takes its rows;
each rank draws the weights leaf by leaf from the seed and keeps its
shard.  Rank 0 logs and sets the metrics.  Checkpoints hold whole
leaves in the JAX layout, gathered from the ranks a slice at a time and
written by rank 0, so one saved by any mesh restores on any other, and
in the JAX ``Trainer``; each rank reads only its shard back.

Token configs (dense, SSM, hybrid, MoE) train on the packed synthetic
stream, as in the JAX trainer.  The vision and audio stubs train on
``models.make_batch`` batches, whose stub embeddings the token stream
lacks: step i (1-based) draws ``make_batch(seed=tcfg.seed + i)``, so a
resumed job sees the batches an uninterrupted one would.  The JAX
trainer feeds them the token stream.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import checkpoint as ckpt
from repro_torch.configs.base import InputShape, ModelConfig, RunConfig
from repro_torch.data import DataConfig, PackedStream
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import single_device_mesh
from repro_torch.models import init_params, make_batch
from repro_torch.monitoring import MetricsRegistry
from repro_torch.optim import OptimizerConfig
from repro_torch.training.train_step import (
    init_opt_state_sharded, make_train_step,
)
from repro_torch.tree import leaves, leaves_with_path, unflatten


@dataclass
class TrainerConfig:
    steps: int = 100
    log_every: int = 10
    ckpt_every: int = 0              # 0 = no checkpoints
    ckpt_dir: Optional[str] = None
    seed: int = 0


class Trainer:
    """The JAX ``Trainer``'s signature; ``mesh=None`` with ``device``
    names a one-cell mesh on that device (``launch.mesh.
    single_device_mesh``)."""

    def __init__(self, cfg: ModelConfig, run: RunConfig, mesh,
                 shape: InputShape, opt: OptimizerConfig,
                 tcfg: TrainerConfig,
                 metrics: Optional[MetricsRegistry] = None, device=None):
        self.cfg, self.run = cfg, run
        self.mesh = single_device_mesh(device) if mesh is None else mesh
        self.device = resolve_device(self.mesh.device)
        self.shape, self.opt, self.tcfg = shape, opt, tcfg
        self.metrics = metrics or MetricsRegistry()
        self.step_fn = make_train_step(cfg, run, self.mesh, opt)
        self.layout = self.step_fn.layout
        self.rank = self.mesh.rank
        self.data = PackedStream(DataConfig(
            vocab_size=cfg.vocab_size, seq_len=shape.seq_len,
            global_batch=shape.global_batch, seed=tcfg.seed))
        self.step = 0
        self.params = None
        self.opt_state = None
        self.history: list[dict] = []

    # ------------------------------------------------------------ state ----
    @property
    def _sharded(self) -> bool:
        return self.layout.world > 1

    def init_state(self):
        if self._sharded:
            specs = {leaf.path: leaf.param for leaf in self.layout.leaves}
            self.params = init_params(
                self.cfg, self.tcfg.seed, self.device,
                keep=lambda path, t: self.layout.local(t, specs[path])
                .clone())
        else:
            self.params = init_params(self.cfg, self.tcfg.seed, self.device)
        self.opt_state = init_opt_state_sharded(self.params, self.opt,
                                                self.layout)

    def _leaf_specs(self) -> dict:
        """(spec, whole shape) of every sharded leaf of the saved state,
        by its path."""
        out = {}
        for leaf in self.layout.leaves:
            out[f"['params']{leaf.path}"] = leaf.param, leaf.shape
            for k in ("m", "v"):
                out[f"['opt'][{k!r}]{leaf.path}"] = leaf.opt, leaf.shape
        return out

    def _saved_state(self) -> dict:
        """The state as the checkpoint holds it: whole leaves in the JAX
        layout.  Over ranks each leaf is a ``Streamed`` one, gathered a
        slice at a time as it is written, so no rank ever holds more
        than a slice beyond its shards."""
        state = {"params": self.params, "opt": self.opt_state}
        if not self._sharded:
            return state
        specs, lay = self._leaf_specs(), self.layout
        out = []
        for path, t in leaves_with_path(state):
            if path not in specs:                # the step counter
                out.append(t)
                continue
            spec, shape = specs[path]
            out.append(ckpt.Streamed(
                tuple(shape), t.dtype,
                lambda t=t, spec=spec: lay.gather_slices(t, spec)))
        return unflatten(state, out)

    def maybe_resume(self) -> bool:
        d = self.tcfg.ckpt_dir
        if not d:
            return False
        step = ckpt.latest_step(d)
        if step is None:
            return False
        like = {"params": self.params, "opt": self.opt_state}
        select = None
        if self._sharded:
            # each rank reads its own block of every leaf
            specs, lay = self._leaf_specs(), self.layout

            def select(path, whole):
                if path not in specs:
                    return whole
                return lay.local(whole, specs[path][0])
        state, ds = ckpt.restore(d, like, select=select)
        self.params, self.opt_state = state["params"], state["opt"]
        if ds is not None:
            self.data.restore({"doc": int(ds["doc"]), "buf": ds["buf"]})
        self.step = step
        return True

    def save(self):
        if not self.tcfg.ckpt_dir:
            return
        state = self._saved_state()
        if self.rank == 0:
            ds = self.data.state()
            ckpt.save(self.tcfg.ckpt_dir, self.step, state,
                      data_state={"doc": np.int64(ds["doc"]),
                                  "buf": ds["buf"]})
        elif self._sharded:
            # the same gathers, in the same order, as rank 0's writes
            for leaf in leaves(state):
                if isinstance(leaf, ckpt.Streamed):
                    for _ in leaf.parts():
                        pass
        if self._sharded:
            dist.barrier()

    # ------------------------------------------------------------- loop ----
    def _next_batch(self) -> dict:
        if self.cfg.frontend != "none":
            return make_batch(self.cfg, self.shape,
                              seed=self.tcfg.seed + self.step + 1,
                              device=self.device)
        return {k: torch.from_numpy(v).to(self.device)
                for k, v in self.data.next_batch().items()}

    def train(self, log=print):
        """Run to ``tcfg.steps``.  Parameters set on the trainer before the
        call are used as they are (no init, no resume); a missing
        optimizer state is then initialised beside them."""
        if self.params is None:
            self.init_state()
            self.maybe_resume()
        elif self.opt_state is None:
            self.opt_state = init_opt_state_sharded(self.params, self.opt,
                                                    self.layout)
        tokens_per_step = self.shape.global_batch * self.shape.seq_len
        while self.step < self.tcfg.steps:
            batch = self._next_batch()
            t0 = time.perf_counter()
            self.params, self.opt_state, m = self.step_fn(
                self.params, self.opt_state, batch)
            m = {k: float(v) for k, v in m.items()}    # waits for the step
            dt = time.perf_counter() - t0
            self.step += 1
            self.history.append({"step": self.step, **m, "sec": dt})
            if self.rank == 0:
                self.metrics.gauge("train_loss").set(m["loss"])
                self.metrics.gauge("train_grad_norm").set(m["grad_norm"])
                self.metrics.counter("train_tokens").inc(tokens_per_step)
                self.metrics.histogram("train_step_seconds").observe(dt)
            if self.rank == 0 and (self.step % self.tcfg.log_every == 0
                                   or self.step == self.tcfg.steps):
                log(f"step {self.step:5d}  loss {m['loss']:.4f}  "
                    f"gnorm {m['grad_norm']:.3f}  lr {m['lr']:.2e}  "
                    f"{tokens_per_step / dt:,.0f} tok/s")
            if self.tcfg.ckpt_every and \
                    self.step % self.tcfg.ckpt_every == 0:
                self.save()
        return self.history
