"""Trainer: the paper's §5.2.4 ``train.py`` workload — data pipeline ->
train step -> metrics -> periodic checkpoints, with resume-from-LATEST
(what you want when the scheduler requeues your job after a node drain).
The port of the JAX package's ``training/trainer.py`` for one device: no
mesh; the step runs on ``device`` (CUDA unless the caller asks for
another).
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from repro_torch import checkpoint as ckpt
from repro_torch.configs.base import InputShape, ModelConfig, RunConfig
from repro_torch.data import DataConfig, PackedStream
from repro_torch.device import resolve_device
from repro_torch.models import init_params
from repro_torch.monitoring import MetricsRegistry
from repro_torch.optim import OptimizerConfig, init_opt_state
from repro_torch.training.train_step import make_train_step


@dataclass
class TrainerConfig:
    steps: int = 100
    log_every: int = 10
    ckpt_every: int = 0              # 0 = no checkpoints
    ckpt_dir: Optional[str] = None
    seed: int = 0


class Trainer:
    def __init__(self, cfg: ModelConfig, run: RunConfig, shape: InputShape,
                 opt: OptimizerConfig, tcfg: TrainerConfig,
                 metrics: Optional[MetricsRegistry] = None, device=None):
        self.cfg, self.run = cfg, run
        self.shape, self.opt, self.tcfg = shape, opt, tcfg
        self.device = resolve_device(device)
        self.metrics = metrics or MetricsRegistry()
        self.step_fn = make_train_step(cfg, run, opt)
        self.data = PackedStream(DataConfig(
            vocab_size=cfg.vocab_size, seq_len=shape.seq_len,
            global_batch=shape.global_batch, seed=tcfg.seed))
        self.step = 0
        self.params = None
        self.opt_state = None
        self.history: list[dict] = []

    # ------------------------------------------------------------ state ----
    def init_state(self):
        self.params = init_params(self.cfg, self.tcfg.seed, self.device)
        self.opt_state = init_opt_state(self.params, self.opt)

    def maybe_resume(self) -> bool:
        d = self.tcfg.ckpt_dir
        if not d:
            return False
        step = ckpt.latest_step(d)
        if step is None:
            return False
        state, ds = ckpt.restore(
            d, {"params": self.params, "opt": self.opt_state})
        self.params, self.opt_state = state["params"], state["opt"]
        if ds is not None:
            self.data.restore({"doc": int(ds["doc"]), "buf": ds["buf"]})
        self.step = step
        return True

    def save(self):
        if not self.tcfg.ckpt_dir:
            return
        ds = self.data.state()
        ckpt.save(self.tcfg.ckpt_dir, self.step,
                  {"params": self.params, "opt": self.opt_state},
                  data_state={"doc": np.int64(ds["doc"]), "buf": ds["buf"]})

    # ------------------------------------------------------------- loop ----
    def train(self, log=print):
        """Run to ``tcfg.steps``.  Parameters set on the trainer before the
        call are used as they are (no init, no resume); a missing
        optimizer state is then initialised beside them."""
        if self.params is None:
            self.init_state()
            self.maybe_resume()
        elif self.opt_state is None:
            self.opt_state = init_opt_state(self.params, self.opt)
        tokens_per_step = self.shape.global_batch * self.shape.seq_len
        while self.step < self.tcfg.steps:
            batch = {k: torch.from_numpy(v).to(self.device)
                     for k, v in self.data.next_batch().items()}
            t0 = time.perf_counter()
            self.params, self.opt_state, m = self.step_fn(
                self.params, self.opt_state, batch)
            m = {k: float(v) for k, v in m.items()}    # waits for the step
            dt = time.perf_counter() - t0
            self.step += 1
            self.metrics.gauge("train_loss").set(m["loss"])
            self.metrics.gauge("train_grad_norm").set(m["grad_norm"])
            self.metrics.counter("train_tokens").inc(tokens_per_step)
            self.metrics.histogram("train_step_seconds").observe(dt)
            self.history.append({"step": self.step, **m, "sec": dt})
            if self.step % self.tcfg.log_every == 0 or \
                    self.step == self.tcfg.steps:
                log(f"step {self.step:5d}  loss {m['loss']:.4f}  "
                    f"gnorm {m['grad_norm']:.3f}  lr {m['lr']:.2e}  "
                    f"{tokens_per_step / dt:,.0f} tok/s")
            if self.tcfg.ckpt_every and \
                    self.step % self.tcfg.ckpt_every == 0:
                self.save()
        return self.history
