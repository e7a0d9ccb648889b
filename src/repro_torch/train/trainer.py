"""Trainer (`repro.train.trainer`): the train step over the synthetic
token pipeline, in a plain loop or under `FaultTolerantRunner`
(checkpoint every `ckpt_every` steps, restore and go on after a failed
step), with a heartbeat file, step timing and straggler flags.  Step i
trains on the pipeline's batch i, also after a restore (the JAX trainer
takes the pipeline's next batch, so its restored steps see later
batches); a restarted run therefore ends on the uninterrupted run's
parameters.

One card, no mesh: a `mesh` other than None raises (`sharding.py` and
the reshard on restore wait for a four-card cell, ROADMAP Queue A 15).
The step is eager PyTorch on the trainer's device (`cuda` unless
named).  On CUDA the backward of the embedding lookup and of the MoE
dispatch is a scatter-add, whose atomics make a step's bits vary from
run to run; `deterministic()` turns on PyTorch's deterministic
algorithms (and the cuBLAS workspace setting they need), under which two
runs of the same steps give the same bits.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.kernels import common
from repro_torch.models.registry import build
from repro_torch.optim import make_optimizer
from repro_torch.runtime import checkpoint as CK
from repro_torch.runtime.fault import FaultTolerantRunner, Heartbeat, \
    StepTimer
from repro_torch.train.train_step import make_train_step


def deterministic() -> None:
    """Deterministic CUDA algorithms for training: sort-based
    scatter-adds in the backward, and the cuBLAS workspace setting that
    PyTorch then requires (set here unless the caller set one; cuBLAS
    reads it when its first handle is made, so call this before the
    first product on the card).  The mode's filling of every
    `torch.empty` is turned off: it is a launch per allocation, and every
    kernel of the port writes each element of its outputs."""
    import torch.utils.deterministic
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True)
    torch.utils.deterministic.fill_uninitialized_memory = False


@dataclasses.dataclass
class TrainConfig:
    steps: int = 100
    batch: int = 8
    seq: int = 256
    lr: float = 3e-4
    warmup: int = 20
    seed: int = 0
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 200
    log_every: int = 10
    microbatch: Optional[int] = None


class Trainer:
    def __init__(self, cfg: ModelConfig, tcfg: TrainConfig, mesh=None,
                 device=None):
        if mesh is not None:
            raise NotImplementedError(
                "a device mesh (sharded training) is not ported: one card "
                "has none (ROADMAP Queue A 15)")
        self.cfg, self.tcfg, self.mesh = cfg, tcfg, mesh
        self.device = common.resolve_device(device)
        self.model = build(cfg)
        opt_init, opt_update = make_optimizer(
            cfg.optimizer, lr=tcfg.lr, warmup=tcfg.warmup,
            total_steps=max(tcfg.steps, 1))
        n_micro = (tcfg.batch // tcfg.microbatch
                   if tcfg.microbatch else None)
        self._step_fn = make_train_step(self.model, opt_init, opt_update,
                                        n_micro)
        self._opt_init = opt_init
        self.metrics_log: list = []
        self.step_times: list = []      # seconds of every completed step
        self.restarts = 0

    def init_state(self, params: Optional[dict] = None) -> dict:
        """{"params", "opt"}: `params` (default: the model's init from
        the config's seed on the trainer's device) and a fresh
        optimizer state."""
        if params is None:
            params = self.model.init(self.tcfg.seed, self.device)
        return {"params": params, "opt": self._opt_init(params)}

    def run(self, fail_at: Optional[int] = None,
            params: Optional[dict] = None) -> dict:
        """Train; `fail_at` injects one failure (fault-tolerance tests);
        `params` replaces the model's init (the same weights in another
        package or run)."""
        cfg, tcfg = self.cfg, self.tcfg
        pipe = TokenPipeline(cfg.vocab, tcfg.batch, tcfg.seq,
                             seed=tcfg.seed, device=self.device)
        state = self.init_state(params)
        timer = StepTimer()
        hb = (Heartbeat(os.path.join(tcfg.ckpt_dir, "heartbeat"))
              if tcfg.ckpt_dir else None)
        failed = {"done": False}

        def one_step(st, i):
            if fail_at is not None and i == fail_at and not failed["done"]:
                failed["done"] = True
                raise RuntimeError("injected node failure")
            pipe.seek(i)         # step i's batch, after a restore too
            batch = next(pipe)
            params, opt, metrics = self._step_fn(st["params"], st["opt"],
                                                 batch)
            if self.device.type == "cuda":
                # the step's time is its device work's, not its launches'
                torch.cuda.synchronize(self.device)
            if hb:
                hb.beat(i)
            return {"params": params, "opt": opt, "_metrics": metrics}

        def on_step(i, st, dt, straggler):
            self.step_times.append(dt)
            if i % tcfg.log_every == 0 or straggler:
                m = {k: float(v) for k, v in st.get("_metrics", {}).items()}
                m.update(step=i, dt=round(dt, 3), straggler=straggler)
                self.metrics_log.append(m)

        try:
            if tcfg.ckpt_dir:
                runner = FaultTolerantRunner(tcfg.ckpt_dir,
                                             save_every=tcfg.ckpt_every)

                def save_fn(step, st):
                    CK.save_checkpoint(tcfg.ckpt_dir, step,
                                       {"params": st["params"],
                                        "opt": st["opt"]})

                def restore_fn(path, st):
                    step, restored = CK.restore_checkpoint(
                        path, {"params": st["params"], "opt": st["opt"]})
                    restored["_metrics"] = {}
                    return step, restored
                runner.save_fn = save_fn
                runner.restore_fn = restore_fn
                _, state = runner.run(state, one_step, tcfg.steps,
                                      on_step=on_step)
                self.restarts = runner.restarts
            else:
                for i in range(tcfg.steps):
                    timer.start()
                    state = one_step(state, i)
                    dt, s = timer.stop()
                    on_step(i, state, dt, s)
                self.restarts = 0
        finally:
            pipe.close()
            if hb:
                hb.stop()
        return state
