"""Fault tolerance and straggler detection (`repro.runtime.fault`).

* `StepTimer` — rolling step-time statistics; flags a straggler step
  when its z-score over the window exceeds a threshold.
* `FaultTolerantRunner` — wraps a step callable: on a failure it
  restores the latest checkpoint and goes on, up to `max_restarts`.
* `Heartbeat` — a liveness file that other processes can watch.
"""
from __future__ import annotations

import os
import time
from collections import deque
from typing import Callable, Optional

from repro_torch.runtime import checkpoint as CK


class StepTimer:
    def __init__(self, window: int = 50, z_thresh: float = 3.0):
        self.window = deque(maxlen=window)
        self.z_thresh = z_thresh
        self.stragglers = 0
        self._t0: Optional[float] = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self) -> tuple[float, bool]:
        dt = time.perf_counter() - self._t0
        is_straggler = False
        if len(self.window) >= 10:
            mean = sum(self.window) / len(self.window)
            var = sum((x - mean) ** 2 for x in self.window) / len(self.window)
            std = max(var ** 0.5, 1e-9)
            if (dt - mean) / std > self.z_thresh:
                is_straggler = True
                self.stragglers += 1
        self.window.append(dt)
        return dt, is_straggler


class Heartbeat:
    """Liveness file other processes can watch.

    Callers that share a machine must use a per-process path (the sweep
    derives one from the pid in the temporary directory): a fixed name
    aliases concurrent runs.  They must `stop()` when done, so that a
    stale file never stands for a live process."""

    def __init__(self, path: str, interval: float = 10.0):
        self.path = path
        self.interval = interval
        self._last = 0.0

    def beat(self, step: int):
        now = time.time()
        if now - self._last >= self.interval:
            with open(self.path, "w") as f:
                f.write(f"{step} {now}\n")
            self._last = now

    def stop(self):
        """Remove the liveness file (idempotent)."""
        self._last = 0.0
        try:
            os.remove(self.path)
        except OSError:
            pass


class FaultTolerantRunner:
    """run(state, step_fn, n_steps) where step_fn(state, step) -> state.
    Saves every `save_every` steps; on an exception restores the latest
    checkpoint (or the initial state when none exists) and goes on."""

    def __init__(self, ckpt_dir: str, save_every: int = 100,
                 max_restarts: int = 3, restore_fn: Callable = None,
                 save_fn: Callable = None):
        self.ckpt_dir = ckpt_dir
        self.save_every = save_every
        self.max_restarts = max_restarts
        self.restore_fn = restore_fn or (
            lambda path, state: CK.restore_checkpoint(path, state))
        self.save_fn = save_fn or (
            lambda step, state: CK.save_checkpoint(self.ckpt_dir, step, state))
        self.restarts = 0

    def run(self, state, step_fn: Callable, n_steps: int, start_step: int = 0,
            on_step: Callable = None):
        os.makedirs(self.ckpt_dir, exist_ok=True)
        step = start_step
        timer = StepTimer()
        while step < n_steps:
            try:
                timer.start()
                state = step_fn(state, step)
                dt, straggler = timer.stop()
                if on_step:
                    on_step(step, state, dt, straggler)
                step += 1
                if step % self.save_every == 0:
                    self.save_fn(step, state)
            except KeyboardInterrupt:
                raise
            except Exception as e:  # noqa: BLE001 — a failed step
                self.restarts += 1
                if self.restarts > self.max_restarts:
                    raise RuntimeError(
                        f"exceeded max_restarts={self.max_restarts}") from e
                latest = CK.latest_checkpoint(self.ckpt_dir)
                if latest is None:
                    # nothing saved yet: restart from the initial state
                    step = start_step
                    continue
                step, state = self.restore_fn(latest, state)
        return step, state
