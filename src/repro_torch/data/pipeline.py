"""Synthetic token pipeline with host-side prefetch
(`repro.data.pipeline`).

Deterministic per-step batches: step s draws from
`np.random.default_rng(seed * 100003 + s)` a zipf(1.3) marginal over the
vocabulary, with every seventh token copied from the one before it (a
bigram structure a model can learn), exactly as the JAX package does,
so both packages see the same tokens bit for bit.  A background thread
keeps `prefetch` batches ready; each is handed over as int32 tensors
(extras float32) on the pipeline's device (`cuda` unless named).  One
card has no mesh, so no batch sharding.

`seek(step)` makes the next batch step `step`'s (the prefetch thread
restarts there when it is elsewhere): the trainer asks for step i's
batch at step i, so a run restored from a checkpoint sees the batches
the uninterrupted run saw.
"""
from __future__ import annotations

import queue
import threading
from typing import Iterator, Optional

import numpy as np
import torch

from repro_torch.kernels import common


class TokenPipeline:
    def __init__(self, vocab: int, batch: int, seq: int, seed: int = 0,
                 extras: Optional[dict] = None, prefetch: int = 2,
                 device=None):
        self.vocab, self.batch, self.seq = vocab, batch, seq
        self.seed = seed
        self.extras = extras or {}
        self.device = common.resolve_device(device)
        self._prefetch = prefetch
        self._start(0)

    def _start(self, step: int) -> None:
        self._next = step
        self._q: queue.Queue = queue.Queue(maxsize=self._prefetch)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker,
                                        args=(step, self._q, self._stop),
                                        daemon=True)
        self._thread.start()

    def _make(self, step: int) -> dict:
        rng = np.random.default_rng(self.seed * 100003 + step)
        # zipf-ish marginal: heavy head, long tail
        z = rng.zipf(1.3, size=(self.batch, self.seq + 1))
        tokens = np.minimum(z - 1, self.vocab - 1).astype(np.int32)
        # local structure (bigram repeats) so models can learn
        tokens[:, 1::7] = tokens[:, 0:-1:7]
        out = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}
        for name, shape in self.extras.items():
            out[name] = rng.normal(size=(self.batch, *shape)).astype(
                np.float32)
        return out

    def _worker(self, step: int, q: queue.Queue, stop: threading.Event):
        batch = None
        while not stop.is_set():
            if batch is None:
                batch = (step, self._make(step))
            try:
                q.put(batch, timeout=0.5)
            except queue.Full:
                continue
            batch = None
            step += 1

    def __iter__(self) -> Iterator[dict]:
        return self

    def __next__(self) -> dict:
        step, host = self._q.get()
        self._next = step + 1
        return {k: torch.from_numpy(np.ascontiguousarray(x)).to(self.device)
                for k, x in host.items()}

    def seek(self, step: int) -> None:
        """Make the next batch step `step`'s."""
        if step != self._next:
            self.close()
            self._start(step)

    def close(self):
        self._stop.set()
        self._thread.join()
