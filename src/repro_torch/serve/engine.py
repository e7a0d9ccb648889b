"""Batched serving engine: prefill + greedy decode with ragged lengths and
slot-based continuous batching (`repro.serve.engine`).

`Engine.generate` is the JAX engine's slot loop line for line: every
free slot is refilled from the queue (one B=1 prefill each) before the
next decode trip, and a finished slot frees without draining the others.
The JAX engine vmaps a B=1 decode step over the slots; here the slots
are the batch axis of one decode step over caches [L, slots, Hkv, S, D],
with one MoE dispatch group per slot (`moe_groups=slots`), so every
slot packs its own expert capacity as under the vmap and a slot's tokens
do not depend on its neighbours.  Greedy argmax takes the first index on
ties, as `jnp.argmax` does.
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional

import numpy as np
import torch

from repro_torch.models.registry import Model


def insert(stacked, cache, i: int) -> None:
    """Write a B=1 cache (grown to the engine's max_len) into slot i of
    the stacked slot caches, in place."""
    for (sk, sv), (ck, cv) in zip(stacked, cache):
        sk[:, i] = ck[:, 0]
        sv[:, i] = cv[:, 0]


@dataclasses.dataclass
class Request:
    prompt: np.ndarray            # [S] int32
    max_new_tokens: int = 16
    out: Optional[np.ndarray] = None


class Engine:
    """Fixed-slot continuous-batching engine on the parameters' device."""

    def __init__(self, model: Model, params: dict, *, max_len: int = 512,
                 slots: int = 4, eos: int = -1):
        self.model, self.params = model, params
        self.max_len, self.slots, self.eos = max_len, slots, eos
        self.device = params["emb"].device

    def _prefill_one(self, prompt: np.ndarray):
        tokens = torch.as_tensor(np.asarray(prompt, np.int64)[None],
                                 device=self.device)
        logits, cache = self.model.prefill(self.params, {"tokens": tokens})
        return logits, self.model.grow_cache(cache, self.max_len)

    @torch.no_grad()
    def generate(self, requests: List[Request]) -> List[Request]:
        """Greedy generation with slot-based continuous batching."""
        queue = list(range(len(requests)))
        req = [None] * self.slots      # request index occupying each slot
        toks: List[Optional[list]] = [None] * self.slots
        left = np.zeros(self.slots, np.int64)    # new tokens still allowed
        kv = np.ones(self.slots, np.int64)       # kv_len per slot
        cur = np.zeros(self.slots, np.int64)     # last sampled token
        stacked = self.model.init_cache(self.slots, self.max_len,
                                        self.device)

        def finish(i):
            requests[req[i]].out = np.asarray(toks[i], np.int32)
            req[i] = None

        while True:
            # refill every free slot before the next batched decode trip
            for i in range(self.slots):
                while req[i] is None and queue:
                    r = requests[queue[0]]
                    logits, cache = self._prefill_one(r.prompt)
                    req[i], toks[i] = queue.pop(0), [int(logits[0].argmax())]
                    kv[i], cur[i] = len(r.prompt), toks[i][0]
                    left[i] = r.max_new_tokens - 1
                    if left[i] <= 0 or cur[i] == self.eos \
                            or kv[i] >= self.max_len:
                        finish(i)           # done at prefill; slot frees
                        continue
                    insert(stacked, cache, i)
            live = [i for i in range(self.slots) if req[i] is not None]
            if not live:
                break
            t = torch.as_tensor(cur[:, None], device=self.device)
            kl = torch.as_tensor(np.clip(kv, 1, self.max_len - 1),
                                 dtype=torch.int32, device=self.device)
            logits, stacked = self.model.decode_step(
                self.params, stacked, t, kl, moe_groups=self.slots)
            nxt = logits.argmax(-1).cpu().numpy()
            for i in live:
                toks[i].append(int(nxt[i]))
                cur[i], kv[i], left[i] = nxt[i], kv[i] + 1, left[i] - 1
                if left[i] <= 0 or cur[i] == self.eos \
                        or kv[i] >= self.max_len:
                    finish(i)
        return requests


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@torch.no_grad()
def throughput_bench(model: Model, params: dict, batch: int, seq: int,
                     new_tokens: int = 8) -> dict:
    """Batched prefill + greedy decode, host-clock timed on the
    parameters' device (each phase ends in a synchronise)."""
    device = params["emb"].device
    rng = np.random.default_rng(0)
    tokens = torch.as_tensor(rng.integers(0, model.cfg.vocab, (batch, seq)),
                             device=device)
    _sync(device)
    t0 = time.perf_counter()
    logits, cache = model.prefill(params, {"tokens": tokens})
    cache = model.grow_cache(cache, seq + new_tokens)
    _sync(device)
    t_prefill = time.perf_counter() - t0
    kv_len = torch.full((batch,), seq, dtype=torch.int32, device=device)
    tok = logits.argmax(-1)[:, None]
    t0 = time.perf_counter()
    for i in range(new_tokens):
        logits, cache = model.decode_step(params, cache, tok, kv_len + i)
        tok = logits.argmax(-1)[:, None]
    _sync(device)
    t_decode = time.perf_counter() - t0
    return {"prefill_s": t_prefill, "decode_s_per_tok": t_decode / new_tokens,
            "decode_tok_s": batch * new_tokens / t_decode,
            "device": str(device)}
