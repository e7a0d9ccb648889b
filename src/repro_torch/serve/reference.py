"""The serial reference of the serving engine: one request at a time
through B=1 prefill and B=1 decode steps, and the comparison of an
engine's tokens with it under a top-1/top-2 margin.

The engine batches slots on the batch axis; in bfloat16 a batched
product and a B=1 product round differently, so two exact runs can
differ where the serial run's top-1/top-2 logit margin is within that
rounding.  `divergence` accepts a difference only there.
"""
from __future__ import annotations

import numpy as np
import torch


@torch.no_grad()
def serial_generate(model, params, prompt, max_new_tokens: int,
                    max_len: int):
    """Greedy tokens of one request alone, and the top-1/top-2 logit
    margin at each of its steps (float64 numpy)."""
    device = params["emb"].device
    t = torch.as_tensor(np.asarray(prompt, np.int64)[None], device=device)
    logits, cache = model.prefill(params, {"tokens": t})
    cache = model.grow_cache(cache, max_len)
    toks, margins = [], []
    kv = len(prompt)
    while True:
        top2 = logits[0].float().topk(2).values.double().cpu().numpy()
        toks.append(int(logits[0].argmax()))
        margins.append(float(top2[0] - top2[1]))
        if len(toks) >= max_new_tokens or kv >= max_len:
            return toks, margins
        logits, cache = model.decode_step(
            params, cache, torch.tensor([[toks[-1]]], device=device),
            torch.tensor([kv], dtype=torch.int32, device=device))
        kv += 1


def divergence(engine_toks, serial_toks, margins, tol: float):
    """Where an engine's tokens leave the serial run's: None when they
    are equal, else (step, serial margin there, allowed), where allowed
    means the margin is within `tol`.  Tokens after the first difference
    follow another prefix and are not compared."""
    for j, (a, b) in enumerate(zip(engine_toks, serial_toks)):
        if a != b:
            return j, margins[j], margins[j] <= tol
    if len(engine_toks) != len(serial_toks):
        return min(len(engine_toks), len(serial_toks)), None, False
    return None
