"""The golden serving runs of granite-moe-1b-a400m and qwen2.5-32b,
shared by the CPU tests (`tests/test_torch_serve_golden.py` and
`tests/test_torch_dense_golden.py`, which also write the files from the
JAX package) and `chip_smoke.py` (which holds the card's runs to them).

`golden/granite_moe_serve.json` (`PATH`) and `golden/qwen2_5_serve.json`
(`QWEN_PATH`) hold, for the JAX package's `Engine` at the golden config
(the model's CONFIG at full width, depth cut to 2 layers, float32,
weights `convert.numpy_lm_params(cfg, seed=0)`, 3 slots): each request's
prompt, its greedy tokens, and for each of its steps the top-5 logits
(values and indices) of the teacher-forced path, i.e. a B=1 prefill of
the prompt and then one decode step per greedy token fed back.  Both use
the same prompt lengths and prompt seed, drawn over each model's vocab.
The functions take the model's full CONFIG as `base`, granite's unless
named.
"""
from __future__ import annotations

import dataclasses
import json
import pathlib

import numpy as np
import torch

from repro_torch.configs import granite_moe_1b

PATH = pathlib.Path(__file__).resolve().parents[1] / "golden" \
    / "granite_moe_serve.json"
QWEN_PATH = PATH.with_name("qwen2_5_serve.json")
N_LAYERS = 2
SEED = 0
MAX_LEN = 64
SLOTS = 3
NEW_TOKENS = 8
PROMPT_LENS = (17, 5, 40, 23, 9)   # 17 and 40: prefill MoE groups that drop
PROMPT_SEED = 12
TOPK = 5


def reduced(base=None) -> list:
    """The golden's cuts of `base` (granite's CONFIG unless named)."""
    base = base or granite_moe_1b.CONFIG
    return [f"n_layers {base.n_layers} -> {N_LAYERS}",
            f"dtype {base.dtype} -> float32"]


REDUCED = reduced()


def config(base=None):
    """`base` (granite-moe-1b-a400m's CONFIG unless named) at full width,
    the golden's cuts applied."""
    return dataclasses.replace(base or granite_moe_1b.CONFIG,
                               n_layers=N_LAYERS, dtype="float32")


def prompts(vocab: int) -> list:
    rng = np.random.default_rng(PROMPT_SEED)
    return [rng.integers(0, vocab, (n,)).astype(np.int32)
            for n in PROMPT_LENS]


def load(path=PATH) -> dict:
    with open(path) as f:
        return json.load(f)


def top(logits: np.ndarray, k: int = TOPK):
    """(values, indices) of the k largest logits, ties to the lower index."""
    idx = np.argsort(-logits, kind="stable")[:k]
    return logits[idx], idx


@torch.no_grad()
def teacher_forced(model, params, prompt, tokens) -> list:
    """The port's logits [V] (float32 numpy) at each step: a B=1 prefill
    of `prompt`, then one decode step for each of tokens[:-1]."""
    device = params["emb"].device
    t = torch.as_tensor(np.asarray(prompt, np.int64)[None], device=device)
    logits, cache = model.prefill(params, {"tokens": t})
    cache = model.grow_cache(cache, MAX_LEN)
    out = [logits[0].float().cpu().numpy()]
    for j, tok in enumerate(tokens[:-1]):
        kv = torch.tensor([len(prompt) + j], dtype=torch.int32,
                          device=device)
        tok = torch.tensor([[tok]], device=device)
        logits, cache = model.decode_step(params, cache, tok, kv)
        out.append(logits[0].float().cpu().numpy())
    return out


def compare(golden: dict, logits_per_request: list, tol: float) -> dict:
    """Hold the port's teacher-forced logits to the golden file.

    Per step: the port's logits at the golden's top-5 indices are within
    `tol` of the golden's values, and the port's argmax is the golden's
    greedy token wherever the golden's top-1/top-2 margin exceeds
    2 * tol.  Returns {max_abs_err, steps, near_ties, mismatches}, with
    mismatches listed as (request, step)."""
    err, near, bad, steps = 0.0, 0, [], 0
    for r, (req, per_step) in enumerate(zip(golden["requests"],
                                            logits_per_request)):
        for j, logits in enumerate(per_step):
            vals = np.asarray(req["top5_values"][j], np.float64)
            idx = np.asarray(req["top5_indices"][j])
            err = max(err, float(np.abs(logits[idx] - vals).max()))
            steps += 1
            if vals[0] - vals[1] <= 2 * tol:
                near += 1
            elif int(np.argmax(logits)) != req["tokens"][j]:
                bad.append((r, j))
    return {"max_abs_err": err, "steps": steps, "near_ties": near,
            "mismatches": bad}
