"""The golden training run of granite-moe-1b-a400m, shared by the CPU
test (`tests/test_torch_train_golden.py`, which also writes the file
from the JAX package) and `chip_smoke.py` (which holds the card's run to
it).

`golden/granite_moe_train.json` holds, for the JAX package's
`make_train_step` at the golden config (full width, depth cut to 2
layers, float32, weights `convert.numpy_lm_params(cfg, seed=0)`), on
`TokenPipeline` seed 0 batches of 2 x 64 tokens in microbatches of 1
(n_micro 2), AdamW (`make_optimizer("adamw", lr=LR, warmup=WARMUP,
total_steps=STEPS)`), STEPS steps: each step's `loss` and `gnorm` (the
train step's metrics) and `aux` (the mean over the step's microbatches
of `lm_loss`'s aux metric at the step's starting parameters), the
norm of every parameter leaf after the last step, and the steps'
batches (`batches`: tokens and labels).  A run held to the file trains
on those batches: numpy's zipf draws differ between numpy versions (the
card's machine drew a few other tokens from the same seeds), so
`TokenPipeline` is bitwise the reference's only under one numpy.
"""
from __future__ import annotations

import dataclasses
import json
import pathlib

import numpy as np
import torch

from repro_torch.configs import granite_moe_1b

PATH = pathlib.Path(__file__).resolve().parents[1] / "golden" \
    / "granite_moe_train.json"
N_LAYERS = 2
SEED = 0
BATCH = 2
SEQ = 64
MICROBATCH = 1
STEPS = 3
LR = 1e-3
WARMUP = 1
# the relative difference (`compare`) allowed between a run of the port
# and the golden.  The port's CPU run measured 6.4e-8 (loss), 1.12e-6
# (aux), 1.52e-6 (gnorm) and 9.8e-9 (leaf norms) from the JAX run
# (tests/test_torch_train_golden.py --gap); the card's kernels and
# cuBLAS sum in other orders, and the aux term moves with any routing
# flip at a near tie, so about 60 times the largest CPU gap
TOL = 1e-4
REDUCED = [f"n_layers 24 -> {N_LAYERS}", "dtype bfloat16 -> float32",
           f"batch {BATCH} x seq {SEQ}, {STEPS} steps"]


def config():
    """granite-moe-1b-a400m at full width, the golden's cuts applied."""
    return dataclasses.replace(granite_moe_1b.CONFIG, n_layers=N_LAYERS,
                               dtype="float32")


def load(path=PATH) -> dict:
    with open(path) as f:
        return json.load(f)


def leaf_norms(params: dict, prefix: str = "") -> dict:
    """{"a/b": float64 norm} of every leaf, keys in sorted order."""
    out = {}
    for k in sorted(params):
        v = params[k]
        if isinstance(v, dict):
            out.update(leaf_norms(v, f"{prefix}{k}/"))
        else:
            a = v.detach().cpu().double().numpy() \
                if isinstance(v, torch.Tensor) else np.asarray(v, np.float64)
            out[prefix + k] = float(np.linalg.norm(a.reshape(-1)))
    return out


def batches(doc: dict, device) -> list:
    """The golden's batches as int32 tensors on `device`."""
    return [{k: torch.tensor(v, dtype=torch.int32, device=device)
             for k, v in b.items()} for b in doc["batches"]]


def pipeline_batches(device) -> list:
    """The golden's STEPS batches as `TokenPipeline` draws them here."""
    from repro_torch.data.pipeline import TokenPipeline
    pipe = TokenPipeline(config().vocab, BATCH, SEQ, seed=SEED,
                         device=device)
    try:
        return [next(pipe) for _ in range(STEPS)]
    finally:
        pipe.close()


def run(device, steps_batches=None) -> dict:
    """The port's golden run on `device`, on `steps_batches` (default:
    `pipeline_batches`): {"steps": [{loss, aux, gnorm}], "norms": leaf
    norms after the last step, "params": the final parameters}."""
    from repro_torch import convert
    from repro_torch.models.registry import build
    from repro_torch.optim import make_optimizer
    from repro_torch.train.train_step import _split_micro, make_train_step

    cfg = config()
    model = build(cfg)
    params = convert.lm_params_to_torch(convert.numpy_lm_params(cfg, SEED),
                                        device)
    opt_init, opt_update = make_optimizer("adamw", lr=LR, warmup=WARMUP,
                                          total_steps=STEPS)
    n_micro = BATCH // MICROBATCH
    step_fn = make_train_step(model, opt_init, opt_update, n_micro)
    opt = opt_init(params)
    steps = []
    for batch in steps_batches or pipeline_batches(device):
        with torch.no_grad():
            aux = sum(float(model.loss(params, mb)[1]["aux"])
                      for mb in _split_micro(batch, n_micro)) / n_micro
        params, opt, m = step_fn(params, opt, batch)
        steps.append({"loss": float(m["loss"]), "aux": aux,
                      "gnorm": float(m["gnorm"])})
    return {"steps": steps, "norms": leaf_norms(params), "params": params}


def compare(golden: dict, rec: dict) -> dict:
    """The largest relative difference of the port's run `rec` from the
    golden, per quantity: max |port - golden| / max(|golden|, 1e-30)
    over the steps (loss, aux, gnorm) and over the leaves (norms)."""
    def rel(a, b):
        return abs(a - b) / max(abs(b), 1e-30)
    out = {key: max(rel(s[key], g[key]) for s, g in zip(rec["steps"],
                                                        golden["steps"]))
           for key in ("loss", "aux", "gnorm")}
    if set(rec["norms"]) != set(golden["norms"]):
        raise AssertionError(f"leaves differ: {sorted(rec['norms'])} vs "
                             f"{sorted(golden['norms'])}")
    out["norms"] = max(rel(rec["norms"][k], v)
                       for k, v in golden["norms"].items())
    return out
