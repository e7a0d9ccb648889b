"""The golden training runs, shared by the CPU tests (which also write
the files from the JAX package: `tests/test_torch_train_golden.py` for
granite-moe-1b-a400m, `tests/test_torch_dense_train_golden.py` for
mistral-large-123b) and `chip_smoke.py` (which holds the card's runs to
them).  A `Spec` names the config and its cuts; `GRANITE` and
`MISTRAL_LARGE` are the two, and the functions take granite's unless
given another.

A golden file holds, for the JAX package's `make_train_step` at the
spec's config (full width, depth cut to `n_layers`, float32, weights
`convert.numpy_lm_params(cfg, seed)`), on `TokenPipeline` seed `seed`
batches of `batch` x `seq` tokens in microbatches of `microbatch`, the
spec's optimizer (`make_optimizer(optimizer, lr=lr, warmup=warmup,
total_steps=steps)`), `steps` steps: each step's `loss` and `gnorm` (the
train step's metrics) and `aux` (the mean over the step's microbatches
of `lm_loss`'s aux metric at the step's starting parameters), the norm
of every parameter leaf after the last step, and the steps' batches
(`batches`: tokens and labels).  A run held to the file trains on those
batches: numpy's zipf draws differ between numpy versions (the card's
machine drew a few other tokens from the same seeds), so `TokenPipeline`
is bitwise the reference's only under one numpy.

* `GRANITE` (`golden/granite_moe_train.json`): 2 layers, 2 x 64 tokens
  in microbatches of 1, AdamW, 3 steps.
* `MISTRAL_LARGE` (`golden/mistral_large_train.json`): the widest dense
  config (d 12288, 96/8 heads: the float32 backward at GQA group 12) at
  1 layer (2.19 B parameters, 8.8 GB a float32 copy), 2 x 64
  tokens in one microbatch, Adafactor (its factored statistics keep the
  JAX run that writes the file within a CPU host's memory), 3 steps.
"""
from __future__ import annotations

import dataclasses
import json
import pathlib

import numpy as np
import torch

GOLDEN = pathlib.Path(__file__).resolve().parents[1] / "golden"


@dataclasses.dataclass(frozen=True)
class Spec:
    """One golden training run: config `arch` at full width, cut to
    `n_layers` layers (of `full_layers`) and float32."""
    arch: str
    path: pathlib.Path
    n_layers: int
    full_layers: int
    batch: int
    seq: int
    microbatch: int
    steps: int
    optimizer: str
    # the relative difference (`compare`) allowed between a run of the
    # port and the golden
    tol: float
    seed: int = 0
    lr: float = 1e-3
    warmup: int = 1

    @property
    def reduced(self) -> list:
        return [f"n_layers {self.full_layers} -> {self.n_layers}",
                "dtype bfloat16 -> float32",
                f"batch {self.batch} x seq {self.seq}, {self.steps} steps"]

    @property
    def n_micro(self) -> int:
        return self.batch // self.microbatch


# The port's CPU run measured 6.4e-8 (loss), 1.12e-6 (aux), 1.52e-6
# (gnorm) and 9.8e-9 (leaf norms) from the JAX run
# (tests/test_torch_train_golden.py --gap); the card's kernels and
# cuBLAS sum in other orders, and the aux term moves with any routing
# flip at a near tie, so about 60 times the largest CPU gap
GRANITE = Spec("granite-moe-1b-a400m", GOLDEN / "granite_moe_train.json",
               n_layers=2, full_layers=24, batch=2, seq=64, microbatch=1,
               steps=3, optimizer="adamw", tol=1e-4)
# The port's CPU run measured 1.02e-7 (loss), 8.56e-7 (gnorm) and 9.7e-12
# (leaf norms) from the JAX run, aux 0 in both
# (tests/test_torch_dense_train_golden.py --gap); the card sums in other
# orders (cuBLAS, the attention kernels), so about 60 times the largest
# CPU gap, as granite's.  Adafactor's steps are about lr an element
# whatever the gradient's size, and at d 12288 a step of 1e-4 moved the
# MLP's pre-activations by ~1 and the loss up (10.7 -> 20.0 -> 22.1 in
# the JAX run): lr 1e-5 gives 10.7 -> 7.7 -> 9.3
MISTRAL_LARGE = Spec("mistral-large-123b",
                     GOLDEN / "mistral_large_train.json", n_layers=1,
                     full_layers=88, batch=2, seq=64, microbatch=2,
                     steps=3, optimizer="adafactor", tol=5e-5, lr=1e-5)


def config(spec: Spec = GRANITE):
    """The spec's config at full width, the golden's cuts applied."""
    from repro_torch.models.registry import get_config
    return dataclasses.replace(get_config(spec.arch),
                               n_layers=spec.n_layers, dtype="float32")


def load(path=GRANITE.path) -> dict:
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


def pipeline_batches(device, spec: Spec = GRANITE) -> list:
    """The golden's steps' batches as `TokenPipeline` draws them here."""
    from repro_torch.data.pipeline import TokenPipeline
    pipe = TokenPipeline(config(spec).vocab, spec.batch, spec.seq,
                         seed=spec.seed, device=device)
    try:
        return [next(pipe) for _ in range(spec.steps)]
    finally:
        pipe.close()


def run(device, steps_batches=None, spec: Spec = GRANITE,
        params=None) -> dict:
    """The port's golden run on `device`, on `steps_batches` (default:
    `pipeline_batches`) from `params` (default: the spec's numpy weights
    on `device`): {"steps": [{loss, aux, gnorm}], "norms": leaf norms
    after the last step, "params": the final parameters}."""
    from repro_torch import convert
    from repro_torch.models.registry import build
    from repro_torch.optim import make_optimizer
    from repro_torch.train.train_step import _split_micro, make_train_step

    cfg = config(spec)
    model = build(cfg)
    if params is None:
        params = convert.lm_params_to_torch(
            convert.numpy_lm_params(cfg, spec.seed), device)
    opt_init, opt_update = make_optimizer(spec.optimizer, lr=spec.lr,
                                          warmup=spec.warmup,
                                          total_steps=spec.steps)
    n_micro = spec.n_micro
    step_fn = make_train_step(model, opt_init, opt_update, n_micro)
    opt = opt_init(params)
    steps = []
    for batch in steps_batches or pipeline_batches(device, spec):
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
