"""The golden training run (`repro_torch.train.golden`): the JAX
package's `make_train_step` at full width, 2 layers, float32, on the
numpy weights, written to `src/repro_torch/golden/granite_moe_train.json`;
`chip_smoke.py` holds the card's run to it within `golden.GRANITE.tol`.

Write it (~2 min on the CPU):

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_train_golden.py --write

The full-width runs are slow (`-m slow`): they regenerate the record
with JAX and hold the port's CPU run to it, which is where the stated
tolerance comes from.  The quick tests check the committed file's shape
against the port's parameter tree.
"""
import dataclasses
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import convert  # noqa: E402
from repro_torch.train import golden as G  # noqa: E402


def jax_golden() -> dict:
    import jax
    import jax.numpy as jnp

    from repro.configs import granite_moe_1b as JC
    from repro.models.registry import build
    from repro.optim.optimizers import make_optimizer
    from repro.train.train_step import _split_micro, make_train_step

    spec = G.GRANITE
    pcfg = G.config()
    cfg = dataclasses.replace(JC.CONFIG, n_layers=spec.n_layers,
                              dtype="float32")
    model = build(cfg)
    params = jax.tree.map(jnp.asarray, convert.numpy_lm_params(pcfg,
                                                               spec.seed))
    opt_init, opt_update = make_optimizer("adamw", lr=spec.lr,
                                          warmup=spec.warmup,
                                          total_steps=spec.steps)
    n_micro = spec.batch // spec.microbatch
    step = jax.jit(make_train_step(model, opt_init, opt_update, n_micro))
    loss = jax.jit(lambda p, b: model.loss(p, b)[1]["aux"])
    opt = opt_init(params)
    steps, batches = [], []
    for b in G.pipeline_batches("cpu"):
        batches.append({k: v.numpy().tolist() for k, v in b.items()})
        batch = {k: jnp.asarray(v.numpy()) for k, v in b.items()}
        micro = _split_micro(batch, n_micro)
        aux = sum(float(loss(params, jax.tree.map(lambda x: x[i], micro)))
                  for i in range(n_micro)) / n_micro
        params, opt, m = step(params, opt, batch)
        steps.append({"loss": float(m["loss"]), "aux": aux,
                      "gnorm": float(m["gnorm"])})
    norms = G.leaf_norms(jax.tree.map(np.asarray, params))
    return {"config": {"arch": pcfg.name, "n_layers": spec.n_layers,
                       "dtype": "float32", "seed": spec.seed,
                       "batch": spec.batch, "seq": spec.seq,
                       "microbatch": spec.microbatch, "steps": spec.steps,
                       "optimizer": "adamw", "lr": spec.lr,
                       "warmup": spec.warmup, "reduced": spec.reduced},
            "steps": steps, "norms": norms, "batches": batches}


def test_golden_file_matches_the_port_tree():
    doc = G.load()
    assert len(doc["steps"]) == G.GRANITE.steps
    assert doc["config"]["n_layers"] == G.GRANITE.n_layers
    assert doc["config"]["batch"] == G.GRANITE.batch
    tree = convert.numpy_lm_params(
        dataclasses.replace(G.config(), d_model=64, n_heads=4, n_kv_heads=2,
                            head_dim=16, vocab=512, d_ff=64), 0)
    assert set(doc["norms"]) == set(G.leaf_norms(tree))
    got = G.batches(doc, "cpu")
    assert len(got) == G.GRANITE.steps
    for b in got:
        assert b["tokens"].shape == (G.GRANITE.batch, G.GRANITE.seq)
        assert torch.equal(b["tokens"][:, 1:], b["labels"][:, :-1])
    for s in doc["steps"]:
        assert all(np.isfinite(s[k]) for k in ("loss", "aux", "gnorm"))


def test_golden_losses_fall_and_norms_are_finite():
    doc = G.load()
    losses = [s["loss"] for s in doc["steps"]]
    assert losses[-1] < losses[0]
    assert all(np.isfinite(v) and v > 0 for v in doc["norms"].values())


@pytest.mark.slow
def test_port_cpu_run_holds_the_golden():
    doc = G.load()
    rec = G.run("cpu", G.batches(doc, "cpu"))
    assert max(G.compare(doc, rec).values()) < G.GRANITE.tol / 10
    assert max(G.compare(jax_golden(), G.run("cpu")).values()) \
        < G.GRANITE.tol / 10


if __name__ == "__main__":
    import json
    if "--write" in sys.argv:
        doc = jax_golden()
        G.GRANITE.path.write_text(json.dumps(doc, indent=1) + "\n")
        print(f"wrote {G.GRANITE.path}")
    if "--gap" in sys.argv:
        torch.set_num_threads(8)
        doc = G.load()
        print(G.compare(doc, G.run("cpu", G.batches(doc, "cpu"))))
