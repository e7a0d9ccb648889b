"""The port's `Trainer` and training driver on the CPU, at
granite-moe-1b-a400m's SMOKE config.

* the trainer's loss and gnorm log against the JAX package's
  `make_train_step` loop on the same weights and batches;
* the twin of tests/test_runtime.py's fault-tolerant restart: a failure
  after a checkpoint restarts once, and the run ends on the
  uninterrupted run's parameters bit for bit (the port's trainer takes
  step i's batch at step i, also after a restore);
* a trainer checkpoint restores in the JAX package's
  `restore_checkpoint`, and a JAX train state in the port's;
* `python -m repro_torch.launch.train` and what it does not take.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import granite_moe_1b as JC
from repro.models.registry import build as jax_build
from repro.optim import make_optimizer as jax_optimizer
from repro.runtime import checkpoint as JCK
from repro.train.train_step import make_train_step as jax_train_step
from repro_torch import convert
from repro_torch.configs import granite_moe_1b
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.launch import train as launch
from repro_torch.runtime import checkpoint as CK
from repro_torch.train.trainer import TrainConfig, Trainer

CFG = granite_moe_1b.SMOKE


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, tree


def _jax_run(weights, tcfg, steps):
    """The reference's loop: its make_train_step on the pipeline's
    batches, the trainer's optimizer; (losses, gnorms, params, opt)."""
    opt_init, opt_update = jax_optimizer(JC.SMOKE.optimizer, lr=tcfg.lr,
                                         warmup=tcfg.warmup,
                                         total_steps=tcfg.steps)
    n_micro = tcfg.batch // tcfg.microbatch if tcfg.microbatch else None
    step = jax.jit(jax_train_step(jax_build(JC.SMOKE), opt_init,
                                  opt_update, n_micro))
    params = jax.tree.map(jnp.asarray, weights)
    opt = opt_init(params)
    pipe = TokenPipeline(CFG.vocab, tcfg.batch, tcfg.seq, seed=tcfg.seed,
                         device="cpu")
    losses, gnorms = [], []
    try:
        for _ in range(steps):
            batch = {k: jnp.asarray(v.numpy()) for k, v in next(pipe).items()}
            params, opt, m = step(params, opt, batch)
            losses.append(float(m["loss"]))
            gnorms.append(float(m["gnorm"]))
    finally:
        pipe.close()
    return losses, gnorms, params, opt


@pytest.mark.parametrize("microbatch", [None, 2])
def test_trainer_log_matches_the_reference_loop(microbatch):
    weights = convert.numpy_lm_params(CFG, seed=1)
    tcfg = TrainConfig(steps=3, batch=4, seq=32, lr=1e-3, warmup=1,
                       log_every=1, microbatch=microbatch)
    tr = Trainer(CFG, tcfg, device="cpu")
    tr.run(params=convert.lm_params_to_torch(weights, "cpu"))
    losses, gnorms, _, _ = _jax_run(weights, tcfg, 3)
    assert [m["step"] for m in tr.metrics_log] == [0, 1, 2]
    assert len(tr.step_times) == 3 and tr.restarts == 0
    for m, loss, gnorm in zip(tr.metrics_log, losses, gnorms):
        assert abs(m["loss"] - loss) <= 1e-5 * abs(loss)
        assert abs(m["gnorm"] - gnorm) <= 1e-5 * abs(gnorm)


def test_fault_tolerant_restart_ends_on_the_uninterrupted_params(tmp_path):
    """tests/test_runtime.py's restart cell (granite SMOKE, 12 steps,
    batch 2 x 32, a checkpoint every 5 steps, a failure at step 8)."""
    base = dict(steps=12, batch=2, seq=32, ckpt_every=5, log_every=1)
    tr = Trainer(CFG, TrainConfig(ckpt_dir=str(tmp_path), **base),
                 device="cpu")
    state = tr.run(fail_at=8)       # dies after the step-5 checkpoint
    assert tr.restarts == 1
    assert max(m["step"] for m in tr.metrics_log) == 11
    assert not (tmp_path / "heartbeat").exists()
    plain = Trainer(CFG, TrainConfig(**base), device="cpu")
    want = plain.run()
    for (p, a), (_, b) in zip(_leaves(state["params"]),
                              _leaves(want["params"])):
        assert torch.equal(a, b), p
    assert torch.equal(state["opt"]["step"], want["opt"]["step"])
    logged = {m["step"]: m["loss"] for m in tr.metrics_log}
    assert [logged[i] for i in range(12)] == \
        [m["loss"] for m in plain.metrics_log]


def test_trainer_checkpoint_restores_in_jax_and_back(tmp_path):
    weights = convert.numpy_lm_params(CFG, seed=2)
    tcfg = TrainConfig(steps=2, batch=2, seq=16, lr=1e-3, warmup=1,
                       ckpt_dir=str(tmp_path / "port"), ckpt_every=2)
    state = Trainer(CFG, tcfg, device="cpu").run(
        params=convert.lm_params_to_torch(weights, "cpu"))
    _, _, jparams, jopt = _jax_run(weights, tcfg, 2)
    like = {"params": jparams, "opt": jopt}
    step, restored = JCK.restore_checkpoint(
        CK.latest_checkpoint(str(tmp_path / "port")), like)
    assert step == 2
    port = dict(_leaves({"params": state["params"], "opt": state["opt"]}))
    for path, leaf in _leaves(jax.tree.map(np.asarray, restored)):
        np.testing.assert_array_equal(leaf, port[path].numpy())
        assert leaf.dtype == port[path].numpy().dtype
    # the reference's state, written by the JAX package, in the port
    JCK.save_checkpoint(str(tmp_path / "jax"), 2, like)
    step, back = CK.restore_checkpoint(
        CK.latest_checkpoint(str(tmp_path / "jax")),
        {"params": state["params"], "opt": state["opt"]})
    ref = dict(_leaves(jax.tree.map(np.asarray, like)))
    for path, leaf in _leaves(back):
        assert leaf.dtype == port[path].dtype
        np.testing.assert_array_equal(leaf.numpy(), ref[path])


def test_bfloat16_leaves_round_trip_through_a_checkpoint(tmp_path):
    x = torch.randn(3, 5).to(torch.bfloat16)
    CK.save_checkpoint(str(tmp_path), 1, {"w": x})
    _, got = CK.restore_checkpoint(CK.latest_checkpoint(str(tmp_path)),
                                   {"w": torch.zeros(3, 5,
                                                     dtype=torch.bfloat16)})
    assert got["w"].dtype == torch.bfloat16 and torch.equal(got["w"], x)


def test_unported_paths_raise():
    with pytest.raises(NotImplementedError, match="Queue A 15"):
        Trainer(CFG, TrainConfig(), mesh=object(), device="cpu")
    with pytest.raises(NotImplementedError, match="Queue A 15"):
        launch.main(["--smoke", "--device", "cpu", "--mesh", "single"])
    with pytest.raises(NotImplementedError, match="Queue A 16"):
        launch.main(["--arch", "xlstm-125m", "--smoke", "--device", "cpu"])
    with pytest.raises(NotImplementedError, match="Queue A 16"):
        Trainer(dataclasses.replace(CFG, mtp_heads=1),
                TrainConfig(steps=1, batch=2, seq=8), device="cpu").run()


def test_launch_train_on_the_cpu(capsys):
    assert launch.main(["--smoke", "--steps", "2", "--batch", "2",
                        "--seq", "16", "--microbatch", "1",
                        "--device", "cpu"]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    assert out[0].startswith('{"loss": ') and '"step": 0' in out[0]
    assert out[-1].startswith("loss ") and out[-1].endswith("restarts=0")
