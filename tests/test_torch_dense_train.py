"""Training the dense configs (qwen2.5-32b, qwen1.5-32b, mistral-large-123b)
on the CPU against the JAX package.

Weights come from `convert.numpy_lm_params`, whose QKV bias leaves are
nonzero (qwen2.5-32b and qwen1.5-32b): a bias gradient the port left out
would show.  Each config at its SMOKE size (head dim 16) and at the
narrow D=128 size of `tests/test_torch_dense.py` (2 layers, d_model 256,
head dim 128, vocab 512; heads 10/2, 4/4 and 12/1: GQA groups 5, 1 and
12, the backward kernel's shapes), in float32:

* `lm_loss` and every gradient leaf against `jax.value_and_grad` of the
  reference's `lm_loss` (jitted, remat on), with the port's remat on and
  off;
* 3 steps of `make_train_step` at SMOKE size (2 microbatches) against
  the JAX
  `make_train_step`, with each config's optimizer: AdamW for the qwens,
  Adafactor for mistral-large;
* `python -m repro_torch.launch.train --arch <name> --smoke --device cpu`.

Tolerances, as `tests/test_torch_train.py` states them for granite:
1e-5 relative for the loss, 2e-5 of the leaf's largest |want| for a
gradient (the port's attention takes one softmax over the row, the
reference's an online softmax over blocks of 512, and sums round
differently), 2e-5 for the optimizer state after 3 steps (`STATE_TOL`:
granite's test holds it to 1e-5; qwen2.5-32b's came out 1.22e-5 off,
inside its gradients' 2e-5), 1% of the summed learning rates for the
parameters.
"""
import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import transformer as JT
from repro.models.registry import build as jax_build
from repro.optim import optimizers as JO
from repro.train.train_step import make_train_step as jax_train_step
from repro_torch import convert
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.launch import train as launch
from repro_torch.models import transformer as T
from repro_torch.models.registry import build
from repro_torch.optim import optimizers as O
from repro_torch.train.train_step import make_train_step, value_and_grad

DENSE = {"qwen2.5-32b": "qwen2_5_32b", "qwen1.5-32b": "qwen1_5_32b",
         "mistral-large-123b": "mistral_large_123b"}
# the narrow D=128 configs of tests/test_torch_dense.py: (n_heads,
# n_kv_heads), bias as the config has
NARROW = {"qwen2.5-32b": (10, 2), "qwen1.5-32b": (4, 4),
          "mistral-large-123b": (12, 1)}
CASES = [(n, size) for n in DENSE for size in ("smoke", "narrow")]
LR = dict(lr=1e-3, warmup=1, total_steps=3)
# the optimizer state after 3 steps, relative to the leaf's largest
# |want|: the moments follow the gradients, held to 2e-5 (measured: 1.22e-5
# on qwen2.5-32b SMOKE's first moment of w1)
STATE_TOL = 2e-5


def _configs(name: str, size: str):
    """(port config, JAX config) of `name` at `size`, float32."""
    port = importlib.import_module(f"repro_torch.configs.{DENSE[name]}")
    ref = importlib.import_module(f"repro.configs.{DENSE[name]}")
    if size == "smoke":
        return port.SMOKE, ref.SMOKE
    h, hkv = NARROW[name]

    def narrow(cfg):
        return dataclasses.replace(cfg, n_layers=2, d_model=256, n_heads=h,
                                   n_kv_heads=hkv, d_ff=512, vocab=512,
                                   head_dim=128, microbatch=None,
                                   dtype="float32")
    return narrow(port.CONFIG), narrow(ref.CONFIG)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, tree


def _np(x):
    return x.detach().double().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float64)


def _close(got_tree, want_tree, tol):
    """Every leaf within tol of the leaf's largest |want|."""
    want = dict(_leaves(want_tree))
    got = dict(_leaves(got_tree))
    assert set(got) == set(want)
    for path, g in got.items():
        g, w = _np(g), _np(want[path])
        assert g.shape == w.shape, path
        err, scale = float(np.abs(g - w).max()), float(np.abs(w).max())
        assert err <= tol * scale, (path, err, scale)


def _batch(vocab, b=4, s=32, step=0):
    pipe = TokenPipeline(vocab, b, s, seed=0, device="cpu")
    pipe.seek(step)
    batch = next(pipe)
    pipe.close()
    return batch


_JAX_GRADS = {}


def _jax_value_and_grad(name, size, weights, batch):
    """The reference's (loss, metrics, grads) at (name, size), computed
    once for both remat settings of the port."""
    if (name, size) not in _JAX_GRADS:
        _, jcfg = _configs(name, size)
        jb = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
        fn = jax.jit(jax.value_and_grad(
            lambda p: JT.lm_loss(p, jcfg, jb, remat=True), has_aux=True))
        (jl, jm), jg = fn(jax.tree.map(jnp.asarray, weights))
        _JAX_GRADS[(name, size)] = ({k: float(v) for k, v in jm.items()},
                                    jax.tree.map(np.asarray, jg))
    return _JAX_GRADS[(name, size)]


@pytest.mark.parametrize("remat", [True, False])
@pytest.mark.parametrize("name,size", CASES,
                         ids=[f"{n} {s}" for n, s in CASES])
def test_lm_loss_and_every_gradient_match_jax(name, size, remat):
    cfg, _ = _configs(name, size)
    weights = convert.numpy_lm_params(cfg, seed=0)
    if cfg.qkv_bias:                 # nonzero biases, as drawn
        assert all(np.abs(weights["layers"]["attn"][b]).max() > 0
                   for b in ("bias_q", "bias_k", "bias_v"))
    batch = _batch(cfg.vocab)
    jm, jg = _jax_value_and_grad(name, size, weights, batch)
    params = convert.lm_params_to_torch(weights, "cpu")
    (loss, m), grads = value_and_grad(
        lambda p, b: T.lm_loss(p, cfg, b, remat=remat), params, batch)
    for key in ("loss", "xent", "aux"):
        assert abs(float(m[key]) - jm[key]) <= 1e-5 * max(
            abs(jm[key]), 1.0), key
    _close(grads, jg, 2e-5)
    if cfg.qkv_bias:                 # the bias leaves learn
        for b in ("bias_q", "bias_k", "bias_v"):
            assert float(grads["layers"]["attn"][b].abs().max()) > 0, b


@pytest.mark.parametrize("name", list(DENSE))
def test_train_step_matches_jax_over_three_steps(name):
    """The SMOKE config, 2 microbatches, the config's optimizer: loss and
    gnorm each step, the optimizer state and the parameters after 3.
    (At the narrow D=128 sizes the steps' parameters drift apart by the
    last step's rounding, and the moments of a few leaves follow up to
    3.5e-5 apart: the gradients of those sizes are held above, on one
    set of parameters.)"""
    cfg, jcfg = _configs(name, "smoke")
    opt_name = cfg.optimizer
    assert opt_name == ("adafactor" if name == "mistral-large-123b"
                        else "adamw")
    weights = convert.numpy_lm_params(cfg, seed=1)
    j_init, j_update = JO.make_optimizer(opt_name, **LR)
    j_step = jax.jit(jax_train_step(jax_build(jcfg), j_init, j_update, 2))
    init, update = O.make_optimizer(opt_name, **LR)
    step = make_train_step(build(cfg), init, update, 2)
    jp = jax.tree.map(jnp.asarray, weights)
    js = j_init(jp)
    params = convert.lm_params_to_torch(weights, "cpu")
    state = init(params)
    for i in range(3):
        batch = _batch(cfg.vocab, b=4, s=32, step=i)
        jp, js, jm = j_step(jp, js, {k: jnp.asarray(v.numpy())
                                     for k, v in batch.items()})
        params, state, m = step(params, state, batch)
        for key in ("loss", "gnorm"):
            assert abs(float(m[key]) - float(jm[key])) <= 1e-5 * max(
                abs(float(jm[key])), 1.0), (i, key)
    assert int(state["step"]) == int(js["step"]) == 3
    to_np = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    if opt_name == "adafactor":
        _close(state["f"], to_np(js["f"]), STATE_TOL)
        # factored statistics on the stacked [L, d, f] leaves
        assert state["f"]["layers"]["ffn"]["w1"]["vr"].shape == (
            2, cfg.d_model)
        assert state["f"]["layers"]["ffn"]["w1"]["vc"].shape == (2, cfg.d_ff)
    else:
        _close(state["m"], to_np(js["m"]), STATE_TOL)
        _close(state["v"], to_np(js["v"]), STATE_TOL)
    # either optimizer moves an element by about lr a step whatever its
    # gradient's size: every parameter within 1% of the summed rates
    want = dict(_leaves(to_np(jp)))
    for path, g in _leaves(params):
        assert float(np.abs(_np(g) - want[path]).max()) <= 0.01 * 3e-3, path


@pytest.mark.parametrize("name,layers", [(n, None) for n in DENSE]
                         + [("qwen2.5-32b", 1)])
def test_launch_train_takes_the_dense_configs(name, layers, capsys):
    """`--arch <name> --smoke`, and with `--layers 1` (the depth cut one
    card needs at full width)."""
    argv = ["--arch", name, "--smoke", "--steps", "2", "--batch", "2",
            "--seq", "16", "--microbatch", "1", "--device", "cpu"]
    assert launch.main(argv + (["--layers", str(layers)] if layers
                               else [])) == 0
    out = capsys.readouterr().out.strip().splitlines()
    assert out[0].startswith('{"loss": ') and '"step": 0' in out[0]
    assert out[-1].startswith("loss ") and out[-1].endswith("restarts=0")
    first, last = (float(x) for x in out[-1].split()[1:4:2])
    assert np.isfinite(first) and np.isfinite(last)


def _adamw_out_of_place(grads, state, params, lr_fn, b1=0.9, b2=0.95,
                        eps=1e-8, weight_decay=0.1, clip_norm=1.0):
    """AdamW as a pure function: the clipped tree first, new moments
    beside the old ones."""
    step = state["step"] + 1
    n = O.global_norm(grads)
    scale = torch.clamp(n.new_tensor(clip_norm) / n.clamp(min=1e-9), max=1.0)
    grads = O.tree_map(lambda x: x * scale.to(x.dtype), grads)
    lr = lr_fn(step)
    bc1, bc2 = 1 - b1 ** step.float(), 1 - b2 ** step.float()

    def upd(g, m, v, p):
        gf = g.float()
        m2 = b1 * m + (1 - b1) * gf
        v2 = b2 * v + (1 - b2) * gf * gf
        u = (m2 / bc1) / (torch.sqrt(v2 / bc2) + eps)
        u = u + weight_decay * p.float()
        return (-lr * u).to(p.dtype), m2, v2
    out = O.tree_map(upd, grads, state["m"], state["v"], params)
    return (_pick(out, 0), {"m": _pick(out, 1), "v": _pick(out, 2),
                            "step": step}, n)


def _pick(tree, i):
    """Item i of every tuple leaf."""
    if isinstance(tree, dict):
        return {k: _pick(v, i) for k, v in tree.items()}
    return tree[i]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
def test_adamw_updates_its_moments_in_place_with_the_same_bits(dtype):
    """AdamW's moments are updated in place (at the dense configs' widths
    two float32 copies of them do not fit the card beside the model) and
    each leaf is clipped as its update uses it: over 3 steps with the
    clip active, the updates, moments and norms are bitwise those of the
    pure form, and the state's moment tensors are the ones passed in."""
    gen = torch.Generator().manual_seed(7)
    shapes = {"a": (5, 7), "b": {"c": (3,), "d": (2, 4, 6)}}
    params = _draw(shapes, 1.0, gen, dtype)
    lr_fn = O.cosine_schedule(1e-3, 1, 3)
    init, update = O.make_adamw(lr_fn)
    state, want_state = init(params), init(params)
    for _ in range(3):
        grads = _draw(shapes, 3.0, gen, dtype)   # global norm above 1
        m_in = O.tree_leaves(state["m"])
        got_u, state, got_n = update(grads, state, params)
        want_u, want_state, want_n = _adamw_out_of_place(
            grads, want_state, params, lr_fn)
        assert float(want_n) > 1.0
        assert torch.equal(got_n, want_n)
        assert all(a is b for a, b in zip(O.tree_leaves(state["m"]), m_in))
        for got, want in ((got_u, want_u), (state["m"], want_state["m"]),
                          (state["v"], want_state["v"])):
            assert all(torch.equal(g, w) for g, w in zip(
                O.tree_leaves(got), O.tree_leaves(want)))
        params = O.apply_updates(params, got_u)


def _draw(shapes, scale, gen, dtype):
    """A tree of scale * N(0, 1) leaves of `shapes`, in `dtype`."""
    if isinstance(shapes, dict):
        return {k: _draw(v, scale, gen, dtype) for k, v in shapes.items()}
    return (scale * torch.randn(shapes, generator=gen)).to(dtype)
