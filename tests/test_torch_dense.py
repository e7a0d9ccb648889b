"""The dense configs (qwen2.5-32b, qwen1.5-32b, mistral-large-123b) in the
port against the JAX package.

Weights come from `repro_torch.convert.numpy_lm_params`, which draws the
QKV bias leaves nonzero (uniform in +-sqrt(1/d)): a bias the port left
out would show.  Everything runs in float32 on the CPU, where the two
packages differ only in the order of float sums: logits and caches within
1e-5 absolute (`ATOL`; values of size ~1).  Three kinds of check:

* each config's CONFIG and SMOKE are the JAX package's, field for field,
  `registry.build` takes the full config, and `lm_init` lays out the JAX
  tree leaf for leaf, the bias leaves included;
* each SMOKE config's prefill logits and 4 greedy decode steps match the
  JAX model (head dim 16);
* a narrow config per kernel shape the card sees (2 layers, d_model 256,
  head dim 128, vocab 512; heads 10/2, 4/4 and 12/1: GQA groups 5, 1 and
  12; bias on for the first two): the same check, through the kernels'
  plain versions.
"""
import dataclasses
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import layers as JL  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.kernels.flash_decode import ops as FD  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import registry  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402

torch.use_deterministic_algorithms(True)
ATOL = 1e-5
# config name -> module name, in both packages
DENSE = {"qwen2.5-32b": "qwen2_5_32b", "qwen1.5-32b": "qwen1_5_32b",
         "mistral-large-123b": "mistral_large_123b"}
# the narrow configs: (config, n_heads, n_kv_heads), bias as the config has
NARROW = [("qwen2.5-32b", 10, 2), ("qwen1.5-32b", 4, 4),
          ("mistral-large-123b", 12, 1)]
# the JAX model's prefill and decode step, compiled once a config: run
# op by op, each of the 4 steps took ~0.5 s on the CPU
J_PREFILL = jax.jit(JT.lm_prefill, static_argnums=1)
J_DECODE = jax.jit(JT.lm_decode_step, static_argnums=1)


def _modules(name):
    return (importlib.import_module(f"repro_torch.configs.{DENSE[name]}"),
            importlib.import_module(f"repro.configs.{DENSE[name]}"))


def _narrow(cfg, h, hkv):
    return dataclasses.replace(cfg, n_layers=2, d_model=256, n_heads=h,
                               n_kv_heads=hkv, d_ff=512, vocab=512,
                               head_dim=128, microbatch=None,
                               dtype="float32")


def _np(x):
    return np.asarray(x.detach().numpy() if isinstance(x, torch.Tensor)
                      else x, np.float32)


def _close(a, b, atol=ATOL):
    np.testing.assert_allclose(_np(a), _np(b), rtol=0, atol=atol)


@pytest.mark.parametrize("name", list(DENSE))
def test_configs_are_the_jax_configs(name):
    port, ref = _modules(name)
    for ours, theirs in ((port.CONFIG, ref.CONFIG), (port.SMOKE, ref.SMOKE)):
        assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
        assert ours.hd == theirs.hd
    assert registry.get_config(name) is port.CONFIG
    assert registry.get_config(name, smoke=True) is port.SMOKE
    model = registry.build(port.CONFIG)
    assert model.cfg is port.CONFIG and port.CONFIG.hd == 128


@pytest.mark.parametrize("name", list(DENSE))
def test_lm_init_tree_matches_jax_leaf_for_leaf(name):
    port, ref = _modules(name)
    ours = TT.lm_init(torch.Generator().manual_seed(0), port.SMOKE)
    want = jax.eval_shape(lambda: JT.lm_init(jax.random.PRNGKey(0),
                                             ref.SMOKE))
    flat_o = jax.tree_util.tree_flatten_with_path(
        jax.tree.map(lambda t: (tuple(t.shape), str(t.dtype)), ours,
                     is_leaf=lambda t: isinstance(t, torch.Tensor)),
        is_leaf=lambda t: isinstance(t, tuple))[0]
    flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
    assert [p for p, _ in flat_o] == [p for p, _ in flat_w]
    for (path, (shape, dt)), (_, leaf) in zip(flat_o, flat_w):
        assert shape == leaf.shape, path
        assert dt.replace("torch.", "") == str(leaf.dtype), path
    has_bias = "bias_q" in ours["layers"]["attn"]
    assert has_bias == port.CONFIG.qkv_bias
    if has_bias:       # zeros, as the JAX function draws them
        assert not ours["layers"]["attn"]["bias_k"].any()
    tree = convert.numpy_lm_params(port.SMOKE, seed=0)
    assert jax.tree.structure(tree) == jax.tree.structure(want)
    if has_bias:       # nonzero here, so a dropped bias shows
        assert all(np.abs(tree["layers"]["attn"][b]).min() > 0
                   for b in ("bias_q", "bias_k", "bias_v"))


def _run_both(cfg, jcfg, seed=4):
    """Prefill of a [2, 11] batch, then 4 greedy decode steps, in both
    packages on the same numpy weights: logits and caches within ATOL."""
    tree = convert.numpy_lm_params(cfg, seed=seed)
    jp = jax.tree.map(jnp.asarray, tree)
    tp = convert.lm_params_to_torch(tree, "cpu", torch.float32)
    rng = np.random.default_rng(seed)
    b, s, max_len = 2, 11, 24
    toks = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    jl, jc = J_PREFILL(jp, jcfg, {"tokens": jnp.asarray(toks)})
    tl, tc = TT.lm_prefill(tp, cfg, {"tokens": torch.from_numpy(toks)})
    _close(tl, jl)
    for (tk, tv), (jk, jv) in zip(tc, jc):
        _close(tk, jk)
        _close(tv, jv)
    jc = JT.lm_grow_cache(jcfg, jc, max_len)
    tc = TT.lm_grow_cache(cfg, tc, max_len)
    # row 1 starts one token shorter: the rows' kv_len differ
    kv = np.array([s, s - 1], np.int32)
    tok = np.argmax(np.asarray(jl), -1).astype(np.int32)[:, None]
    for _ in range(4):
        jl, jc = J_DECODE(jp, jcfg, jc, jnp.asarray(tok), jnp.asarray(kv))
        tl, tc = TT.lm_decode_step(tp, cfg, tc, torch.from_numpy(tok),
                                   torch.from_numpy(kv))
        _close(tl, jl)
        for (tk, tv), (jk, jv) in zip(tc, jc):
            _close(tk, jk)
            _close(tv, jv)
        assert np.array_equal(np.argmax(np.asarray(jl), -1),
                              tl.argmax(-1).numpy())
        tok = np.argmax(np.asarray(jl), -1).astype(np.int32)[:, None]
        kv = kv + 1


@pytest.mark.parametrize("name", list(DENSE))
def test_smoke_prefill_and_decode_match_jax(name):
    port, ref = _modules(name)
    _run_both(port.SMOKE, ref.SMOKE)


@pytest.mark.parametrize("name,h,hkv", NARROW,
                         ids=[f"{n} {h}/{k}" for n, h, k in NARROW])
def test_narrow_d128_prefill_and_decode_match_jax(name, h, hkv):
    port, ref = _modules(name)
    cfg, jcfg = _narrow(port.CONFIG, h, hkv), _narrow(ref.CONFIG, h, hkv)
    assert cfg.hd == 128 and cfg.qkv_bias == (name != "mistral-large-123b")
    _run_both(cfg, jcfg, seed=5)


def test_bias_is_added_before_rope():
    """A narrow qwen config with its biases zeroed gives other logits
    than with them: the comparison above would see a dropped bias."""
    port, _ = _modules("qwen2.5-32b")
    cfg = _narrow(port.CONFIG, 10, 2)
    tree = convert.numpy_lm_params(cfg, seed=5)
    toks = torch.from_numpy(np.arange(7, dtype=np.int64)[None])
    with_bias, _ = TT.lm_prefill(convert.lm_params_to_torch(tree, "cpu"),
                                 cfg, {"tokens": toks})
    for b in ("bias_q", "bias_k", "bias_v"):
        tree["layers"]["attn"][b] = np.zeros_like(tree["layers"]["attn"][b])
    without, _ = TT.lm_prefill(convert.lm_params_to_torch(tree, "cpu"),
                               cfg, {"tokens": toks})
    assert float((with_bias - without).abs().max()) > 1e-3


def test_rope_theta_1e6_at_d128_matches_jax():
    """The configs' rope theta 1e6 at head dim 128, positions up to 300:
    angles up to 300 rad, sin/cos of large arguments (1e-4, as granite's
    rope test)."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 3, 9, 128)).astype(np.float32)
    pos = rng.integers(0, 301, (2, 1, 9)).astype(np.int32)
    pos[0, 0, 0] = 300
    want = JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6, 128)
    got = TL.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e6, 128)
    _close(got, want, 1e-4)


def test_decode_sub_groups_cover_every_group():
    """A GQA group splits into the fewest clusters of at most
    `FD.MAX_GROUP` heads, as equal as they come; the clusters' shared
    memory fits at D=128 up to S=4096 for the dense configs' groups."""
    assert [FD.sub_groups(g) for g in (1, 2, 4, 5, 8, 9, 12, 17)] == [
        (1, 1), (1, 2), (1, 4), (2, 3), (2, 4), (3, 3), (3, 4), (5, 4)]
    for group in (1, 5, 12):
        n, gs = FD.sub_groups(group)
        assert (n - 1) * gs < group <= n * gs <= n * FD.MAX_GROUP
        assert FD.smem_bytes(gs, 4096, 128) <= FD.SMEM_BYTES
