"""The port's dense/MoE transformer modules against the JAX package's.

Weights and inputs are drawn with numpy and handed to both packages
(`repro_torch.convert.numpy_lm_params` / `lm_params_to_torch` for the
model).  Everything runs in float32 on the CPU, where the two differ only
in the order of float sums: tolerances are 1e-5 absolute on activations
of size ~1 (`ATOL`) unless a test says otherwise; integer routing
decisions are compared exactly.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.granite_moe_1b import SMOKE as J_SMOKE  # noqa: E402
from repro.models import attention as JA  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import moe as JM  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import base  # noqa: E402
from repro_torch.configs.granite_moe_1b import SMOKE  # noqa: E402
from repro_torch.kernels.topk_router import topk_router  # noqa: E402
from repro_torch.models import attention as TA  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import moe as TM  # noqa: E402
from repro_torch.models import registry  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402

torch.use_deterministic_algorithms(True)
ATOL = 1e-5


def _np(x):
    return np.asarray(x.detach().numpy() if isinstance(x, torch.Tensor)
                      else x, np.float32)


def _close(a, b, atol=ATOL):
    np.testing.assert_allclose(_np(a), _np(b), rtol=0, atol=atol)


@pytest.fixture(scope="module")
def params():
    tree = convert.numpy_lm_params(SMOKE, seed=3)
    return (jax.tree.map(jnp.asarray, tree),
            convert.lm_params_to_torch(tree, "cpu", torch.float32))


def _layer0(tree):
    return jax.tree.map(lambda x: x[0], tree)


def test_port_config_is_the_jax_config():
    assert dataclasses.asdict(SMOKE) == dataclasses.asdict(J_SMOKE)
    assert SMOKE.hd == J_SMOKE.hd == 16


def test_serving_entry_points_resolve_the_device():
    """The serving entry points run on `cuda` unless the caller names a
    device, as the simulator's do: without a GPU they raise, and with
    the CPU named everything they make lies there."""
    tree = convert.numpy_lm_params(SMOKE, seed=0)
    model = registry.build(SMOKE)
    named = [convert.lm_params_to_torch(tree, "cpu"), model.init(0, "cpu"),
             model.init_cache(2, 8, "cpu")]
    assert {t.device.type for x in named for t in
            jax.tree.leaves(x, is_leaf=lambda t: isinstance(t, torch.Tensor))
            } == {"cpu"}
    assert torch.equal(model.init(0, "cpu")["emb"], named[1]["emb"])
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid")
    for call in (lambda: convert.lm_params_to_torch(tree),
                 lambda: model.init(0), lambda: model.init_cache(2, 8),
                 lambda: TT.lm_init_cache(SMOKE, 2, 8)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


def test_unported_configs_raise_naming_the_roadmap_item():
    mla = dataclasses.replace(SMOKE, mla=object())
    with pytest.raises(NotImplementedError, match="Queue A 16"):
        registry.build(mla)
    with pytest.raises(NotImplementedError, match="Queue A 16"):
        registry.get_config("deepseek-v3-671b")
    with pytest.raises(NotImplementedError, match="layernorm"):
        registry.build(dataclasses.replace(SMOKE, norm="layernorm"))
    with pytest.raises(NotImplementedError, match="family ssm_xlstm"):
        base.unsupported(dataclasses.replace(SMOKE, family="ssm_xlstm"))


def test_lm_init_tree_matches_jax_leaf_for_leaf():
    gen = torch.Generator().manual_seed(0)
    ours = TT.lm_init(gen, SMOKE)
    want = jax.eval_shape(lambda: JT.lm_init(jax.random.PRNGKey(0),
                                             J_SMOKE))
    flat_o = jax.tree_util.tree_flatten_with_path(
        jax.tree.map(lambda t: (tuple(t.shape), str(t.dtype)), ours,
                     is_leaf=lambda t: isinstance(t, torch.Tensor)),
        is_leaf=lambda t: isinstance(t, tuple))[0]
    flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
    assert [p for p, _ in flat_o] == [p for p, _ in flat_w]
    for (path, (shape, dt)), (_, leaf) in zip(flat_o, flat_w):
        assert shape == leaf.shape, path
        assert dt.replace("torch.", "") == str(leaf.dtype), path
    # and numpy_lm_params lays out the same tree
    tree = convert.numpy_lm_params(SMOKE, seed=0)
    assert jax.tree.structure(tree) == jax.tree.structure(want)
    assert jax.tree.map(lambda a, b: a.shape == b.shape, tree, want) \
        == jax.tree.map(lambda _: True, want)


def test_lm_init_distributions():
    gen = torch.Generator().manual_seed(1)
    p = TT.lm_init(gen, SMOKE)
    wq = p["layers"]["attn"]["wq"]
    bound = (1 / SMOKE.d_model) ** 0.5
    assert float(wq.abs().max()) <= bound and float(wq.std()) > bound / 3
    assert abs(float(p["emb"].std()) - 0.02) < 0.002
    assert torch.equal(p["final_norm"], torch.ones(SMOKE.d_model))
    again = TT.lm_init(torch.Generator().manual_seed(1), SMOKE)
    assert torch.equal(again["emb"], p["emb"])


@pytest.mark.parametrize("rotary", [1.0, 0.5])
def test_apply_rope_interleaved_matches_jax(rotary):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 3, 7, 16)).astype(np.float32)
    pos = rng.integers(0, 500, (2, 1, 7)).astype(np.int32)
    rd = int(rotary * 16)
    want = JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10000.0, rd)
    got = TL.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 10000.0,
                        rd)
    _close(got, want, 1e-4)   # angles up to 500 rad: sin/cos of large args
    if rd < 16:
        np.testing.assert_array_equal(got[..., rd:].numpy(), x[..., rd:])


def test_gqa_train_and_decode_match_jax(params):
    jp, tp = params
    ja, ta = _layer0(jp["layers"])["attn"], TT.layer(tp["layers"], 0)["attn"]
    rng = np.random.default_rng(6)
    b, s, max_len = 2, 9, 16
    x = rng.standard_normal((b, s, SMOKE.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(s), (b, s)).astype(np.int32)
    jo, (jk, jv) = JA.gqa_train(ja, J_SMOKE, jnp.asarray(x), jnp.asarray(pos),
                                return_cache=True)
    to, (tk, tv) = TA.gqa_train(ta, SMOKE, torch.from_numpy(x),
                                torch.from_numpy(pos))
    _close(to, jo)
    _close(tk, jk)
    _close(tv, jv)
    # one decode step: rows at different lengths, the new K/V at kv_len
    pad = ((0, 0), (0, 0), (0, max_len - s), (0, 0))
    jc = (jnp.pad(jk, pad), jnp.pad(jv, pad))
    tc = tuple(torch.nn.functional.pad(t, (0, 0, 0, max_len - s))
               for t in (tk, tv))
    x1 = rng.standard_normal((b, 1, SMOKE.d_model)).astype(np.float32)
    kv_len = np.array([s, 4], np.int32)
    jo, (jk2, jv2) = JA.gqa_decode(ja, J_SMOKE, jnp.asarray(x1), jc,
                                   jnp.asarray(kv_len))
    to, (tk2, tv2) = TA.gqa_decode(ta, SMOKE, torch.from_numpy(x1), tc,
                                   torch.from_numpy(kv_len))
    _close(to, jo)
    _close(tk2, jk2)
    _close(tv2, jv2)
    assert tk2 is tc[0]                       # written in place


@pytest.mark.parametrize("t", [17, 40, 5, 1])
def test_moe_apply_matches_jax(params, t):
    """17 and 40 tokens are prefill lengths whose groups can drop: 17
    tokens form one group of capacity 10 for 34 assignments over 4
    experts; 40 form 8 groups of 5 tokens, capacity 4."""
    jp, tp = params
    jf, tf = _layer0(jp["layers"])["ffn"], TT.layer(tp["layers"], 0)["ffn"]
    x = np.random.default_rng(t).standard_normal(
        (t, SMOKE.d_model)).astype(np.float32)
    jy, _, _ = JM.moe_apply(jf, J_SMOKE, jnp.asarray(x))
    _close(TM.moe_apply(tf, SMOKE, torch.from_numpy(x)), jy)


def test_moe_prefill_length_drops_assignments(params):
    """The 17-token group has capacity below its busiest expert's run:
    some assignments are dropped, in both packages alike."""
    _, tp = params
    tf = TT.layer(tp["layers"], 0)["ffn"]
    x = torch.from_numpy(np.random.default_rng(17).standard_normal(
        (17, SMOKE.d_model)).astype(np.float32))
    m = SMOKE.moe
    cap = min(max(int(17 * m.top_k / m.n_experts * m.capacity_factor), 4),
              17)
    _, idx = topk_router(x @ tf["router"], m.top_k)
    counts = np.bincount(idx.reshape(-1).numpy(), minlength=m.n_experts)
    assert counts.max() > cap


def test_moe_one_group_per_slot_matches_per_slot_vmap(params):
    """The engine's decode: 5 slots on the batch axis with one dispatch
    group each equal the JAX engine's per-slot (vmapped, t=1) moe."""
    jp, tp = params
    jf, tf = _layer0(jp["layers"])["ffn"], TT.layer(tp["layers"], 0)["ffn"]
    x = np.random.default_rng(9).standard_normal(
        (5, SMOKE.d_model)).astype(np.float32)
    want = jax.vmap(lambda r: JM.moe_apply(jf, J_SMOKE, r[None])[0][0])(
        jnp.asarray(x))
    _close(TM.moe_apply(tf, SMOKE, torch.from_numpy(x), groups=5), want)
    # at one group of 5 the capacity rule is another function
    grouped = dataclasses.replace(SMOKE, moe=dataclasses.replace(
        SMOKE.moe, dispatch_groups=1))
    one = TM.moe_apply(tf, grouped, torch.from_numpy(x))
    j_one, _, _ = JM.moe_apply(jf, dataclasses.replace(
        J_SMOKE, moe=dataclasses.replace(J_SMOKE.moe, dispatch_groups=1)),
        jnp.asarray(x))
    _close(one, j_one)


def _variant(cfg, name):
    """granite SMOKE; the dense family (SwiGLU FFN); MoE behind one dense
    layer (`first_k_dense`)."""
    if name == "dense":
        return dataclasses.replace(cfg, family="dense", moe=None)
    if name == "first_k_dense":
        return dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, first_k_dense=1))
    return cfg


@pytest.mark.parametrize("variant", ["moe", "dense", "first_k_dense"])
def test_lm_prefill_and_decode_step_match_jax(variant):
    cfg, jcfg = _variant(SMOKE, variant), _variant(J_SMOKE, variant)
    tree = convert.numpy_lm_params(cfg, seed=4)
    want = jax.eval_shape(lambda: JT.lm_init(jax.random.PRNGKey(0), jcfg))
    assert jax.tree.structure(tree) == jax.tree.structure(want)
    jp = jax.tree.map(jnp.asarray, tree)
    tp = convert.lm_params_to_torch(tree, "cpu", torch.float32)
    rng = np.random.default_rng(8)
    b, s, max_len = 2, 11, 24
    toks = rng.integers(0, SMOKE.vocab, (b, s)).astype(np.int32)
    jl, jc = JT.lm_prefill(jp, jcfg, {"tokens": jnp.asarray(toks)})
    tl, tc = TT.lm_prefill(tp, cfg, {"tokens": torch.from_numpy(toks)})
    _close(tl, jl)
    assert len(tc) == len(jc)
    for (tk, tv), (jk, jv) in zip(tc, jc):
        _close(tk, jk)
        _close(tv, jv)
    jc = JT.lm_grow_cache(jcfg, jc, max_len)
    tc = TT.lm_grow_cache(cfg, tc, max_len)
    assert tc[-1][0].shape[1:] == (b, cfg.n_kv_heads, max_len, cfg.hd)
    kv = np.array([s, s], np.int32)
    tok = np.argmax(np.asarray(jl), -1).astype(np.int32)[:, None]
    for _ in range(3):
        jl, jc = JT.lm_decode_step(jp, jcfg, jc, jnp.asarray(tok),
                                   jnp.asarray(kv))
        tl, tc = TT.lm_decode_step(tp, cfg, tc, torch.from_numpy(tok),
                                   torch.from_numpy(kv))
        _close(tl, jl)
        for (tk, tv), (jk, jv) in zip(tc, jc):
            _close(tk, jk)
            _close(tv, jv)
        tok = np.argmax(np.asarray(jl), -1).astype(np.int32)[:, None]
        kv = kv + 1
    zero = TT.lm_init_cache(cfg, 3, 8, "cpu")
    assert [z[0].shape for z in zero] == [c[0].shape[:1] + (3, 2, 8, 16)
                                          for c in tc]
    assert not any(z[0].any() for z in zero)
