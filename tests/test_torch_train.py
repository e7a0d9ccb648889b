"""Training on the CPU against the JAX package, at granite-moe-1b-a400m's
SMOKE config (2 layers, float32) on `convert.numpy_lm_params` weights.

* `lm_loss` and every gradient leaf against `jax.value_and_grad` of the
  reference's `lm_loss`, with remat on and off; the port's remat on and
  off are bitwise equal;
* `make_train_step` over 3 steps with n_micro 1 and 2: loss, gnorm,
  parameters and both AdamW moments;
* AdamW and Adafactor updates on random trees, `cosine_schedule`;
* `TokenPipeline`'s batches bitwise the reference's.

Tolerances (relative to max(|want|, 1) for a scalar, to the leaf's
largest |want| for a tree): 1e-5 for the loss and 2e-5 for gradients,
where the port's
attention (one softmax over the row) and the reference's (block_k 512
online softmax) and the sums round differently; 1e-5 for the moments
after 3 optimizer steps and 1% of the summed learning rates for the
parameters (AdamW's update is near lr in size whatever the gradient's);
1e-6 for an optimizer step on the same gradients.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import granite_moe_1b as JC
from repro.data.pipeline import TokenPipeline as JaxPipeline
from repro.models import transformer as JT
from repro.models.registry import build as jax_build
from repro.optim import optimizers as JO
from repro.train.train_step import make_train_step as jax_train_step
from repro_torch import convert
from repro_torch.configs import granite_moe_1b
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.models import transformer as T
from repro_torch.models.registry import build
from repro_torch.optim import optimizers as O
from repro_torch.train.train_step import make_train_step, value_and_grad

CFG = granite_moe_1b.SMOKE


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


def _batch(b=4, s=32, step=0, seed=0):
    pipe = TokenPipeline(CFG.vocab, b, s, seed=seed, device="cpu")
    pipe.seek(step)
    batch = next(pipe)
    pipe.close()
    return batch


@pytest.fixture(scope="module")
def weights():
    return convert.numpy_lm_params(CFG, seed=0)


@pytest.mark.parametrize("remat", [True, False])
def test_lm_loss_and_every_gradient_match_jax(weights, remat):
    batch = _batch()
    jb = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
    (jl, jm), jg = jax.value_and_grad(
        lambda p: JT.lm_loss(p, JC.SMOKE, jb, remat=remat), has_aux=True)(
        jax.tree.map(jnp.asarray, weights))
    params = convert.lm_params_to_torch(weights, "cpu")
    (loss, m), grads = value_and_grad(
        lambda p, b: T.lm_loss(p, CFG, b, remat=remat), params, batch)
    for key in ("loss", "xent", "aux"):
        assert abs(float(m[key]) - float(jm[key])) <= 1e-5 * max(
            abs(float(jm[key])), 1.0), key
    assert float(loss) == float(m["loss"])
    _close(grads, jax.tree.map(np.asarray, jg), 2e-5)


def test_remat_on_and_off_are_bitwise(weights):
    batch = _batch(step=1)
    params = convert.lm_params_to_torch(weights, "cpu")
    out = [value_and_grad(lambda p, b: T.lm_loss(p, CFG, b, remat=r),
                          params, batch) for r in (True, False)]
    assert torch.equal(out[0][0][0], out[1][0][0])
    for (_, a), (_, b) in zip(_leaves(out[0][1]), _leaves(out[1][1])):
        assert torch.equal(a, b)


def test_unported_remat_and_mtp_raise(weights):
    import dataclasses
    params = convert.lm_params_to_torch(weights, "cpu")
    with pytest.raises(NotImplementedError, match="Queue A 16"):
        T.lm_loss(params, dataclasses.replace(CFG, remat_policy="dots"),
                  _batch())
    with pytest.raises(NotImplementedError, match="Queue A 16"):
        T.lm_loss(params, dataclasses.replace(CFG, mtp_heads=1), _batch())


@pytest.mark.parametrize("n_micro", [1, 2])
def test_train_step_matches_jax_over_three_steps(weights, n_micro):
    lr_kw = dict(lr=1e-3, warmup=1, total_steps=3)
    j_init, j_update = JO.make_optimizer("adamw", **lr_kw)
    j_step = jax.jit(jax_train_step(jax_build(JC.SMOKE), j_init, j_update,
                                    n_micro))
    init, update = O.make_optimizer("adamw", **lr_kw)
    step = make_train_step(build(CFG), init, update, n_micro)
    jp = jax.tree.map(jnp.asarray, weights)
    js = j_init(jp)
    params = convert.lm_params_to_torch(weights, "cpu")
    state = init(params)
    for i in range(3):
        batch = _batch(b=4, s=32, step=i)
        jp, js, jm = j_step(jp, js, {k: jnp.asarray(v.numpy())
                                     for k, v in batch.items()})
        params, state, m = step(params, state, batch)
        for key in ("loss", "gnorm"):
            assert abs(float(m[key]) - float(jm[key])) <= 1e-5 * max(
                abs(float(jm[key])), 1.0), (i, key)
    assert int(state["step"]) == int(js["step"]) == 3
    assert state["step"].dtype == torch.int32
    to_np = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    _close(state["m"], to_np(js["m"]), 1e-5)
    _close(state["v"], to_np(js["v"]), 1e-5)
    # AdamW moves an element by about lr a step whatever its gradient's
    # size, so an element whose gradient sits near eps moves a visible
    # share of lr on an ulp of gradient: every parameter within 1% of the
    # three steps' summed learning rates (measured: 2e-3 of it)
    want = dict(_leaves(to_np(jp)))
    for path, g in _leaves(params):
        assert float(np.abs(_np(g) - want[path]).max()) <= 0.01 * 3e-3, path


def _random_tree(rng):
    return {"a": rng.standard_normal((6, 5)).astype(np.float32),
            "b": {"c": rng.standard_normal((7,)).astype(np.float32),
                  "d": rng.standard_normal((3, 4, 2)).astype(np.float32)}}


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_optimizer_updates_match_jax(name):
    rng = np.random.default_rng(0)
    params = _random_tree(rng)
    kw = dict(lr=3e-2, warmup=2, total_steps=10)
    j_init, j_update = JO.make_optimizer(name, **kw)
    init, update = O.make_optimizer(name, **kw)
    jp = jax.tree.map(jnp.asarray, params)
    tp = O.tree_map(torch.from_numpy, params)
    js, ts = j_init(jp), init(tp)
    for i in range(4):
        g = _random_tree(rng)
        if i == 3:                   # past the clip norm: scaled down
            g = jax.tree.map(lambda x: 50 * x, g)
        ju, js, jn = j_update(jax.tree.map(jnp.asarray, g), js, jp)
        tu, ts, tn = update(O.tree_map(torch.from_numpy, g), ts, tp)
        assert abs(float(tn) - float(jn)) <= 1e-6 * float(jn)
        _close(tu, jax.tree.map(np.asarray, ju), 1e-6)
        jp, tp = JO.apply_updates(jp, ju), O.apply_updates(tp, tu)
    _close(tp, jax.tree.map(np.asarray, jp), 1e-6)
    if name == "adafactor":
        assert set(ts["f"]["a"]) == {"vr", "vc"}
        assert ts["f"]["a"]["vr"].shape == (6,)
        assert set(ts["f"]["b"]["c"]) == {"v"}


def test_cosine_schedule_matches_jax():
    for args in ((3e-4, 20, 100), (1e-3, 1, 3), (1.0, 0, 50, 0.2)):
        jlr, tlr = JO.cosine_schedule(*args), O.cosine_schedule(*args)
        for s in (0, 1, 5, 19, 20, 21, 60, 100, 150):
            want = float(jlr(s))
            assert abs(float(tlr(torch.tensor(s, dtype=torch.int32)))
                       - want) <= 1e-7 * max(abs(want), 1e-30), (args, s)


def test_token_pipeline_is_bitwise_the_references():
    ref = JaxPipeline(CFG.vocab, 3, 40, seed=5)
    port = TokenPipeline(CFG.vocab, 3, 40, seed=5, device="cpu")
    try:
        for _ in range(4):
            want, got = next(ref), next(port)
            assert set(got) == {"tokens", "labels"}
            for k in got:
                assert got[k].dtype == torch.int32
                np.testing.assert_array_equal(got[k].numpy(),
                                              np.asarray(want[k]))
        port.seek(1)                 # back to step 1's batch
        again = next(port)
        np.testing.assert_array_equal(
            again["tokens"].numpy(), port._make(1)["tokens"])
    finally:
        ref.close()
        port.close()


@pytest.mark.parametrize("groups,capacity_factor", [(32, 1.25), (1, 0.5),
                                                     (2, 0.3)])
def test_moe_train_outputs_and_gradients_match_jax(groups, capacity_factor):
    """The MoE layer alone, with dispatch groups and capacities that drop
    assignments (capacity_factor below 1): y, aux, counts and the
    gradients of sum(y * r) + aux in x, the router and every expert."""
    import dataclasses

    from repro.models import moe as JM
    from repro_torch.models import moe as M
    moe = dataclasses.replace(CFG.moe, dispatch_groups=groups,
                              capacity_factor=capacity_factor)
    cfg = dataclasses.replace(CFG, moe=moe)
    jcfg = dataclasses.replace(JC.SMOKE, moe=dataclasses.replace(
        JC.SMOKE.moe, dispatch_groups=groups,
        capacity_factor=capacity_factor))
    rng = np.random.default_rng(groups)
    p = {k: v[0] for k, v in convert.numpy_lm_params(
        CFG, seed=3)["layers"]["ffn"].items()}
    x = rng.standard_normal((64, CFG.d_model)).astype(np.float32)
    r = rng.standard_normal((64, CFG.d_model)).astype(np.float32)

    def jloss(pp, xx):
        y, aux, counts = JM.moe_apply(pp, jcfg, xx)
        return jnp.sum(y * r) + aux, (y, aux, counts)
    (_, (jy, jaux, jcounts)), (jgp, jgx) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(
        jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    tp = {k: torch.from_numpy(v).requires_grad_(True) for k, v in p.items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    y, aux, counts = M.moe_train(tp, cfg, tx)
    grads = torch.autograd.grad((y * torch.from_numpy(r)).sum() + aux,
                                [tp[k] for k in sorted(tp)] + [tx])
    _close({"y": y}, {"y": np.asarray(jy)}, 1e-5)
    assert abs(float(aux.detach()) - float(jaux)) <= 1e-6
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jcounts))
    _close(dict(zip(sorted(tp) + ["x"], grads)),
           dict(zip(sorted(tp) + ["x"], [np.asarray(jgp[k]) for k in
                                         sorted(tp)] + [np.asarray(jgx)])),
           2e-5)


@pytest.mark.parametrize("groups,capacity_factor,dtype", [
    (32, 1.25, torch.float64), (1, 0.5, torch.float64),
    (2, 0.3, torch.bfloat16)])
def test_moe_route_backward_is_the_vjp_of_its_gathers(groups,
                                                      capacity_factor,
                                                      dtype):
    """`_Dispatch` and `_Combine` against torch.autograd of the same
    forward written as plain gathers and an out-of-place scatter, drops
    included: the outputs bitwise; the gradients of x and of the expert
    outputs within 1e-12 in float64 (a token's k terms add in another
    order) and bitwise in bfloat16 (SMOKE's k = 2 terms round once in
    either order); the router weights' within 1e-5 (float32 sums over d
    in another order)."""
    from repro_torch.models import moe as M
    e, k = CFG.moe.n_experts, CFG.moe.top_k
    t, d = 64, 24
    g = groups
    tg = t // g
    cap = min(max(int(tg * k / e * capacity_factor), 4), tg)
    rng = np.random.default_rng(groups)
    logits = torch.from_numpy(rng.standard_normal((t, e)))
    w, idx = torch.topk(torch.softmax(logits, -1), k)
    x = torch.from_numpy(rng.standard_normal((g, tg, d))).to(dtype)
    out = torch.from_numpy(rng.standard_normal((g, e, cap, d))).to(dtype)
    wg = w.reshape(g, tg, k).float()
    dy = torch.from_numpy(rng.standard_normal((g, tg, d))).float()
    dbuf = torch.from_numpy(rng.standard_normal((g, e, cap, d))).to(dtype)
    r = M._route(idx.reshape(g, tg, k), e, cap)
    n = tg * k

    def plain_dispatch(xg):
        xs = xg.gather(1, (r.order // k)[..., None].expand(g, n, d))
        xs = torch.where(r.keep[..., None], xs, 0)
        buf = torch.zeros((g, e * cap + 1, d), dtype=dtype).scatter(
            1, r.dest[..., None].expand(g, n, d), xs)
        return buf[:, : e * cap].reshape(g, e, cap, d)

    def plain_combine(o, ww):
        wflat = ww.reshape(g, n).gather(-1, r.order)
        order_k = r.inv.reshape(g, tg, k).sort(-1).values
        got = o.reshape(g, e * cap, d).gather(
            1, r.dest.clamp(max=e * cap - 1)[..., None].expand(g, n, d))
        c = torch.where(r.keep[..., None], got, 0).float() * wflat[..., None]
        return c.gather(1, order_k.reshape(g, n, 1).expand(g, n, d)) \
            .reshape(g, tg, k, d).sum(2)

    assert bool(r.keep.all()) == (capacity_factor > 1)    # drops below 1
    tol = 1e-12 if dtype == torch.float64 else 0.0
    xa, xb = x.clone().requires_grad_(True), x.clone().requires_grad_(True)
    got, want = M._Dispatch.apply(xa, r, e, cap), plain_dispatch(xb)
    assert torch.equal(got, want)
    (gx,), (wx,) = (torch.autograd.grad(got, xa, dbuf),
                    torch.autograd.grad(want, xb, dbuf))
    assert gx.dtype == dtype
    torch.testing.assert_close(gx, wx, rtol=0, atol=tol)
    oa, ob = out.clone().requires_grad_(True), out.clone().requires_grad_(True)
    wa, wb = wg.clone().requires_grad_(True), wg.clone().requires_grad_(True)
    got, want = M._Combine.apply(oa, wa, r), plain_combine(ob, wb)
    assert torch.equal(got, want)
    g_out, g_w = torch.autograd.grad(got, (oa, wa), dy)
    w_out, w_w = torch.autograd.grad(want, (ob, wb), dy)
    assert g_out.dtype == dtype and g_w.dtype == torch.float32
    torch.testing.assert_close(g_out, w_out, rtol=0, atol=tol)
    torch.testing.assert_close(g_w, w_w, rtol=0, atol=1e-5)


@pytest.mark.parametrize("warn_only", [False, True])
def test_moe_leaves_deterministic_mode_as_it_found_it(warn_only):
    """The MoE layer switches deterministic algorithms off around its
    distinct-destination scatters only: after a forward and backward the
    mode and its warn_only setting are as before, and the gradients are
    the same bits as with the mode off."""
    from repro_torch.models import moe as M
    p = {k: torch.from_numpy(v[0]).requires_grad_(True) for k, v in
         convert.numpy_lm_params(CFG, seed=4)["layers"]["ffn"].items()}
    x = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (64, CFG.d_model)).astype(np.float32)).requires_grad_(True)

    def grads():
        y, aux, _ = M.moe_train(p, CFG, x)
        return torch.autograd.grad(y.sum() + aux, [x] + list(p.values()))
    want = grads()
    torch.use_deterministic_algorithms(True, warn_only=warn_only)
    try:
        got = grads()
        assert torch.are_deterministic_algorithms_enabled()
        assert torch.is_deterministic_algorithms_warn_only_enabled() \
            == warn_only
    finally:
        torch.use_deterministic_algorithms(False)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
