"""The training kernels' plain versions and autograd Functions on the CPU.

Each backward's plain version (`rmsnorm_bwd_ref`,
`flash_attention_bwd_ref`, `topk_router_bwd_ref`) against `jax.vjp` of
the JAX package's function (`layers.rmsnorm`, `layers.blockwise_attention`
causal at block_k 512 and 16, `topk_router_ref`), and the training
forward's lse against the log-sum-exp of the scores; then each
`torch.autograd.Function` (the wrappers with grad on) against
`torch.autograd` of the plain forward.  Inputs from numpy seeds.

Tolerances: float32 within 1e-5 (relative to max(1, |want|)): the same
sums in another order; bfloat16 within 2^-7, one bf16 ulp of the
gradient's rounding (the vjp rounds at the same points).  The kernels
themselves run on the card (`tests/test_torch_cuda.py`, chip_smoke.py
phase 3).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.topk_router.ref import topk_router_ref as jax_router
from repro.models import layers as JL
from repro_torch.kernels import cases as C
from repro_torch.kernels.flash_attention import ops as FA
from repro_torch.kernels.rmsnorm import ops as RN
from repro_torch.kernels.topk_router import ops as TR

TOL = {"float32": 1e-5, "bfloat16": 2.0 ** -7}
DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def _pair(a: np.ndarray, dt: str):
    """The same values as a torch tensor and a jax array of type dt."""
    t = torch.from_numpy(a).to(DT[dt])
    return t, jnp.asarray(t.float().numpy(), JDT[dt])


def _err(got, want) -> float:
    g = got.double().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float64)
    w = np.asarray(jnp.asarray(want, jnp.float32), np.float64) \
        if not isinstance(want, torch.Tensor) else want.double().numpy()
    return float((np.abs(g - w) / np.maximum(np.abs(w), 1.0)).max())


RMS = [((2, 5, 64), "float32"), ((3, 37), "float32"), ((1, 1024), "float32"),
       ((2, 5, 64), "bfloat16"), ((4, 1024), "bfloat16")]


@pytest.mark.parametrize("shape,dt", RMS, ids=[f"{s}-{d}" for s, d in RMS])
def test_rmsnorm_bwd_ref_is_the_jax_vjp(shape, dt):
    x, w = C.rms_inputs(1, shape)
    dy = np.random.default_rng(2).standard_normal(shape).astype(np.float32)
    (tx, jx), (tdy, jdy) = _pair(x, dt), _pair(dy, dt)
    _, vjp = jax.vjp(lambda a, b: JL.rmsnorm(a, b), jx, jnp.asarray(w))
    jdx, jdw = vjp(jdy)
    dx, dw = RN.rmsnorm_bwd_ref(tx, torch.from_numpy(w), tdy)
    assert dx.dtype == DT[dt] and dw.dtype == torch.float32
    assert _err(dx, jdx) <= TOL[dt]
    # dw sums over rows in float32 in both
    assert _err(dw, jdw) <= TOL["float32"] * max(1, np.prod(shape[:-1]))


ATTN = [(2, 4, 2, 33, 16, "float32"), (1, 4, 4, 17, 64, "float32"),
        (1, 8, 1, 5, 16, "float32"), (1, 16, 8, 1, 64, "float32"),
        (2, 4, 2, 33, 16, "bfloat16"), (1, 16, 8, 40, 64, "bfloat16"),
        # the dense configs' head dim, at GQA groups 1, 5 and 12 (in
        # float32: in bf16 the reference's vjp rounds its D=128 products
        # one to two bf16 ulps off the float32 vjp's rounding, so the bf16
        # kernel is held to the plain version, `test_torch_cuda.py`)
        (1, 4, 4, 17, 128, "float32"), (2, 10, 2, 33, 128, "float32"),
        (1, 12, 1, 20, 128, "float32")]


@pytest.mark.parametrize("block_k", [512, 16])
@pytest.mark.parametrize("b,hq,hkv,s,d,dt", ATTN,
                         ids=[f"B{a[0]}H{a[1]}/{a[2]}S{a[3]}D{a[4]}-{a[5]}"
                              for a in ATTN])
def test_flash_attention_bwd_ref_is_the_jax_vjp(b, hq, hkv, s, d, dt,
                                                block_k):
    q, k, v = C.attn_inputs(3, b, hq, hkv, s, d)
    do = np.random.default_rng(4).standard_normal(q.shape).astype(np.float32)
    (tq, jq), (tk, jk), (tv, jv), (tdo, jdo) = (
        _pair(a, dt) for a in (q, k, v, do))
    jo, vjp = jax.vjp(lambda a, bb, c: JL.blockwise_attention(
        a, bb, c, causal=True, block_k=block_k), jq, jk, jv)
    o, lse = FA.flash_attention_lse_ref(tq, tk, tv)
    assert _err(o, jo) <= TOL[dt]
    grads = FA.flash_attention_bwd_ref(tq, tk, tv, o, tdo, lse)
    for g, jg, t in zip(grads, vjp(jdo), (tq, tk, tv)):
        assert g.dtype == t.dtype and g.shape == t.shape
        assert _err(g, jg) <= TOL[dt]


def test_flash_attention_lse_is_the_rows_log_sum_exp():
    q, k, v = C.attn_inputs(5, 2, 4, 2, 19, 16)
    _, lse = FA.flash_attention_lse_ref(*map(torch.from_numpy, (q, k, v)))
    s = np.einsum("bhqd,bhkd->bhqk", q.astype(np.float64) / 4.0,
                  np.repeat(k, 2, axis=1).astype(np.float64))
    s = np.where(np.tril(np.ones((19, 19), bool)), s, -np.inf)
    want = np.log(np.exp(s - s.max(-1, keepdims=True)).sum(-1)) \
        + s.max(-1)
    np.testing.assert_allclose(lse.numpy(), want, rtol=1e-6, atol=1e-6)


ROUTER = [(9, 4, 2), (17, 32, 8), (5, 32, 32), (17, 32, 1), (12, 32, 8)]


@pytest.mark.parametrize("t,e,k", ROUTER, ids=[f"T{t}E{e}k{k}"
                                               for t, e, k in ROUTER])
def test_topk_router_bwd_ref_is_the_jax_vjp(t, e, k):
    logits = C.router_inputs(6, t, e)       # planted ties, a constant row
    dw = np.random.default_rng(7).standard_normal((t, k)).astype(np.float32)
    (jw, ji), vjp = jax.vjp(lambda a: jax_router(a, k), jnp.asarray(logits))
    want, = vjp((jnp.asarray(dw), np.zeros((t, k), jax.dtypes.float0)))
    w, idx = TR.topk_router_ref(torch.from_numpy(logits), k)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
    got = TR.topk_router_bwd_ref(w, idx, torch.from_numpy(dw), e)
    assert got.dtype == torch.float32 and got.shape == (t, e)
    assert _err(got, want) <= 1e-6


# ------------------------------------------- the autograd Functions


def _grads(fn, inputs, cot):
    out = fn(*inputs)
    out = out[0] if isinstance(out, tuple) else out
    return torch.autograd.grad(out, [x for x in inputs
                                     if isinstance(x, torch.Tensor)
                                     and x.requires_grad], cot)


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_autograd_functions_are_the_plain_forwards_autograd(dt):
    rng = np.random.default_rng(8)
    before = (RN.rmsnorm.launches, RN.rmsnorm_bwd.launches,
              FA.flash_attention_lse.launches,
              FA.flash_attention_bwd.launches, TR.topk_router_bwd.launches)
    x, w = C.rms_inputs(9, (3, 7, 64))
    x = torch.from_numpy(x).to(DT[dt]).requires_grad_(True)
    w = torch.from_numpy(w).requires_grad_(True)
    dy = torch.from_numpy(rng.standard_normal((3, 7, 64)).astype(
        np.float32)).to(DT[dt])
    for g, want in zip(_grads(RN.rmsnorm, (x, w), dy),
                       _grads(RN.rmsnorm_ref, (x, w), dy)):
        assert _err(g, want) <= TOL[dt]
    q, k, v = (torch.from_numpy(a).to(DT[dt]).requires_grad_(True)
               for a in C.attn_inputs(10, 2, 4, 2, 33, 16))
    do = torch.from_numpy(rng.standard_normal((2, 4, 33, 16)).astype(
        np.float32)).to(DT[dt])
    for g, want in zip(_grads(FA.flash_attention, (q, k, v), do),
                       _grads(FA.flash_attention_ref, (q, k, v), do)):
        assert _err(g, want) <= 2 * TOL[dt]
    logits = torch.from_numpy(C.router_inputs(11, 17, 32)).requires_grad_(True)
    dw = torch.from_numpy(rng.standard_normal((17, 8)).astype(np.float32))
    g, = _grads(lambda a: TR.topk_router(a, 8), (logits,), dw)
    want, = _grads(lambda a: TR.topk_router_ref(a, 8), (logits,), dw)
    assert _err(g, want) <= 1e-6
    # CPU tensors take the plain versions: no kernel launched
    assert before == (RN.rmsnorm.launches, RN.rmsnorm_bwd.launches,
                      FA.flash_attention_lse.launches,
                      FA.flash_attention_bwd.launches,
                      TR.topk_router_bwd.launches)


def test_without_grad_the_wrappers_return_plain_tensors():
    x, w = (torch.from_numpy(a) for a in C.rms_inputs(12, (2, 64)))
    y = RN.rmsnorm(x.requires_grad_(True), w)
    assert y.grad_fn is not None
    with torch.no_grad():
        assert RN.rmsnorm(x, w).grad_fn is None
    logits = torch.from_numpy(C.router_inputs(13, 5, 32)).requires_grad_(True)
    wts, idx = TR.topk_router(logits, 8)
    assert wts.grad_fn is not None and not idx.requires_grad
