"""The plain versions of the port's serving kernels against the JAX package.

Each port wrapper takes its plain PyTorch version on the CPU (dispatch is
by the tensor's device).  The JAX side is the kernel's jnp reference, the
model function on the serving path (`repro.models.layers`), and the
Pallas kernel in interpret mode, as tests/test_kernels.py runs it.
Inputs come from the generators of `repro_torch.kernels.cases`, which
also make the on-card cases.  Tolerances, by output type: float32
`C.TOL["float32"]` (2e-5 relative to max(1, |x|): sums in another
order), bfloat16 `C.TOL["bfloat16"]` (2^-7: one bf16 ulp where float32
values straddle a rounding boundary); router weights 1e-6 and indices
bitwise on every row whose order is decided.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention.kernel import (  # noqa: E402
    flash_attention_pallas)
from repro.kernels.flash_attention.ref import attention_ref  # noqa: E402
from repro.kernels.flash_decode.kernel import flash_decode_pallas  # noqa: E402
from repro.kernels.flash_decode.ref import decode_attention_ref  # noqa: E402
from repro.kernels.rmsnorm.kernel import rmsnorm_pallas  # noqa: E402
from repro.kernels.rmsnorm.ref import rmsnorm_ref  # noqa: E402
from repro.kernels.topk_router.kernel import topk_router_pallas  # noqa: E402
from repro.kernels.topk_router.ref import topk_router_ref  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro_torch.kernels import cases as C  # noqa: E402
from repro_torch.kernels.flash_attention import ops as FA  # noqa: E402
from repro_torch.kernels.flash_decode import ops as FD  # noqa: E402
from repro_torch.kernels.rmsnorm import ops as RN  # noqa: E402
from repro_torch.kernels.topk_router import ops as TR  # noqa: E402

torch.use_deterministic_algorithms(True)
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def _j(x, dt="float32"):
    return jnp.asarray(np.asarray(x, np.float32)).astype(JDT[dt])


def _close(got: torch.Tensor, want, dt: str):
    want = torch.from_numpy(np.array(jnp.asarray(want).astype(
        jnp.float32))).to(C.DTYPES[dt])
    assert got.dtype == want.dtype and got.shape == want.shape
    err = C.within(got, want, dt)
    assert err <= C.TOL[dt], err


# --------------------------------------------------------------------------
# rmsnorm
# --------------------------------------------------------------------------

# every case but the 256-row prefill's (CPU time in interpret mode)
CPU_RMS = [k for k, c in enumerate(C.RMS_CASES)
           if c[1]["shape"][:2] != (1, 256)]


@pytest.mark.parametrize("k", CPU_RMS,
                         ids=[C.RMS_CASES[k][0] for k in CPU_RMS])
def test_rmsnorm_matches_jax(k):
    _, kw, dt = C.RMS_CASES[k]
    x, w = C.rms_inputs(k, **kw)
    got = RN.rmsnorm(C.to_dtype(x, dt), C.to_dtype(w, "float32"))
    assert RN.rmsnorm.launches == 0          # CPU tensors: plain version
    _close(got, rmsnorm_ref(_j(x, dt), _j(w)), dt)
    _close(got, JL.rmsnorm(_j(x, dt), _j(w)), dt)
    _close(got, rmsnorm_pallas(_j(x, dt), _j(w), interpret=True), dt)


# --------------------------------------------------------------------------
# flash_attention (the prefill's causal self-attention, ragged S)
# --------------------------------------------------------------------------

# S=512, and at D=128 S >= 128 and qwen2.5-32b's 40 heads, run on the
# card only (chip_smoke.py, test_torch_cuda.py): CPU time
CPU_ATTN = [k for k, c in enumerate(C.ATTN_CASES)
            if c[1]["s"] <= 256 and c[1]["hq"] <= 16
            and (c[1]["d"] < 128 or c[1]["s"] < 128)]


@pytest.mark.parametrize("k", CPU_ATTN,
                         ids=[C.ATTN_CASES[k][0] for k in CPU_ATTN])
def test_flash_attention_matches_jax(k):
    _, kw, dt = C.ATTN_CASES[k]
    q, kk, v = C.attn_inputs(k, **kw)
    got = FA.flash_attention(*(C.to_dtype(x, dt) for x in (q, kk, v)))
    jq, jk, jv = (_j(x, dt) for x in (q, kk, v))
    _close(got, attention_ref(jq, jk, jv), dt)
    _close(got, JL.blockwise_attention(jq, jk, jv, causal=True), dt)
    s = kw["s"]
    if s <= 128:     # the TPU kernel asserts S % block == 0
        _close(got, flash_attention_pallas(jq, jk, jv, interpret=True), dt)


def test_flash_attention_is_causal_per_row():
    """Row i sees columns 0..i only: changing the last key and value
    leaves every earlier row unchanged."""
    q, k, v = (C.to_dtype(x, "float32")
               for x in C.attn_inputs(3, 1, 4, 2, 9, 16))
    k2, v2 = k.clone(), v.clone()
    k2[:, :, -1] += 5.0
    v2[:, :, -1] -= 5.0
    a = FA.flash_attention(q, k, v)
    b = FA.flash_attention(q, k2, v2)
    torch.testing.assert_close(a[:, :, :-1], b[:, :, :-1], rtol=0, atol=0)
    assert not torch.equal(a[:, :, -1], b[:, :, -1])


# --------------------------------------------------------------------------
# flash_decode (rounding points of layers.decode_attention)
# --------------------------------------------------------------------------

# the dense configs' serving shapes (B=8, S=512, up to 96 heads), the
# float32 D=128 cases at B=4 S=512 (their Pallas run is ~2 s each) and
# the bf16 tensor-core instance's own cases ("(card)") run on the card
# only; here D=128 meets the Pallas kernel at group 12 on the split's
# kv_len edges, and the model's function at every group in bf16
CPU_DECODE = [k for k, c in enumerate(C.DECODE_CASES)
              if not c[0].endswith(("(decode)", "(card)"))
              and not (c[0].startswith("D=128 group")
                       and c[0].endswith("B=4 S=512 float32"))]


@pytest.mark.parametrize("k", CPU_DECODE,
                         ids=[C.DECODE_CASES[k][0] for k in CPU_DECODE])
def test_flash_decode_matches_jax(k):
    _, kw, dt = C.DECODE_CASES[k]
    q, kk, v, kv_len = C.decode_inputs(k, **kw)
    got = FD.flash_decode(*(C.to_dtype(x, dt) for x in (q, kk, v)),
                          torch.from_numpy(kv_len))
    jq, jk, jv = (_j(x, dt) for x in (q, kk, v))
    jl = jnp.asarray(kv_len)
    # the serving path's function, in both types
    _close(got, JL.decode_attention(jq, jk, jv, jl), dt)
    if dt == "float32":   # there the rounding points vanish
        _close(got, decode_attention_ref(jq, jk, jv, jl), dt)
        _close(got, flash_decode_pallas(jq, jk, jv, jl, interpret=True), dt)


def test_flash_decode_bf16_rounds_like_the_model_not_the_ref():
    """In bfloat16 the port follows layers.decode_attention; the upcasting
    reference is a different function there."""
    q, k, v, kv_len = C.decode_inputs(11, 2, 4, 2, 64, 16)
    dt = "bfloat16"
    got = FD.flash_decode(*(C.to_dtype(x, dt) for x in (q, k, v)),
                          torch.from_numpy(kv_len))
    jq, jk, jv = (_j(x, dt) for x in (q, k, v))
    model = np.asarray(JL.decode_attention(jq, jk, jv, jnp.asarray(kv_len))
                       .astype(jnp.float32))
    ref = np.asarray(decode_attention_ref(jq, jk, jv, jnp.asarray(kv_len))
                     .astype(jnp.float32))
    g = got.float().numpy()
    assert np.abs(g - model).max() < np.abs(model - ref).max()


# --------------------------------------------------------------------------
# topk_router (first index on ties)
# --------------------------------------------------------------------------

@pytest.mark.parametrize("k", range(len(C.ROUTER_CASES)),
                         ids=[c[0] for c in C.ROUTER_CASES])
def test_topk_router_matches_jax(k):
    _, kw, topk = C.ROUTER_CASES[k]
    x = C.router_inputs(k, **kw)
    w, idx = TR.topk_router(torch.from_numpy(x), topk)
    assert TR.topk_router.launches == 0
    rows = C.router_margin_rows(np.asarray(torch.softmax(
        torch.from_numpy(x), -1)), topk, C.ROUTER_MARGIN)
    assert rows.sum() >= len(rows) // 2
    for jw, ji in (topk_router_ref(jnp.asarray(x), topk),
                   topk_router_pallas(jnp.asarray(x), topk, interpret=True)):
        assert np.abs(w.numpy() - np.asarray(jw)).max() <= C.ROUTER_W_TOL
        np.testing.assert_array_equal(idx.numpy()[rows],
                                      np.asarray(ji)[rows])


def test_topk_router_ties_go_to_the_lower_index():
    x = np.zeros((2, 8), np.float32)
    x[0, [1, 3, 6]] = 2.0        # three-way tie for the top
    w, idx = TR.topk_router(torch.from_numpy(x), 4)
    np.testing.assert_array_equal(idx.numpy(), [[1, 3, 6, 0], [0, 1, 2, 3]])
    _, ji = topk_router_ref(jnp.asarray(x), 4)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
    np.testing.assert_allclose(w.numpy().sum(-1), 1.0, rtol=1e-6)
