"""A record of a design decision of the bf16 D=64 attention backward
kernel (`csrc/flash_attention_bwd.cu`), not a test of its code: its
`wgmma` products take P and dS as bf16 operands, where the plain version
keeps them in float32.  A CPU model of that rounding, rounded once,
breaks BWD_TOL on some cases of `cases.TRAIN_ATTN_CASES`, which is why
the kernel splits each operand as hi = bf16(x), lo = bf16(x - hi) and
multiplies twice.  The kernel itself is held to those cases on the card
(tests/test_torch_cuda.py, chip_smoke.py's phase 3).

    PYTHONPATH=src python tests/test_torch_bwd_rounding.py

prints the model's error over BWD_TOL for each bf16 D=64 case, rounded
once and split (the table in PERF.md §6)."""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import cases as C  # noqa: E402
from repro_torch.kernels.flash_attention import ops as FA  # noqa: E402

BF = torch.bfloat16
WGMMA_CASES = [k for k, (_, kw, dt) in enumerate(C.TRAIN_ATTN_CASES)
               if dt == "bfloat16" and kw["d"] == 64 and kw["s"] > 1]


def _operand(x, split):
    hi = x.to(BF).float()
    return hi + (x - hi).to(BF).float() if split else hi


def _model(q, k, v, o, do, lse, split):
    """(dQ, dK, dV) as the kernel rounds them: float32 scores and dP, P
    from exp2 with lse * log2(e), P and dS rounded as bf16 operands."""
    b, hq, n, d = q.shape
    g = hq // k.shape[1]
    scale = d ** -0.5
    qf, dof = q.float(), do.float()
    kf = k.float().repeat_interleave(g, 1)
    vf = v.float().repeat_interleave(g, 1)
    log2e = 1.4426950408889634
    p = torch.exp2((qf @ kf.transpose(-1, -2)) * (scale * log2e)
                   - (lse * log2e)[..., None])
    p = torch.where(torch.ones(n, n, dtype=torch.bool).tril(), p, 0.0)
    ds = p * (dof @ vf.transpose(-1, -2)
              - (dof * o.float()).sum(-1, keepdim=True))
    p, ds = _operand(p, split), _operand(ds, split)
    dk = (ds.transpose(-1, -2) @ qf) * scale
    dv = p.transpose(-1, -2) @ dof
    return ((ds @ kf * scale).to(BF),
            dk.reshape(b, -1, g, n, d).sum(2).to(BF),
            dv.reshape(b, -1, g, n, d).sum(2).to(BF))


def _error(k, split):
    """The model's largest error on case k (`cases.within`, the measure
    BWD_TOL bounds) over dQ, dK and dV."""
    _, kw, dt = C.TRAIN_ATTN_CASES[k]
    q, kk, v = (C.to_dtype(x, dt) for x in C.attn_inputs(k, **kw))
    o, lse = FA.flash_attention_lse_ref(q, kk, v)
    do = C._grads(k, tuple(q.shape), dt, "cpu")
    want = FA.flash_attention_bwd_ref(q, kk, v, o, do, lse)
    got = _model(q, kk, v, o, do, lse, split)
    return max(C.within(a, b, dt) for a, b in zip(got, want))


def test_one_rounding_breaks_the_tolerance_on_peaked_scores():
    """Why the kernel splits: P and dS rounded once to bf16 put the
    peaked case's gradients 3.5 x BWD_TOL off (PERF.md §6)."""
    k = next(k for k in WGMMA_CASES if "peaked" in C.TRAIN_ATTN_CASES[k][0])
    assert _error(k, split=False) > 3 * C.BWD_TOL["bfloat16"]


if __name__ == "__main__":
    tol = C.BWD_TOL["bfloat16"]
    print("case | one rounding / BWD_TOL | split / BWD_TOL")
    for k in WGMMA_CASES:
        print(f"{C.TRAIN_ATTN_CASES[k][0]} | {_error(k, False) / tol} | "
              f"{_error(k, True) / tol}")
