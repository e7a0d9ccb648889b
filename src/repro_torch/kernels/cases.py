"""Seeded inputs for checking each kernel against its plain version.

One list of cases per kernel: the simulator's shapes at n=64 and n=256
(worksteal's banks and planes at n=16, n=64 and run_app's 64 CUs too)
plus the edge cases (duplicate destinations, pads, out-of-range indices
and offsets, dirty bit 31, a ragged last lane, remote_cap, fences, empty
masks), the serving path's shapes at granite-moe-1b-a400m's width
(ragged sequence lengths, kv_len 1 and max_len, planted router ties)
and at the widths of the other configs (rmsnorm up to d=12288, rows
and bases off 16 bytes; the router up to E=256 and underflowed
probabilities), and the cross-pod sync's flattened
banks for selective_flush (pads, indices at or above nb, widths and
base pointers off 16 bytes).  The simulator's kernels' replica instances
take the `*_MANY_CASES` lists: `stacked` inputs at R in `REPLICAS`, the
edge cases at R=2 and R=3, and idle replicas beside busy ones.  `chip_smoke.py` and
`tests/test_torch_cuda.py` run these lists on the card, the serving
kernels' through `check_float` and `check_router`;
`tests/test_torch_kernels.py` and `tests/test_torch_model_kernels.py`
feed the same generators to the JAX package's Pallas kernels and
references.  Generators return numpy arrays, packed planes as uint32;
`to_torch` views those as the port's int32 bit patterns.
"""
from __future__ import annotations

import numpy as np
import torch


def words(rng, shape, w):
    """Random packed lanes for width w: every real bit random (bit 31
    included when w >= 32), padding bits zero."""
    x = rng.integers(0, 2**32, size=shape, dtype=np.uint64).astype(np.uint32)
    keep = np.array([(1 << min(32, max(0, w - 32 * k))) - 1
                     for k in range(shape[-1])], np.uint64).astype(np.uint32)
    return x & keep


def to_torch(x) -> torch.Tensor:
    x = np.asarray(x)
    return torch.from_numpy(x.view(np.int32) if x.dtype == np.uint32 else x)


def unpack_bits(lanes, w):
    """[..., L] uint32 lanes -> [..., w] bool flags (LSB first)."""
    bits = (lanes[..., :, None] >> np.arange(32, dtype=np.uint32)) & 1
    return bits.reshape(lanes.shape[:-1] + (-1,))[..., :w].astype(bool)


def dw_inputs(seed, nb, w, m, *, dup=True, pad=True, oor=False, hot=(),
              recovery=None, bool_mask=False):
    """drain_writeback (l2, rows, dirty, idx).  dup=False draws distinct
    destinations (the b_writeback shape); pads are -1; out-of-range
    destinations are >= nb.  `hot` rows take half the entries (before
    pads and out-of-range ones are planted): many duplicates of each,
    e.g. on both sides of the kernel's tile edge.  recovery=(k, cap)
    gives the crash-recovery drain's shape (`b_recover`'s
    `b_drain(DRAIN_ALL)` of one cache): m = n * cap rows of which only
    cache k's cap rows are real, distinct blocks with a quarter of its
    sFIFO slots empty, and every other row out of range (index nb) with
    its mask clear.  bool_mask=True gives the same mask as [m, w] bool
    flags (the REPRO_NO_PACK=1 layout's instance) in place of packed
    lanes."""
    rng = np.random.default_rng(seed)
    l2 = rng.integers(-2**31, 2**31, (nb, w), dtype=np.int64) \
        .astype(np.int32)
    rows = rng.integers(-2**31, 2**31, (m, w), dtype=np.int64) \
        .astype(np.int32)
    dirty = words(rng, (m, (w + 31) // 32), w)
    if dup:
        idx = rng.integers(0, max(2, nb // 4), m).astype(np.int32)
    else:
        idx = rng.permutation(nb)[:m].astype(np.int32)
    if len(hot):
        pick = rng.random(m) < 0.5
        idx[pick] = rng.choice(np.asarray(hot, np.int32), int(pick.sum()))
    if pad:
        idx[rng.random(m) < 0.25] = -1
    if oor:
        idx[rng.random(m) < 0.15] = nb + rng.integers(0, 3)
    if recovery is not None:
        k, cap = recovery
        real = rng.permutation(nb)[:cap].astype(np.int32)
        real[rng.random(cap) < 0.25] = nb
        idx[:] = nb
        idx[k * cap:(k + 1) * cap] = real
        dirty[idx == nb] = 0
    if bool_mask:
        dirty = unpack_bits(dirty, w)
    return l2, rows, dirty, idx


def pc_inputs(seed, n, nb, w, *, oor=False, block0=False):
    """plane_commit (wvalid, wdirty, b, o, set_valid, set_dirty).  A
    quarter of the lanes target the sign bit's word.  oor=True puts some
    blocks outside [0, nb) (clamped) and some offsets outside the row's
    lanes (an empty bit); block0=True puts every lane on block 0."""
    rng = np.random.default_rng(seed)
    lanes = (w + 31) // 32
    wv = words(rng, (n, nb, lanes), w)
    wd = words(rng, (n, nb, lanes), w)
    b = rng.integers(0, nb, n).astype(np.int32)
    if block0:
        b[:] = 0
    o = rng.integers(0, w, n).astype(np.int32)
    o[: max(1, n // 4)] = min(31, w - 1)
    if oor:
        b[rng.random(n) < 0.2] = -1
        b[rng.random(n) < 0.2] = nb + 2
        o[rng.random(n) < 0.2] = -5
        o[rng.random(n) < 0.2] = 32 * lanes + 3
    sv = rng.random(n) < 0.7
    sd = rng.random(n) < 0.5
    return wv, wd, b, o, sv, sd


def plan_inputs(seed, n, *, can_l=None, can_r=None, ties=None):
    """trip_plan (clocks, can_l, can_r, bound, raddr).  Small-integer
    clocks force ties, the lexicographic order's hard case; can_l/can_r
    given as a bool fill the whole mask.  ties="signed_zero" puts every
    third clock at the minimum, alternately +0.0 and -0.0 (equal as
    floats, so the first index must win whatever its sign); ties="equal"
    makes every clock the same."""
    rng = np.random.default_rng(seed)
    clocks = rng.integers(0, max(2, n // 3), n).astype(np.float32)
    if ties == "signed_zero":
        clocks += 1.0
        zero = np.arange(0, n, 3)
        clocks[zero] = np.where(np.arange(len(zero)) % 2, -0.0, 0.0)
    elif ties == "equal":
        clocks[:] = clocks[0]
    cl = rng.random(n) < 0.6 if can_l is None else np.full(n, can_l)
    cr = rng.random(n) < 0.4 if can_r is None else np.full(n, can_r)
    bound = rng.integers(1, 5, n).astype(np.float32)
    raddr = rng.integers(0, max(2, n // 4), n).astype(np.int32)
    return clocks, cl, cr, bound, raddr


# (name, keyword arguments of the generator); the seed is the case's index
DRAIN_CASES = [
    ("b_drain n=64", dict(nb=128, w=16, m=1024)),
    ("b_writeback n=64", dict(nb=128, w=16, m=64, dup=False)),
    ("b_drain n=256", dict(nb=512, w=16, m=4096)),
    ("dups+pads+out-of-range, bit 31", dict(nb=32, w=64, m=48, oor=True)),
    ("ragged lane, no pads", dict(nb=16, w=40, m=40, pad=False, oor=True)),
] + [
    # a bank of many of the kernel's row tiles (W=16: 16 rows a CTA over
    # one wave; 768 rows the most one CTA's map holds): duplicates on both
    # sides of tile edges, pads and out-of-range rows
    ("past one tile", dict(nb=2048, w=16, m=512, oor=True,
                           hot=(0, 766, 767, 768, 769, 1535, 1536, 2047))),
    # W=48: a packed row's second lane is ragged (16 of 32 words); a bool
    # row is three 16-byte units
    ("W=48 ragged second lane, dups+pads", dict(nb=64, w=48, m=200,
                                                oor=True)),
] + [
    # worksteal's banks: the golden cells at n=16 and n=64 and run_app at
    # the paper's 64 CUs (a drain of n*cap rows, a writeback of n)
    (f"worksteal {where} {op}", dict(nb=nb, w=16, m=m, dup=op == "drain"))
    for where, nb, n in (("n=16", 64, 16), ("n=64", 640, 64),
                         ("run_app 64 CUs", 1600, 64))
    for op, m in (("drain", 16 * n), ("writeback", n))
] + [
    # the crash-recovery drain at n=64: one dead cache's 16 sFIFO rows
    # real, the other 63 caches' rows out of range
    ("recovery drain n=64", dict(nb=128, w=16, m=64 * 16, pad=False,
                                 recovery=(5, 16))),
]
COMMIT_CASES = [
    ("n=64", dict(n=64, nb=128, w=16)),
    ("n=256", dict(n=256, nb=512, w=16)),
    ("two lanes, bit 31", dict(n=6, nb=8, w=64)),
    ("ragged lane, out of range", dict(n=8, nb=4, w=40, oor=True)),
    # a lane's slice of 6 words: 16-byte units would straddle lanes
    ("slice of 6 words", dict(n=5, nb=3, w=40)),
    ("one lane", dict(n=1, nb=128, w=16)),
    ("every lane on block 0", dict(n=64, nb=128, w=16, block0=True)),
    # worksteal's planes: the golden cells and run_app at 64 CUs
    ("worksteal n=16", dict(n=16, nb=64, w=16)),
    ("worksteal n=64", dict(n=64, nb=640, w=16)),
    ("worksteal run_app 64 CUs", dict(n=64, nb=1600, w=16)),
]
PLAN_CASES = (
    [(f"n={n} remote_cap={cap} fenced={fenced}",
      dict(n=n), cap, fenced)
     for n in (1, 64, 256, 1024) for cap in (False, True)
     for fenced in (False, True)]
    + [(f"n=64 empty masks can_l={cl} can_r={cr}",
        dict(n=64, can_l=cl, can_r=cr), True, False)
       for cl, cr in ((False, False), (True, False), (False, True))]
    # one warp and just past it, clocks tied at the minimum
    + [(f"n={n} ties={ties} remote_cap={cap} fenced={fenced}",
        dict(n=n, ties=ties), cap, fenced)
       for n in (32, 33) for ties in ("signed_zero", "equal")
       for cap in (False, True) for fenced in (False, True)])


def horizon(clocks, fenced):
    """The fenced cases' event horizon: the median clock (None: no fence)."""
    return float(np.sort(clocks)[len(clocks) // 2]) if fenced else None


# the replica instances' replica counts (the harness's `run_*_many`)
REPLICAS = (1, 2, 64)
# what an idle replica holds, by generator: every drain entry a pad, no
# lane setting a bit, no agent ready
_IDLE = {"dw_inputs": lambda xs: xs[3].fill(-1),
         "pc_inputs": lambda xs: (xs[4].fill(False), xs[5].fill(False)),
         "plan_inputs": lambda xs: (xs[1].fill(False), xs[2].fill(False))}


def stacked(gen, reps: int, seed: int, idle=(), **kw):
    """`reps` replicas of a generator's inputs stacked on a leading axis
    (the replica instances' operands), replica r drawn from seed
    1000 * seed + r; the replicas listed in `idle` get nothing to do
    (every drain entry a pad, no bit set, no agent ready)."""
    cols = [list(gen(1000 * seed + r, **kw)) for r in range(reps)]
    for r in idle:
        _IDLE[gen.__name__](cols[r])
    return tuple(np.stack(c) for c in zip(*cols))


def horizons(clocks, fenced):
    """[R] event horizons of stacked clocks: each replica's median clock
    (None: no fence)."""
    return np.array([horizon(c, True) for c in clocks], np.float32) \
        if fenced else None


# (name, generator keywords, R, idle replicas); the seed is the case's
# index.  Every replica count at the n=64 shapes, the edge cases at R=2
# and R=3, and an idle replica beside busy ones.
DRAIN_MANY_CASES = (
    [(f"b_drain n=64 R={r}", dict(nb=128, w=16, m=1024), r, ())
     for r in REPLICAS]
    + [(f"b_writeback n=64 R={r}", dict(nb=128, w=16, m=64, dup=False), r,
        ()) for r in REPLICAS]
    + [("dups+pads+out-of-range, bit 31, R=2",
        dict(nb=32, w=64, m=48, oor=True), 2, ()),
       ("W=48 ragged second lane, R=3", dict(nb=64, w=48, m=200, oor=True),
        3, ()),
       ("past one tile, R=2", dict(nb=2048, w=16, m=512, oor=True,
                                   hot=(0, 767, 768, 2047)), 2, ()),
       ("recovery drain n=64, R=2", dict(nb=128, w=16, m=64 * 16, pad=False,
                                         recovery=(5, 16)), 2, ()),
       ("an idle replica, R=3", dict(nb=128, w=16, m=1024), 3, (1,)),
       ("b_drain n=256, R=2", dict(nb=512, w=16, m=4096), 2, ())])
COMMIT_MANY_CASES = (
    [(f"n=64 R={r}", dict(n=64, nb=128, w=16), r, ()) for r in REPLICAS]
    + [("ragged lane, out of range, R=2", dict(n=8, nb=4, w=40, oor=True),
        2, ()),
       ("slice of 6 words, R=3", dict(n=5, nb=3, w=40), 3, ()),
       ("every lane on block 0, R=2", dict(n=64, nb=128, w=16, block0=True),
        2, ()),
       ("an idle replica, R=3", dict(n=64, nb=128, w=16), 3, (2,)),
       ("n=256 R=2", dict(n=256, nb=512, w=16), 2, ())])
PLAN_MANY_CASES = (
    [(f"n=64 R={r} remote_cap={cap} fenced={fenced}", dict(n=64), r, (),
      cap, fenced)
     for r in REPLICAS for cap in (False, True) for fenced in (False, True)]
    + [(f"n={n} R=2 remote_cap=True", dict(n=n), 2, (), True, False)
       for n in (1, 33, 256, 1024)]
    + [("n=33 R=3 ties=signed_zero", dict(n=33, ties="signed_zero"), 3, (),
        True, True),
       ("n=64 R=3 an idle replica", dict(n=64), 3, (0,), True, False),
       ("n=64 R=64 idle replicas", dict(n=64), 64, (3, 40, 63), True,
        True)])


# --------------------------------------------------------------------------
# selective_flush: the cross-pod sync's flattened banks ([pods*nb, bs],
# pods*k indices, a quarter of them pads) and the edges
# --------------------------------------------------------------------------

def flush_inputs(seed, nb, bs, k, *, pad=0.25, oor=False):
    """selective_flush (bank [nb, bs] float32, idx [k] int32): repeated
    rows, pads (-1) with probability `pad`, and with oor=True some
    indices at or above nb (clipped to nb-1)."""
    rng = np.random.default_rng(seed)
    bank = rng.standard_normal((nb, bs)).astype(np.float32)
    idx = rng.integers(0, nb, k).astype(np.int32)
    idx[rng.random(k) < pad] = -1
    if oor:
        idx[rng.random(k) < 0.2] = nb + rng.integers(0, 5)
    return bank, idx


# (name, generator keyword arguments, dtype, shift); the seed is the
# index.  `shift` elements in front of the bank move its base pointer
# off a 16-byte boundary (the kernel then copies in narrower units).
FLUSH_CASES = [
    ("moe_expert_bank 4 pods", dict(nb=1024, bs=2048, k=244), "float32", 0),
    ("embedding_rows 4 pods", dict(nb=4096, bs=1024, k=652), "float32", 0),
    ("dense_layer 4 pods", dict(nb=1024, bs=2048, k=1024), "float32", 0),
    ("example 4 pods", dict(nb=128, bs=4096, k=64), "float32", 0),
    ("all pads", dict(nb=16, bs=64, k=8, pad=1.0), "float32", 0),
    ("at or above nb", dict(nb=16, bs=64, k=32, oor=True), "float32", 0),
    ("bfloat16", dict(nb=64, bs=256, k=40), "bfloat16", 0),
    ("bfloat16 odd width (2-byte units)", dict(nb=33, bs=37, k=20),
     "bfloat16", 0),
    ("float32 width 6 (8-byte units)", dict(nb=20, bs=6, k=9), "float32", 0),
    ("float32 width 5 (4-byte units)", dict(nb=20, bs=5, k=9), "float32", 0),
    ("float32 base off by one element (4-byte units)",
     dict(nb=20, bs=8, k=9, oor=True), "float32", 1),
    ("bfloat16 base off by one element (2-byte units)",
     dict(nb=20, bs=16, k=9), "bfloat16", 1),
]


def flush_args(k: int, device) -> tuple:
    """Case k of FLUSH_CASES as (bank, idx) tensors on `device`, the bank
    a contiguous view `shift` elements into a buffer."""
    _, kw, dt, shift = FLUSH_CASES[k]
    bank, idx = flush_inputs(k, **kw)
    flat = to_dtype(bank, dt).reshape(-1).to(device)
    buf = torch.zeros(shift + flat.numel(), dtype=flat.dtype, device=device)
    buf[shift:] = flat
    return (buf[shift:].view(bank.shape),
            torch.from_numpy(idx).to(device))


# --------------------------------------------------------------------------
# the serving path's float kernels (granite-moe-1b-a400m: d=1024, Hq 16,
# Hkv 8, D 64, E 32, k 8; SMOKE: d=64, Hq 4, Hkv 2, D 16, E 4, k 2).
# Generators return float32 numpy arrays; `to_dtype` makes the typed
# torch tensor (numpy has no bfloat16).
# --------------------------------------------------------------------------

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def to_dtype(x, dtype: str) -> torch.Tensor:
    return torch.from_numpy(np.asarray(x, np.float32)).to(DTYPES[dtype])


def rms_inputs(seed, shape):
    """rmsnorm (x [..., d], w [d]): activations of a few units' scale and
    a scale vector around 1."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape) * 3.0).astype(np.float32)
    w = rng.uniform(0.5, 1.5, shape[-1]).astype(np.float32)
    return x, w


def attn_inputs(seed, b, hq, hkv, s, d, peak=1.0):
    """flash_attention (q [B,Hq,S,D], k, v [B,Hkv,S,D]); `peak` scales q
    and k, so the scaled scores' spread grows by peak^2 (softmax rows
    near one-hot)."""
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal(shape).astype(np.float32)
               for shape in ((b, hq, s, d), (b, hkv, s, d), (b, hkv, s, d)))
    return q * np.float32(peak), k * np.float32(peak), v


def decode_inputs(seed, b, hq, hkv, s, d, lens=None):
    """flash_decode (q [B,Hq,D], k, v [B,Hkv,S,D], kv_len [B] int32): a
    ragged valid prefix with kv_len 1 in row 0 and S in row 1 when B > 1,
    or the given `lens`."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, hq, d)).astype(np.float32)
    k = rng.standard_normal((b, hkv, s, d)).astype(np.float32)
    v = rng.standard_normal((b, hkv, s, d)).astype(np.float32)
    kv_len = rng.integers(1, s + 1, b).astype(np.int32)
    kv_len[0] = 1
    if b > 1:
        kv_len[1] = s
    if lens is not None:
        kv_len = np.asarray(lens, np.int32)
    return q, k, v, kv_len


def router_inputs(seed, t, e, underflow=False):
    """topk_router logits [T, E] float32 with planted ties: every third
    row repeats one logit in several experts (exact ties in the softmax,
    which must go to the lower index) and the last row is constant.
    underflow=True then leaves row r 1 + r % 4 live experts and puts the
    others 200-300 below the row's largest logit, where their
    probabilities are exactly 0.0 in float32: the later rounds choose
    among zeros, by the lowest index not yet chosen."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((t, e)).astype(np.float32)
    for r in range(0, t, 3):
        cols = rng.choice(e, size=min(e, 4), replace=False)
        x[r, cols] = x[r, cols[0]]
    x[t - 1] = 0.5
    if underflow:
        for r in range(t):
            dead = rng.permutation(e)[1 + r % 4:]
            x[r, dead] = x[r].max() - rng.uniform(200.0, 300.0, len(dead))
    return x


def router_margin_rows(probs: np.ndarray, k: int, tol: float) -> np.ndarray:
    """Rows whose order among the top k+1 is decided: every gap between
    neighbours in the sorted probabilities is 0 (an exact tie, which
    goes to the lower index) or above `tol`."""
    top = -np.sort(-probs, axis=-1)[:, : min(k + 1, probs.shape[-1])]
    gaps = top[:, :-1] - top[:, 1:]
    return np.all((gaps == 0) | (gaps > tol), axis=-1)


# (name, generator keyword arguments, dtype); the seed is the index
RMS_CASES = [
    (f"{shape} {dt}", dict(shape=shape), dt)
    # granite's width (prefill, decode), SMOKE's, then the widths of the
    # qwens and stablelm, deepseek-v3 and mistral-large: a CTA a row, and
    # float32 at 12288 past the CTA's registers (a second read of x)
    for shape in ((1, 17, 1024), (1, 256, 1024), (4, 1, 1024), (5, 1, 64),
                  (3, 5120), (2, 7168), (2, 12288))
    for dt in ("float32", "bfloat16")] + [
    # rows that are not 16-byte multiples: the kernel's scalar instance, a
    # warp a row, a CTA a row, and past the CTA's registers
    ("(3, 36) bfloat16, 72-byte rows", dict(shape=(3, 36)), "bfloat16"),
    ("(5, 37) float32, 148-byte rows", dict(shape=(5, 37)), "float32"),
    ("(4, 1030) bfloat16, 2060-byte rows", dict(shape=(4, 1030)),
     "bfloat16"),
    ("(2, 4097) bfloat16, 8194-byte rows", dict(shape=(2, 4097)),
     "bfloat16"),
    # the widest row a warp takes (256 16-byte units) and the first a CTA
    # takes
    ("(3, 2048) bfloat16", dict(shape=(3, 2048)), "bfloat16"),
    ("(3, 2056) bfloat16", dict(shape=(3, 2056)), "bfloat16")]
# rmsnorm on contiguous views whose base is off 16 bytes (the kernel then
# takes its scalar instance): (name, shape, dtype, x's offset in
# elements, w's offset in elements)
RMS_VIEW_CASES = [
    ("x [4,1,1024] bf16 one element in", (4, 1, 1024), "bfloat16", 1, 0),
    ("x [3,5120] f32 one element in", (3, 5120), "float32", 1, 0),
    ("w [1024] one element in", (4, 1, 1024), "bfloat16", 0, 1),
    ("x [2,7168] bf16 four elements in", (2, 7168), "bfloat16", 4, 0)]
ATTN_CASES = (
    [(f"S={s} {dt}", dict(b=1, hq=16, hkv=8, s=s, d=64), dt)
     for s in (1, 5, 17, 64, 200, 512) for dt in ("float32", "bfloat16")]
    + [("SMOKE B=2 S=33 float32", dict(b=2, hq=4, hkv=2, s=33, d=16),
        "float32")]
    # the timed prefill shape (phase 5 of chip_smoke.py)
    + [(f"S=256 {dt}", dict(b=1, hq=16, hkv=8, s=256, d=64), dt)
       for dt in ("bfloat16", "float32")]
    # D=128, the dense configs' head dim, at their GQA groups: 1
    # (qwen1.5-32b), 5 (qwen2.5-32b) and 12 (mistral-large-123b), at the
    # edges of a 64-row tile; S <= 128, which the TPU kernel takes whole
    + [(f"D=128 group {g} S={s} {dt}", dict(b=1, hq=hq, hkv=hkv, s=s,
                                            d=128), dt)
       for g, hq, hkv, s in ((1, 4, 4, 65), (5, 10, 2, 17), (5, 10, 2, 128),
                             (12, 12, 1, 100))
       for dt in ("float32", "bfloat16")]
    # qwen2.5-32b's timed prefill (40/8, S=256), and a ragged S over
    # several tiles at B=2
    + [(f"D=128 40/8 S=256 {dt}", dict(b=1, hq=40, hkv=8, s=256, d=128), dt)
       for dt in ("bfloat16", "float32")]
    + [("D=128 B=2 10/2 S=300 bfloat16", dict(b=2, hq=10, hkv=2, s=300,
                                              d=128), "bfloat16")])
DECODE_CASES = (
    [(f"B=4 S=512 {dt}", dict(b=4, hq=16, hkv=8, s=512, d=64), dt)
     for dt in ("float32", "bfloat16")]
    + [("B=5 S=48 SMOKE float32", dict(b=5, hq=4, hkv=2, s=48, d=16),
        "float32"),
       ("B=1 S=1 bfloat16", dict(b=1, hq=16, hkv=8, s=1, d=64),
        "bfloat16")]
    # kv_len at the edges of the kernel's 8-way split of the prefix: shares
    # of 0 and 1 positions, empty ranks
    + [(f"B=5 S=64 kv_len 7,8,9,1,64 {dt}",
        dict(b=5, hq=16, hkv=8, s=64, d=64, lens=(7, 8, 9, 1, 64)), dt)
       for dt in ("bfloat16", "float32")]
    + [("B=3 S=24 SMOKE kv_len 7,8,9 float32",
        dict(b=3, hq=4, hkv=2, s=24, d=16, lens=(7, 8, 9)), "float32")]
    # D=128 at the dense configs' groups 1, 5 and 12 (float32: clusters of
    # at most 4 heads a kv-head, 5 as 3 + 2, 12 as 4 + 4 + 4; bf16: one
    # cluster a kv-head), then their serving shapes (B=8, S=512: 40/40,
    # 40/8, 96/8) and group 12 at the split's edges
    + [(f"D=128 group {g} B=4 S=512 {dt}", dict(b=4, hq=hq, hkv=hkv, s=512,
                                                d=128), dt)
       for g, hq, hkv in ((1, 4, 4), (5, 10, 2), (12, 24, 2))
       for dt in ("float32", "bfloat16")]
    + [(f"D=128 {hq}/{hkv} B=8 S=512 bfloat16 (decode)",
        dict(b=8, hq=hq, hkv=hkv, s=512, d=128), "bfloat16")
       for hq, hkv in ((40, 40), (40, 8), (96, 8))]
    + [(f"D=128 group 12 B=5 S=64 kv_len 7,8,9,1,64 {dt}",
        dict(b=5, hq=12, hkv=1, s=64, d=128, lens=(7, 8, 9, 1, 64)), dt)
       for dt in ("bfloat16", "float32")]
    # bf16 D=128 on the card only (names end in "(card)"): the tensor-core
    # instance, one cluster a (row, kv-head) at any group: groups 8 and 16
    # in one M-tile of 16 heads, group 5 at the split's kv_len edges, a
    # 32,768-position cache at group 12 (shares of 4096 and 2501 rows, past
    # a 64-row chunk: the second pass reloads), and group 20 in two
    # M-tiles, with shares of 1-3 chunks
    + [("D=128 group 8 B=4 S=512 bfloat16 (card)",
        dict(b=4, hq=16, hkv=2, s=512, d=128), "bfloat16"),
       ("D=128 group 16 B=4 S=512 bfloat16 (card)",
        dict(b=4, hq=16, hkv=1, s=512, d=128), "bfloat16"),
       ("D=128 group 5 B=5 S=64 kv_len 7,8,9,1,64 bfloat16 (card)",
        dict(b=5, hq=10, hkv=2, s=64, d=128, lens=(7, 8, 9, 1, 64)),
        "bfloat16"),
       ("D=128 group 12 B=2 S=32768 kv_len 32768,20001 bfloat16 (card)",
        dict(b=2, hq=12, hkv=1, s=32768, d=128, lens=(32768, 20001)),
        "bfloat16"),
       ("D=128 group 20 B=3 S=1100 kv_len 1100,517,9 bfloat16 (card)",
        dict(b=3, hq=40, hkv=2, s=1100, d=128, lens=(1100, 517, 9)),
        "bfloat16")]
    # bf16 at a head dim the tensor-core instance does not take (SMOKE's
    # 16): the CUDA-core kernel's bf16 instance
    + [("B=5 S=48 SMOKE bfloat16 (card)", dict(b=5, hq=4, hkv=2, s=48, d=16),
        "bfloat16")])
# (name, generator keyword arguments, k); the seed is the index
ROUTER_CASES = [
    ("T=4 E=32 k=8", dict(t=4, e=32), 8),
    ("T=17 E=32 k=8", dict(t=17, e=32), 8),
    ("T=256 E=32 k=8", dict(t=256, e=32), 8),
    ("T=9 E=4 k=2 SMOKE", dict(t=9, e=4), 2),
    ("T=5 E=32 k=32 every expert", dict(t=5, e=32), 32),
    # deepseek-v3's 256 experts, top-8 (8 experts a lane)
    ("T=64 E=256 k=8", dict(t=64, e=256), 8),
    ("T=17 E=64 k=6", dict(t=17, e=64), 6),
    # fewer than k nonzero probabilities: zeros chosen by index
    ("T=12 E=32 k=8 underflow", dict(t=12, e=32, underflow=True), 8),
    ("T=9 E=256 k=8 underflow", dict(t=9, e=256, underflow=True), 8),
    # whole runs of 4 experts a lane
    ("T=33 E=128 k=8", dict(t=33, e=128), 8),
    # ragged runs of 8 and 4 experts (E % 4 != 0), a partial run of 2,
    # and k = 32 over 256 experts
    ("T=7 E=250 k=8", dict(t=7, e=250), 8),
    ("T=7 E=99 k=5", dict(t=7, e=99), 5),
    ("T=7 E=37 k=4", dict(t=7, e=37), 4),
    ("T=5 E=256 k=32", dict(t=5, e=256), 32),
]

# tolerances of a kernel against its plain version, by the output's type:
# float32 sums in another order (a few ulps of values of size ~1-10);
# bfloat16 outputs may round one bf16 ulp apart (2^-8 relative) when the
# float32 values straddle a rounding boundary
TOL = {"float32": 2e-5, "bfloat16": 2.0 ** -7}
ROUTER_W_TOL = 1e-6
ROUTER_MARGIN = 1e-6


def within(got: torch.Tensor, want: torch.Tensor, dtype: str) -> float:
    """The largest |got - want| / max(1, |want|) (0.0 when equal); the
    caller compares it with TOL[dtype]."""
    g, w = got.double().cpu(), want.double().cpu()
    if g.numel() == 0:
        return 0.0
    return float(((g - w).abs() / w.abs().clamp(min=1.0)).max())


# --------------------------------------------------------------------------
# the serving kernels' on-card checks, shared by chip_smoke.py and
# tests/test_torch_cuda.py
# --------------------------------------------------------------------------

FLOAT_CASES = {"rmsnorm": RMS_CASES, "flash_attention": ATTN_CASES,
               "flash_decode": DECODE_CASES}


def rms_view_args(k: int, device) -> tuple:
    """(input tensors on `device`, output dtype name) of case k of
    RMS_VIEW_CASES: x and w contiguous views their offsets into a buffer
    (`to(device)` of a CPU view would copy it to an aligned base)."""
    _, shape, dt, x_off, w_off = RMS_VIEW_CASES[k]
    x, w = rms_inputs(100 + k, shape)

    def view(a, dtype, off):
        flat = to_dtype(a, dtype).reshape(-1).to(device)
        buf = torch.zeros(off + flat.numel(), dtype=flat.dtype, device=device)
        buf[off:] = flat
        return buf[off:].view(a.shape)
    return [view(x, dt, x_off), view(w, "float32", w_off)], dt


def float_args(kernel: str, k: int) -> tuple:
    """(CPU input tensors, output dtype name) of case k of a float
    serving kernel: rmsnorm, flash_attention or flash_decode."""
    _, kw, dt = FLOAT_CASES[kernel][k]
    if kernel == "rmsnorm":
        x, w = rms_inputs(k, **kw)
        return [to_dtype(x, dt), to_dtype(w, "float32")], dt
    if kernel == "flash_attention":
        return [to_dtype(x, dt) for x in attn_inputs(k, **kw)], dt
    q, kk, v, kv_len = decode_inputs(k, **kw)
    return ([to_dtype(x, dt) for x in (q, kk, v)]
            + [torch.from_numpy(kv_len)], dt)


def _abs_err(got: torch.Tensor, want: torch.Tensor) -> float:
    if got.dtype != want.dtype or got.shape != want.shape:
        raise AssertionError(f"dtype/shape {got.dtype}{tuple(got.shape)} vs "
                             f"{want.dtype}{tuple(want.shape)}")
    if got.numel() == 0:
        return 0.0
    return float((got.double().cpu() - want.double().cpu()).abs().max())


def check_float(fn, plain, args: list, dtype: str, device) -> tuple:
    """Kernel wrapper `fn` on `device` (exactly one launch) against its
    plain version `plain` on the same inputs, on the CPU and on `device`.
    Raises AssertionError when a type or shape differs or the error
    exceeds TOL[dtype]; returns (relative error, absolute error)."""
    before = fn.launches
    got = fn(*(a.to(device) for a in args))
    wants = [plain(*args), plain(*(a.to(device) for a in args))]
    torch.cuda.synchronize(device)
    if fn.launches != before + 1:
        raise AssertionError(f"{fn.__name__}: {fn.launches - before} "
                             f"launches, want 1")
    err = max(_abs_err(got, w) for w in wants)
    rel = max(within(got, w, dtype) for w in wants)
    if rel > TOL[dtype]:
        raise AssertionError(f"{fn.__name__}: error {rel} > {TOL[dtype]}")
    return rel, err


def check_router(fn, plain, k: int, device) -> tuple:
    """topk_router case k: the kernel wrapper `fn` on `device` (exactly
    one launch) against `plain` on the CPU and on `device`: weights
    within ROUTER_W_TOL, indices bitwise on every row whose order is
    decided (`router_margin_rows`), which must be at least half the rows.
    Raises AssertionError otherwise; returns (weight error, decided
    rows, rows)."""
    _, kw, topk = ROUTER_CASES[k]
    x = torch.from_numpy(router_inputs(k, **kw))
    before = fn.launches
    w, idx = fn(x.to(device), topk)
    wants = [plain(x, topk), plain(x.to(device), topk)]
    torch.cuda.synchronize(device)
    if fn.launches != before + 1:
        raise AssertionError(f"{fn.__name__}: {fn.launches - before} "
                             f"launches, want 1")
    rows = router_margin_rows(torch.softmax(x, -1).numpy(), topk,
                              ROUTER_MARGIN)
    err = max(_abs_err(w, w_ref) for w_ref, _ in wants)
    for _, idx_ref in wants:
        _abs_err(idx, idx_ref)
        if not np.array_equal(idx.cpu().numpy()[rows],
                              idx_ref.cpu().numpy()[rows]):
            raise AssertionError(f"{fn.__name__} case {k}: indices differ "
                                 f"on a decided row")
    if err > ROUTER_W_TOL or rows.sum() < len(rows) // 2:
        raise AssertionError(f"{fn.__name__} case {k}: weight error {err}, "
                             f"{int(rows.sum())}/{len(rows)} decided rows")
    return err, int(rows.sum()), len(rows)


# --------------------------------------------------------------------------
# the training kernels: the forward's training instance
# (`flash_attention_lse`) and the three backward kernels, on the
# training path's shapes (granite-moe-1b-a400m and the dense configs,
# microbatch 4 x 256 tokens) and the edge cases: S in {1, 17, 64, 256,
# 300} (300: a ragged last tile), GQA groups 1, 2, 4, 5, 8, 12 and 16
# (the bf16 backward splits a kv head over a cluster from group 4 on), D
# 16, 64 and 128, float32 and bfloat16;
# for the bf16 D=64 wgmma kernel also peaked scores (q, k x 4: where
# rounding P and dS to bf16 operands matters most), B=2 at S=300 and
# group 8 at S=256 (ragged tiles, a group over several heads and tiles);
# rmsnorm on one row, odd d, rows that are no multiple of the CTA count,
# d = 2048 and 2056 (the edge of its warp-a-row instance and just past),
# a width for each of that instance's register sizes (1, 2, 4 and 8
# 16-byte units a lane, bf16 and f32) and a row wider than 48 KB of dw
# partial; the router at k = 1, k = E
# and on planted ties.  Shared by chip_smoke.py and
# tests/test_torch_cuda.py.
# --------------------------------------------------------------------------

# the dense configs' attention heads (name, Hq, Hkv): qwen2.5-32b (GQA
# group 5), qwen1.5-32b (1), mistral-large-123b (12), all at D=128
DENSE_TRAIN = (("qwen2.5-32b 40/8", 40, 8), ("qwen1.5-32b 40/40", 40, 40),
               ("mistral-large-123b 96/8", 96, 8))
TRAIN_ATTN_CASES = (
    [(f"S={s} {dt}", dict(b=1, hq=16, hkv=8, s=s, d=64), dt)
     for s in (1, 17, 64, 256, 300) for dt in ("bfloat16", "float32")]
    + [(f"GQA group {g} S=64 {dt}", dict(b=2, hq=16, hkv=16 // g, s=64,
                                           d=64), dt)
       for g in (1, 2, 8) for dt in ("bfloat16", "float32")]
    + [(f"D=16 SMOKE B=2 S=33 {dt}", dict(b=2, hq=4, hkv=2, s=33, d=16), dt)
       for dt in ("bfloat16", "float32")]
    # the training path's shape: a microbatch of 4 sequences of 256
    + [("B=4 S=256 bfloat16 (training)", dict(b=4, hq=16, hkv=8, s=256,
                                              d=64), "bfloat16")]
    + [("peaked scores S=256 bfloat16", dict(b=1, hq=16, hkv=8, s=256,
                                             d=64, peak=4.0), "bfloat16")]
    + [(f"B=2 S=300 {dt}", dict(b=2, hq=16, hkv=8, s=300, d=64), dt)
       for dt in ("bfloat16", "float32")]
    + [(f"GQA group 8 S=256 {dt}", dict(b=2, hq=16, hkv=2, s=256, d=64),
        dt) for dt in ("bfloat16", "float32")]
    # large GQA groups at D=64, on a grid that leaves the card idle and
    # on one that nearly fills it
    + [(f"GQA group {g} B=2 S=300 bfloat16", dict(b=2, hq=2 * g, hkv=2,
                                                    s=300, d=64), "bfloat16")
       for g in (4, 5, 12, 16)]
    + [("GQA group 4 B=4 S=512 bfloat16",
        dict(b=4, hq=16, hkv=4, s=512, d=64), "bfloat16")]
    # the dense configs, D=128: their training shapes (a microbatch of 4
    # sequences of 256), ragged S, GQA groups 1-16, a long S,
    # peaked scores
    + [(f"D=128 {name} B=4 S=256 {dt} (training)",
        dict(b=4, hq=hq, hkv=hkv, s=256, d=128), dt)
       for name, hq, hkv in DENSE_TRAIN for dt in ("bfloat16", "float32")]
    + [(f"D=128 S={s} {dt}", dict(b=1, hq=10, hkv=2, s=s, d=128), dt)
       for s in (1, 17, 300) for dt in ("bfloat16", "float32")]
    + [(f"D=128 GQA group {g} B=2 S=130 {dt}", dict(b=2, hq=2 * g, hkv=2,
                                                     s=130, d=128), dt)
       for g in (1, 2, 4, 5, 8, 12, 16) for dt in ("bfloat16", "float32")]
    + [("D=128 peaked scores group 12 S=256 bfloat16",
        dict(b=1, hq=12, hkv=1, s=256, d=128, peak=4.0), "bfloat16")]
    + [("D=128 GQA group 4 B=4 S=512 bfloat16",
        dict(b=4, hq=8, hkv=2, s=512, d=128), "bfloat16")])
RMS_BWD_CASES = (
    [(f"{shape} {dt}", dict(shape=shape), dt)
     for shape in ((4, 256, 1024), (1, 1024), (5, 37), (3, 1031),
                   (64, 64), (2, 12288))
     for dt in ("bfloat16", "float32")]
    + [(f"{shape} {dt}", dict(shape=shape), dt)
       for shape, dt in (((1000, 1024), "bfloat16"), ((300, 2048), "bfloat16"),
                         ((300, 2056), "bfloat16"), ((300, 512), "bfloat16"),
                         ((300, 256), "float32"), ((300, 512), "float32"))]
    # the dense configs' training microbatch at their widths
    + [(f"{shape} {dt} (dense training)", dict(shape=shape), dt)
       for shape in ((4, 256, 5120), (4, 256, 12288))
       for dt in ("bfloat16", "float32")])
ROUTER_BWD_CASES = [
    ("T=1024 E=32 k=8 (training)", dict(t=1024, e=32), 8),
    ("T=17 E=32 k=1", dict(t=17, e=32), 1),
    ("T=17 E=32 k=32 every expert", dict(t=17, e=32), 32),
    ("T=9 E=4 k=2 SMOKE", dict(t=9, e=4), 2),
    ("T=33 E=256 k=8", dict(t=33, e=256), 8),
    ("T=7 E=99 k=5", dict(t=7, e=99), 5),
    ("T=12 E=32 k=8 underflow", dict(t=12, e=32, underflow=True), 8)]
# backward tolerances against the plain vjp: float32 sums of up to
# 8 heads x 300 rows in another order (values of size ~1-10); bfloat16
# gradients may round one bf16 ulp apart.  lse: float32 either way.
BWD_TOL = {"float32": 1e-4, "bfloat16": 2.0 ** -7}
LSE_TOL = 1e-4


def _grads(seed, shape, dtype, device):
    rng = np.random.default_rng(10_000 + seed)
    return to_dtype(rng.standard_normal(shape).astype(np.float32),
                    dtype).to(device)


def check_attn_train(FA, k: int, device) -> float:
    """Case k of TRAIN_ATTN_CASES on `device`: the training instance
    `flash_attention_lse` against `flash_attention_lse_ref` (output within
    TOL, lse within LSE_TOL), then `flash_attention_bwd` against
    `flash_attention_bwd_ref` on the same (o, lse, dO), each within
    BWD_TOL; one launch each.  Returns the largest absolute error of
    each: (forward, backward)."""
    name, kw, dt = TRAIN_ATTN_CASES[k]
    q, kk, v = (to_dtype(x, dt).to(device) for x in attn_inputs(k, **kw))
    before = (FA.flash_attention_lse.launches,
              FA.flash_attention_bwd.launches)
    o, lse = FA.flash_attention_lse(q, kk, v)
    o_ref, lse_ref = FA.flash_attention_lse_ref(q, kk, v)
    do = _grads(k, tuple(q.shape), dt, device)
    got = FA.flash_attention_bwd(q, kk, v, o_ref, do, lse_ref)
    want = FA.flash_attention_bwd_ref(q, kk, v, o_ref, do, lse_ref)
    torch.cuda.synchronize(device)
    if (FA.flash_attention_lse.launches - before[0],
            FA.flash_attention_bwd.launches - before[1]) != (1, 1):
        raise AssertionError(f"attention training {name}: launches")
    errs = [_abs_err(o, o_ref), _abs_err(lse, lse_ref)]
    if within(o, o_ref, dt) > TOL[dt] \
            or within(lse, lse_ref, "float32") > LSE_TOL:
        raise AssertionError(f"flash_attention_lse {name}: output "
                             f"{within(o, o_ref, dt)} lse "
                             f"{within(lse, lse_ref, 'float32')}")
    for g, w, what in zip(got, want, ("dq", "dk", "dv")):
        errs.append(_abs_err(g, w))
        if within(g, w, dt) > BWD_TOL[dt]:
            raise AssertionError(f"flash_attention_bwd {name}: {what} "
                                 f"error {within(g, w, dt)}")
    return max(errs[:2]), max(errs[2:])


def check_rms_bwd(RN, k: int, device) -> float:
    """Case k of RMS_BWD_CASES: `rmsnorm_bwd` on `device` (one launch)
    against `rmsnorm_bwd_ref` on the same inputs, dx within BWD_TOL of
    its type and dw (float32) within BWD_TOL["float32"].  Returns the
    largest absolute error."""
    name, kw, dt = RMS_BWD_CASES[k]
    x, w = rms_inputs(200 + k, **kw)
    x, w = to_dtype(x, dt).to(device), to_dtype(w, "float32").to(device)
    dy = _grads(k, tuple(x.shape), dt, device)
    before = RN.rmsnorm_bwd.launches
    dx, dw = RN.rmsnorm_bwd(x, w, dy)
    dx_ref, dw_ref = RN.rmsnorm_bwd_ref(x, w, dy)
    torch.cuda.synchronize(device)
    if RN.rmsnorm_bwd.launches != before + 1:
        raise AssertionError(f"rmsnorm_bwd {name}: launches")
    if within(dx, dx_ref, dt) > BWD_TOL[dt] \
            or within(dw, dw_ref, "float32") > BWD_TOL["float32"]:
        raise AssertionError(f"rmsnorm_bwd {name}: dx "
                             f"{within(dx, dx_ref, dt)} dw "
                             f"{within(dw, dw_ref, 'float32')}")
    return max(_abs_err(dx, dx_ref), _abs_err(dw, dw_ref))


def check_router_bwd(TR, k: int, device) -> float:
    """Case k of ROUTER_BWD_CASES: `topk_router_bwd` on `device` (one
    launch) against `topk_router_bwd_ref` on the same (w, idx, dw), the
    router's own output on those logits, within ROUTER_W_TOL.  Returns
    the largest absolute error."""
    name, kw, topk = ROUTER_BWD_CASES[k]
    logits = torch.from_numpy(router_inputs(300 + k, **kw)).to(device)
    w, idx = TR.topk_router_ref(logits, topk)
    dw = _grads(k, tuple(w.shape), "float32", device)
    before = TR.topk_router_bwd.launches
    got = TR.topk_router_bwd(w, idx, dw, kw["e"])
    want = TR.topk_router_bwd_ref(w, idx, dw, kw["e"])
    torch.cuda.synchronize(device)
    if TR.topk_router_bwd.launches != before + 1:
        raise AssertionError(f"topk_router_bwd {name}: launches")
    err = _abs_err(got, want)
    if err > ROUTER_W_TOL:
        raise AssertionError(f"topk_router_bwd {name}: error {err}")
    return err
