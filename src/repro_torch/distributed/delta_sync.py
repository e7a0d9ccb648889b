"""The parameter banks the cross-pod delta sync is driven with, and the
check of a sync against the JAX reference's golden file, shared by the
CPU test (`tests/test_torch_hier_sync.py`, which also writes the file)
and `chip_smoke.py` phase 8 (which holds the card to it).

`small_bank` is the data of tests/test_distributed.py:82-93.
`bench_banks` is the port's copy of the bank generator of
`benchmarks/delta_sync_bench.py:28-45`: the same numpy RNG calls in the
same order from `default_rng(0)`, so its three banks are the bench's
bits.  `example_bank` is the bank of `examples/asymmetric_cross_pod.py:30-39`
(a 32-expert FFN bank, 3 experts routed per pod, `max_dirty=16`).
`granite_embedding_bank` applies the bench's embedding-rows rule to the
real size of granite-moe-1b-a400m's embedding (49155 x 1024).

A `Bank` holds numpy arrays: `base` [nb, bs] (every pod's value at the
last sync) and `banks` [n_pods, nb, bs] (each pod's value after its
local updates), both float32.

`golden/hier_sync.json` holds, for each of the small, example and bench
banks and each mode (selective float32, selective int8, full): the
index list and overflow flag, the promoted blocks, `syncs` and both
byte counters (exact), sha256 digests of the int8 payload `q`, its
`scale` and the new residual `ef` (exact), and float64 sums over each
block of the new bank.
"""
from __future__ import annotations

import hashlib
import json
import pathlib
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.distributed import compress as CMP
from repro_torch.distributed import hier_sync as HS

GOLDEN = pathlib.Path(__file__).resolve().parents[1] / "golden" \
    / "hier_sync.json"
N_PODS = 4
MODES = ("selective_f32", "selective_int8", "full")
BANK_TOL = 2e-6       # bank and ref vs the JAX CPU run: 1-2 f32 ulps
MEAN_TOL = 1e-5       # the float modes vs the mean across pods
                      # (tests/test_distributed.py:125-127)

# (n_blocks, block_size, dirty share, label), in the bench's order
BENCH = ((256, 2048, 0.03, "moe_expert_bank"),     # ~granite expert FFN
         (1024, 1024, 0.02, "embedding_rows"),
         (256, 2048, 0.50, "dense_layer(worst)"))
EXAMPLE = (32, 4096, 3, 16)       # n_blocks, block_size, experts, max_dirty
GRANITE_VOCAB, GRANITE_D = 49155, 1024


class Bank(NamedTuple):
    label: str
    base: np.ndarray
    banks: np.ndarray
    max_dirty: int


def bench_max_dirty(nb: int, frac: float, n_pods: int = N_PODS) -> int:
    return max(8, int(nb * frac * n_pods * 2))


def _draw(rng, nb, bs, k, n_pods):
    """The bench's draws for one bank: the base, then per pod k distinct
    rows each nudged by 0.01 * normal."""
    base = rng.normal(size=(nb, bs)).astype(np.float32)
    banks = np.broadcast_to(base, (n_pods, nb, bs)).copy()
    for pod in range(n_pods):
        idx = rng.choice(nb, size=k, replace=False)
        banks[pod, idx] += 0.01 * rng.normal(size=(k, bs))
    return base, banks


def small_bank(seed: int = 0) -> Bank:
    """4 pods, 64 x 32, each pod nudging 3 blocks of its own by a unit
    normal; max_dirty 16."""
    nb, bs = 64, 32
    rng = np.random.default_rng(seed)
    base = rng.normal(size=(nb, bs)).astype(np.float32)
    banks = np.broadcast_to(base, (N_PODS, nb, bs)).copy()
    for pod in range(N_PODS):
        for b in rng.choice(nb, size=3, replace=False):
            banks[pod, b] += rng.normal(size=bs).astype(np.float32)
    return Bank("test_distributed", base, banks, 16)


def bench_banks(n_pods: int = N_PODS) -> list:
    """The bench's three banks, drawn in its order from one stream."""
    rng = np.random.default_rng(0)
    out = []
    for nb, bs, frac, label in BENCH:
        base, banks = _draw(rng, nb, bs, max(1, int(nb * frac)), n_pods)
        out.append(Bank(label, base, banks, bench_max_dirty(nb, frac,
                                                            n_pods)))
    return out


def example_bank(n_pods: int = N_PODS) -> Bank:
    nb, bs, experts, max_dirty = EXAMPLE
    base, banks = _draw(np.random.default_rng(0), nb, bs, experts, n_pods)
    return Bank("example_experts", base, banks, max_dirty)


def granite_embedding_bank(seed: int = 0, n_pods: int = N_PODS) -> Bank:
    """granite-moe-1b-a400m's embedding at its real size under the
    bench's embedding-rows rule: dirty share 0.02, 983 rows per pod,
    max_dirty 7864."""
    nb, bs, frac = GRANITE_VOCAB, GRANITE_D, 0.02
    base, banks = _draw(np.random.default_rng(seed), nb, bs,
                        max(1, int(nb * frac)), n_pods)
    return Bank("granite_embedding", base, banks,
                bench_max_dirty(nb, frac, n_pods))


def golden_banks() -> list:
    """The banks of the golden file, in its order."""
    return [small_bank(), example_bank()] + bench_banks()


def load_golden(path=GOLDEN) -> dict:
    with open(path) as f:
        return json.load(f)


def digest(x) -> str:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return hashlib.sha256(np.ascontiguousarray(x).tobytes()).hexdigest()


def sync_fn(bank: Bank, mode: str):
    n_pods, nb, bs = bank.banks.shape
    return HS.make_pod_sync(n_pods, nb, bs, max_dirty=bank.max_dirty,
                            use_int8=mode == "selective_int8",
                            selective=mode != "full")


def stacked(bank: Bank, device) -> tuple:
    """(the pods' banks, bank_init of the base) as tensors on `device`."""
    base = torch.from_numpy(bank.base).to(device)
    return (torch.from_numpy(bank.banks).to(device),
            HS.bank_init(base.expand(bank.banks.shape).contiguous()))


def check_bank(bank: Bank, rec, device) -> dict:
    """Run every mode once on `device` and hold it to the golden record
    `rec` (None: the mean only).  Exact: the index list, overflow,
    promoted blocks, `syncs`, both byte counters and the int8 digests;
    each block's sum within BANK_TOL per element; the new bank of the
    float modes within MEAN_TOL of the float64 mean across pods, the
    int8 one within half a quantization step (the pods' mean scale / 2)
    more.  Raises AssertionError on a mismatch; returns the errors."""
    banks, st0 = stacked(bank, device)
    mean = bank.banks.mean(0, dtype=np.float64)
    union = HS.dirty_mask(banks, st0).any(0)
    idx, overflow = HS.dirty_list(union, bank.max_dirty)
    delta = banks - st0.ref
    q, scale, _ = CMP.compress_blocks(delta, CMP.EFState(st0.ef), idx)
    # int8: each listed row may be off the mean by the pods' mean half step
    slack = np.zeros(bank.base.shape[0])
    if not bool(overflow):
        ids = idx.cpu().numpy()
        half = scale.double().mean(0).cpu().numpy() / 2
        slack[ids[ids >= 0]] = half[ids >= 0]
    del delta
    out = {"n_blocks": int(bank.base.shape[0]),
           "listed": int((idx >= 0).sum()), "overflow": bool(overflow)}
    if rec is not None:
        _expect(idx.cpu().tolist() == rec["idx"], bank, "idx")
        _expect(bool(overflow) == rec["overflow"], bank, "overflow")
    for mode in MODES:
        new, st = sync_fn(bank, mode)(banks, st0)
        new = new.cpu().numpy()
        err = np.abs(new - mean[None]).max(axis=(0, 2))
        allowed = MEAN_TOL + (slack if mode == "selective_int8" else 0.0)
        _expect((err <= allowed).all(), bank, f"{mode}: mean error "
                f"{err.max()} beyond the bound")
        res = {"mean_err": float(err.max()),
               "bytes_selective": float(st.bytes_selective[0]),
               "bytes_full": float(st.bytes_full[0])}
        if rec is not None:
            want = rec["modes"][mode]
            prom = torch.nonzero(st.promoted[0]).flatten().cpu().tolist()
            _expect(prom == want["promoted"], bank, f"{mode} promoted")
            for key in ("syncs", "bytes_selective", "bytes_full"):
                got = getattr(st, key).cpu().numpy()
                _expect((got == want[key]).all(), bank,
                        f"{mode} {key} {got} != {want[key]}")
            sums = new.astype(np.float64).sum(-1)
            dsum = float(np.abs(sums - np.asarray(want["block_sums"])).max())
            _expect(dsum <= BANK_TOL * bank.base.shape[1], bank,
                    f"{mode} block sums off by {dsum}")
            res["block_sum_err"] = dsum
            if mode == "selective_int8":
                got = {"q": digest(q), "scale": digest(scale),
                       "ef": digest(st.ef)}
                _expect(got == want["sha256"], bank, f"int8 digests {got}")
        out[mode] = res
        del new, st
    return out


def _expect(ok: bool, bank: Bank, what: str) -> None:
    if not ok:
        raise AssertionError(f"hier_sync {bank.label}: {what}")
