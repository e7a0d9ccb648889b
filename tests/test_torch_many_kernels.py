"""The replica instances' plain versions against `jax.vmap` of the JAX
package's references, bit for bit, on the replica case lists of
`repro_torch.kernels.cases` (the lists the card runs the kernels on);
the out-of-range plane_commit case against the Pallas kernel in
interpret mode under `jax.vmap`, whose clamping the reference leaves
out.  On the CPU each replica wrapper takes its plain version.  Also:
under `torch.func.vmap` each kernel wrapper reaches its replica
instance once for all replicas (the custom op's vmap rule), and a cell
of `golden/many.json` runs through the port on the CPU."""
import json
import pathlib
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.fused_turn import ref as JFT  # noqa: E402
from repro.kernels.fused_turn.kernel import plane_commit_pallas  # noqa: E402
from repro.kernels.selective_flush import ref as JSF  # noqa: E402
from repro_torch.kernels import cases as C  # noqa: E402
from repro_torch.kernels.fused_turn import ops as FT  # noqa: E402
from repro_torch.kernels.selective_flush import ops as SF  # noqa: E402
from repro_torch.workloads import sweep  # noqa: E402

torch.use_deterministic_algorithms(True)

GOLDEN = pathlib.Path(__file__).resolve().parents[1] / "src" \
    / "repro_torch" / "golden" / "many.json"


def _ids(cases):
    return [c[0] for c in cases]


def _same(got, want):
    want = np.asarray(want)
    got = got.numpy()
    np.testing.assert_array_equal(
        got.view(want.dtype) if got.dtype != want.dtype else got, want)


@pytest.mark.parametrize("packed", [True, False], ids=["packed", "bool"])
@pytest.mark.parametrize("k", range(len(C.DRAIN_MANY_CASES)),
                         ids=_ids(C.DRAIN_MANY_CASES))
def test_drain_writeback_many_matches_jax_vmap(k, packed):
    _, kw, reps, idle = C.DRAIN_MANY_CASES[k]
    xs = C.stacked(C.dw_inputs, reps, k, idle, **kw, bool_mask=not packed)
    want = jax.vmap(JSF.drain_writeback_ref)(*(jnp.asarray(x) for x in xs))
    fn = SF.drain_writeback_many if packed else SF.drain_writeback_bool_many
    _same(fn(*(C.to_torch(x) for x in xs)), want)
    assert fn.launches == 0                 # CPU tensors: plain version


@pytest.mark.parametrize("k", range(len(C.COMMIT_MANY_CASES)),
                         ids=_ids(C.COMMIT_MANY_CASES))
def test_plane_commit_many_matches_jax_vmap(k):
    _, kw, reps, idle = C.COMMIT_MANY_CASES[k]
    xs = C.stacked(C.pc_inputs, reps, k, idle, **kw)
    js = [jnp.asarray(x) for x in xs]
    if kw.get("oor"):
        want = jax.vmap(lambda *a: plane_commit_pallas(*a, interpret=True))(
            *js)
    else:
        want = jax.vmap(JFT.plane_commit_ref)(*js)
    got = FT.plane_commit_many(*(C.to_torch(x) for x in xs))
    for g, w in zip(got, want):
        _same(g, w)


@pytest.mark.parametrize("k", range(len(C.PLAN_MANY_CASES)),
                         ids=_ids(C.PLAN_MANY_CASES))
def test_trip_plan_many_matches_jax_vmap(k):
    _, kw, reps, idle, cap, fenced = C.PLAN_MANY_CASES[k]
    xs = C.stacked(C.plan_inputs, reps, k, idle, **kw)
    hor = C.horizons(xs[0], fenced)
    raddr = xs[4] if cap else None
    want = jax.vmap(JFT.trip_plan_ref,
                    in_axes=(0, 0, 0, 0, 0 if cap else None,
                             None if hor is None else 0))(
        *(jnp.asarray(x) for x in xs[:4]),
        None if raddr is None else jnp.asarray(raddr),
        None if hor is None else jnp.asarray(hor))
    got = FT.trip_plan_many(*(C.to_torch(x) for x in xs[:4]),
                            None if raddr is None else C.to_torch(raddr),
                            None if hor is None else torch.from_numpy(hor),
                            remote_cap=cap)
    for g, w in zip(got, want):
        _same(g, w)


def test_vmap_reaches_each_replica_instance_once(monkeypatch):
    """`torch.func.vmap` of each wrapper over replica-batched CPU tensors
    calls its replica instance once for every replica (no per-example
    fallback), and each replica's result is its solo call's."""
    calls = []
    for mod, name in ((SF, "drain_writeback_many"),
                      (FT, "plane_commit_many"), (FT, "trip_plan_many")):
        real = getattr(mod, name)

        def counted(*a, real=real, name=name, **kw):
            calls.append(name)
            return real(*a, **kw)
        monkeypatch.setattr(mod, name, counted)
    dw = [C.to_torch(x) for x in C.stacked(C.dw_inputs, 3, 0, (1,), nb=32,
                                           w=16, m=64)]
    pc = [C.to_torch(x) for x in C.stacked(C.pc_inputs, 3, 0, n=8, nb=4,
                                           w=16)]
    tp = [C.to_torch(x) for x in C.stacked(C.plan_inputs, 3, 0, n=8)]
    with warnings.catch_warnings():
        warnings.filterwarnings("error", message=".*performance drop.*")
        got_dw = torch.func.vmap(SF.drain_writeback)(*dw)
        got_pc = torch.func.vmap(lambda *a: tuple(FT.plane_commit(*a)))(*pc)
        got_tp = torch.func.vmap(lambda *a: tuple(FT.trip_plan(
            *a, None, remote_cap=True)))(*tp)
    assert calls == ["drain_writeback_many", "plane_commit_many",
                     "trip_plan_many"]
    for r in range(3):
        assert torch.equal(got_dw[r], SF.drain_writeback(*(a[r] for a in dw)))
        for g, x in zip(got_pc, FT.plane_commit(*(a[r] for a in pc))):
            assert torch.equal(g[r], x)
        for g, x in zip(got_tp, FT.trip_plan(*(a[r] for a in tp), None,
                                             remote_cap=True)):
            assert torch.equal(g[r], x)


def test_solo_calls_stay_off_the_custom_ops(monkeypatch):
    """Outside vmap a wrapper never reaches a custom op: the solo path
    keeps its own dispatch."""
    from repro_torch.kernels import common
    monkeypatch.setattr(common, "replica_op", None)
    xs = [C.to_torch(x) for x in C.plan_inputs(0, 8)]
    FT.trip_plan(*xs, None, remote_cap=True)
    SF.drain_writeback(*(C.to_torch(x) for x in C.dw_inputs(0, 8, 16, 8)))
    FT.plane_commit(*(C.to_torch(x) for x in C.pc_inputs(0, 8, 4, 16)))


def test_many_golden_kv_directory_cell_on_cpu():
    """kv_directory srsp fused at n=64 over seeds 4 and 5 in one replica
    run: every lane `==` the reference's `run_fused_many` lanes."""
    cell = next(c for c in json.loads(GOLDEN.read_text())["cells"]
                if (c["workload"], c["scenario"], c["engine"])
                == ("kv_directory", "srsp", "fused"))
    row = sweep.run_vmapped_cell("kv_directory", "srsp", cell["n_agents"],
                                 cell["seeds"], "fused", device="cpu",
                                 warmup=False)
    assert row["lanes"] == cell["lanes"]
