"""The crash red/green pins of tests/test_churn.py, the port against the
live JAX run (this file: worksteal and reader_lock; test_torch_churn_e.py
and _f.py: producer_consumer and kv_directory).

Each pin is srsp at n=4 seed 3 on the batched elastic engine with a
CRASH event: green with the recovery drain, red under
`faults.lease_never_expires`.  The port's final elastic state equals the
JAX one leaf for leaf and its check is the JAX check; green is ok with
one recovery, red is not ok with none, and the victim is retired.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from repro import workloads as JW  # noqa: E402
from repro.core import protocol as JP  # noqa: E402
from repro.workloads import faults as JF  # noqa: E402
from repro.workloads import harness as JH  # noqa: E402
from repro_torch import workloads  # noqa: E402
from repro_torch.core import protocol as P  # noqa: E402
from repro_torch.workloads import faults, harness  # noqa: E402
from test_torch_churn_b import same_tree  # noqa: E402

torch.use_deterministic_algorithms(True)

N, SEED = 4, 3
# tests/test_churn.py's PINS: (workload, fault, victim, at, CRASH clock,
# build keywords)
PINS = {
    "worksteal": ("crash_holding_lock", 0, 5.0, 400.0, {"n_chunks_max": 12}),
    "reader_lock": ("crash_holding_lock", 0, 100.0, 160.0, {}),
    "kv_directory": ("crash_dirty", 2, 60.0, 120.0, {}),
    "producer_consumer": ("crash_dirty", 3, 12.0, 30.0, {}),
}


def run_both(name, jproto, proto, engine, events, **kw):
    """(port final, port check, JAX final, JAX check) of one elastic run
    at n=4 seed 3, srsp."""
    jb = JH.make_elastic(JW.get(name).build("srsp", N, seed=SEED,
                                            proto=jproto, **kw), events)
    jfin = JH.runner(engine)(jb.wl, jb.state, *jb.ops)
    tb = harness.make_elastic(workloads.get(name).build(
        "srsp", N, seed=SEED, proto=proto, device="cpu", **kw), events)
    fin = harness.runner(engine)(tb.wl, tb.state, *tb.ops)
    out = fin, tb.check(fin), jfin, jb.check(jfin)
    jax.clear_caches()
    return out


def check_pin(name, green):
    fault, victim, at, evt, kw = PINS[name]
    jproto = getattr(JF, fault)(JP.get_protocol("srsp"), victim, at)
    proto = getattr(faults, fault)(P.get_protocol("srsp"), victim, at)
    if not green:
        jproto = JF.lease_never_expires(jproto)
        proto = faults.lease_never_expires(proto)
    fin, res, jfin, jres = run_both(name, jproto, proto, "batched_elastic",
                                    [(evt, victim, "crash")], **kw)
    same_tree(fin, jfin, (name, green))
    assert res == jres, (name, res, jres)
    assert res["ok"] == green and (res["check_fails"] > 0) != green, res
    assert float(fin.s.store.counters.recoveries) == float(green)
    assert not bool(fin.alive[victim])
    assert float(np.sum(np.asarray(jfin.s.store.counters.recoveries))) \
        == float(green)


@pytest.mark.parametrize("green", [True, False], ids=["green", "red"])
@pytest.mark.parametrize("name", ["worksteal", "reader_lock"])
def test_crash_pin_matches_jax(name, green):
    check_pin(name, green)
