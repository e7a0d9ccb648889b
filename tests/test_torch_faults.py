"""Protocol faults in the port (`repro_torch.workloads.faults`) against
the JAX package's, at n=8 on the lock and queue workloads.

`no_promotion` strips the promotion from remote acquires: the released
writes stay stranded in the owners' L1s, and every workload's check must
turn red in both packages, with the same counters, verdict and final
state.  `serialize_remote` strips the batched remote twins: on
producer_consumer_mc, whose drains the batched engine co-schedules, it
leaves the final state bitwise unchanged except the PA-TBL, whose
batched content is a superset of the serialized one (the reference's
own contract, tests/test_ops.py::test_multi_consumer_serial_batched_equivalent).
The helpers are test_torch_workloads.py's.
"""
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from repro.core import protocol as JP  # noqa: E402
from repro.workloads import faults as jfaults  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import protocol as P  # noqa: E402
from repro_torch.workloads import faults  # noqa: E402
from test_torch_workloads import (N, _jax_run, _port_run,  # noqa: E402
                                  _same_tree)

torch.use_deterministic_algorithms(True)


def test_derive_renames_and_overrides():
    srsp = P.get_protocol("srsp")
    d = faults.derive(srsp, "x", acquire_rem_b=None)
    assert d.name == "srsp+x" and not d.remote_batchable
    assert d.release_rem_b is srsp.release_rem_b
    assert "srsp+x" not in P.PROTOCOLS
    assert faults.no_promotion(srsp).acquire_rem \
        is faults._skip_promotion_acquire


@pytest.mark.parametrize("name", ["reader_lock", "producer_consumer",
                                  "producer_consumer_mc"])
def test_no_promotion_is_red_in_both_packages(name):
    jfinal, jcheck = _jax_run(name, "srsp", "serial",
                              jfaults.no_promotion(JP.get_protocol("srsp")))
    broken = faults.no_promotion(P.get_protocol("srsp"))
    assert broken.name == "srsp+no_promotion" and not broken.remote_batchable
    for engine in ("serial", "fused"):
        tfinal, tcheck = _port_run(name, "srsp", engine, broken)
        assert not tcheck["ok"] and tcheck["check_fails"] > 0, tcheck
        assert tcheck == jcheck
        _same_tree(tfinal, jfinal, (name, engine))
    jax.clear_caches()


def test_serialize_remote_keeps_the_final_state():
    """producer_consumer_mc, srsp, batched engine: stripping the batched
    remote twins changes nothing but the PA-TBL, whose batched content is
    a superset of the serialized one; the serialized run equals the JAX
    package's bit for bit."""
    name = "producer_consumer_mc"
    serial = faults.serialize_remote(P.get_protocol("srsp"))
    assert serial.name == "srsp+serial_remote"
    assert not serial.remote_batchable and serial.acquire_rem_b is None
    fa, ca = _port_run(name, "srsp", "batched")
    fb, cb = _port_run(name, "srsp", "batched", serial)
    assert ca == cb and ca["ok"]
    for part in fa.store._fields:
        if part != "pa":
            for x, y in zip(convert.leaves(getattr(fa.store, part)),
                            convert.leaves(getattr(fb.store, part))):
                assert torch.equal(x, y), part
    for x, y in zip(fa[1:], fb[1:]):        # the workload's bookkeeping
        assert torch.equal(x, y)
    for c in range(N):
        got = set(fa.store.pa.addrs[c].flatten().tolist()) - {-1}
        want = set(fb.store.pa.addrs[c].flatten().tolist()) - {-1}
        assert want <= got, (c, want, got)
    jfinal, _ = _jax_run(name, "srsp", "serial",
                         jfaults.serialize_remote(JP.get_protocol("srsp")))
    _same_tree(fb, jfinal, "serialized")
    jax.clear_caches()
