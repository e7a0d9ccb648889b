"""The replica axis against the JAX package, continued
(test_torch_many.py has the helpers and the comparison rule):
kv_serving, replaying the reference's traces.  The reference's
`jax.vmap(init_state)` draws each replica's trace as its seed alone
does; the port replays those traces (`kv_serving.with_traces`), since
its own float samplers are a few ulps off."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.traffic import trace as JT  # noqa: E402
from repro_torch import convert, workloads  # noqa: E402
from repro_torch.traffic import trace as TR  # noqa: E402
from repro_torch.workloads import harness  # noqa: E402
from test_torch_many import (N, SEEDS, check_cell,  # noqa: E402,F401
                             no_vmap_fallback, port_bench, same_port)
from test_torch_workloads import _same_tree  # noqa: E402

torch.use_deterministic_algorithms(True)


def _jax_traces(b):
    cfg = b.wl.cfg
    return [TR.RequestTrace(*(torch.from_numpy(np.array(c)) for c in
                              JT.generate(cfg.traffic, N, cfg.n_pages, s)))
            for s in SEEDS]


def _replayed(b, init):
    """The port's replicas on the reference's traces, held equal to the
    reference's stacked initial state."""
    st = workloads.get("kv_serving").with_traces(b, _jax_traces(b)).state
    _same_tree(st, init, "kv_serving init")
    return st


@pytest.mark.parametrize("engine", ["fused", "batched"])
def test_kv_serving_many_matches_jax(engine):
    check_cell("kv_serving", "srsp", engine, states=_replayed)


def test_with_traces_keeps_own_lanes():
    """A None trace keeps that lane's own draw from `states`; the others
    take the given trace."""
    mod = workloads.get("kv_serving")
    b = port_bench("kv_serving", "srsp")
    own = harness.init_many(mod.init_state, b.wl, SEEDS, "cpu")
    tr = _jax_traces(b)
    st = mod.with_traces(b, [tr[0], None], own).state
    same_port(harness.lane(st, 1), harness.lane(own, 1), "own lane")
    same_port(harness.lane(st, 0),
              mod.with_trace(b._replace(state=harness.lane(own, 0)),
                             tr[0]).state, "replayed lane")
    back = convert.to_numpy(st)
    assert back.streams.arrival.shape == (len(SEEDS), N, 24)
