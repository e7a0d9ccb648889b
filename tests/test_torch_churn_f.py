"""kv_directory's elastic runs, the port against the live JAX run, n=4
seed 3:

* its crash red/green pin of tests/test_churn.py (`check_pin` of
  test_torch_churn_d.py);
* leave and join on both elastic engines: agent 2 leaves at clock 50
  (reclaimed at once, lease 0) and joins again at 150 with one more
  update to make.  Each engine's final elastic state equals the JAX one
  leaf for leaf, the check is green with one recovery and agent 2
  alive, and the two engines agree on every leaf (churn serializes
  alike in both).
"""
import pytest

torch = pytest.importorskip("torch")

from repro.core import protocol as JP  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import protocol as P  # noqa: E402
from test_torch_churn_b import same_tree  # noqa: E402
from test_torch_churn_d import check_pin, run_both  # noqa: E402

torch.use_deterministic_algorithms(True)

LEAVE_JOIN = [(50.0, 2, "leave"), (150.0, 2, "join")]
FINALS = {}


@pytest.mark.parametrize("green", [True, False], ids=["green", "red"])
def test_crash_pin_matches_jax(green):
    check_pin("kv_directory", green)


@pytest.mark.parametrize("engine", ["serial_elastic", "batched_elastic"])
def test_leave_join_matches_jax(engine):
    fin, res, jfin, jres = run_both("kv_directory", JP.get_protocol("srsp"),
                                    P.get_protocol("srsp"), engine,
                                    LEAVE_JOIN)
    same_tree(fin, jfin, engine)
    assert res == jres and res["ok"], (res, jres)
    assert bool(fin.alive[2])
    assert float(fin.s.store.counters.recoveries) == 1.0
    FINALS[engine] = fin
    if len(FINALS) == 2:
        for x, y in zip(*(convert.leaves(f) for f in FINALS.values())):
            assert torch.equal(x, y)
