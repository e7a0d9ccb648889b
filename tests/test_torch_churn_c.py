"""The batched trip fenced at an event horizon, against the JAX package.

`harness._batched_trip(wl, s, can_l, can_r, horizon, ops)` with a finite
horizon masks the no-remote path's readiness, the local batch and the
co-scheduled remote batch's candidates at `clocks < horizon`, and leaves
the serial fallback unfenced.  From the same states (each workload at
n=8, advanced trip by trip), the port's fenced trip and the JAX one
(jitted) give the same leaves, for a horizon just past the next turn's
clock, one at the median candidate clock, one at or below the next
turn's clock (the serial fallback) and none (BIG).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import workloads as JW  # noqa: E402
from repro.workloads import harness as JH  # noqa: E402
from repro_torch import workloads  # noqa: E402
from repro_torch.workloads import harness  # noqa: E402
from test_torch_churn_b import same_tree, to_jax  # noqa: E402

torch.use_deterministic_algorithms(True)

N, SEED, TRIPS = 8, 3, 16


def _horizon(clocks, ready, k):
    """The k-th fence: just past mcc, the median candidate clock, at mcc
    (the serial fallback), or no fence."""
    cand = np.sort(clocks[ready]) if ready.any() else np.zeros(1,
                                                               np.float32)
    pick = [cand[0] + np.float32(0.5), cand[len(cand) // 2], cand[0],
            np.float32(harness.BIG)][k % 4]
    return np.float32(pick)


@pytest.mark.parametrize("name", ["kv_directory", "reader_lock",
                                  "producer_consumer_mc", "worksteal"])
def test_fenced_batched_trip_matches_jax(name):
    tb = workloads.get(name).build("srsp", N, seed=SEED, device="cpu")
    jb = JW.get(name).build("srsp", N, seed=SEED)
    trip = jax.jit(JH._batched_trip, static_argnums=(0,))
    wl, s, ops = tb.wl, tb.state, tb.ops
    fenced = 0
    for k in range(TRIPS):
        if not bool(wl.live(wl, s, *ops)):
            break
        can_l = wl.can_local(wl, s, *ops)
        can_r = wl.can_remote(wl, s, *ops)
        clocks = s.store.counters.cycles.numpy()
        ready = (can_l | can_r).numpy()
        h = _horizon(clocks, ready, k)
        fenced += int((ready & (clocks >= h)).any())
        got = harness._batched_trip(wl, s, can_l, can_r, torch.tensor(h),
                                    ops)
        want = trip(jb.wl, to_jax(s, jb.state), jnp.asarray(can_l.numpy()),
                    jnp.asarray(can_r.numpy()), jnp.float32(h), jb.ops)
        same_tree(got, want, (name, k, float(h)))
        s = got
    assert fenced >= 2, (name, fenced)
