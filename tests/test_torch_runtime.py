"""The port's runtime (`repro_torch.runtime`): checkpoints, fault
tolerance, and the sweep's per-cell watchdog.

* checkpoint roundtrip, garbage collection and the async save; the leaf
  paths are `jax.tree_util.tree_flatten_with_path`'s;
* a Store and a dict saved by the JAX package restore into the port, and
  the port's restore into the JAX package, leaf for leaf (the packed
  planes are uint32 on disk either way);
* `StepTimer` flags the reference's steps on one sequence;
  `FaultTolerantRunner` restarts from the last checkpoint after an
  injected failure (tests/test_runtime.py's restart, without a
  trainer); `Heartbeat.stop` removes its file;
* `sweep.CellWatchdog` with a tiny `REPRO_WATCHDOG_S` interrupts a
  sleeping cell and records a straggler (in a child process: the
  interrupt goes to the main thread).
"""
import json
import os
import pathlib
import subprocess
import sys
import time
from typing import NamedTuple

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import protocol as JP  # noqa: E402
from repro.obs import trace as JT  # noqa: E402
from repro.runtime import checkpoint as JCK  # noqa: E402
from repro.runtime import fault as JF  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import ops as O  # noqa: E402
from repro_torch.core import protocol as P  # noqa: E402
from repro_torch.obs import trace as T  # noqa: E402
from repro_torch.runtime import checkpoint as CK  # noqa: E402
from repro_torch.runtime import fault as F  # noqa: E402

SRC = pathlib.Path(P.__file__).resolve().parents[2]


class Pair(NamedTuple):
    x: object
    y: object


def _tree(to):
    return {"b": Pair(to(np.arange(6, dtype=np.float32).reshape(2, 3)),
                      y=[to(np.ones(4, np.int32)), to(np.int32(3))]),
            "a": to(np.asarray([True, False])), "c": None,
            "d": (to(np.float32(1.5)), to(np.arange(3, dtype=np.uint8)))}


def _same(a, b):
    a = a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = b.cpu().numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


def test_leaf_paths_are_the_references():
    got = ["/".join(p) for p, _ in CK._flatten(_tree(torch.as_tensor))]
    want = [p for p, _ in JCK._flatten(_tree(jnp.asarray))[0]]
    assert got == want == ["a", "b/.x", "b/.y/0", "b/.y/1", "d/0", "d/1"]


def test_checkpoint_roundtrip(tmp_path):
    state = _tree(torch.as_tensor)
    CK.save_checkpoint(str(tmp_path), 7, state)
    path = CK.latest_checkpoint(str(tmp_path))
    assert path and path.endswith("step_00000007")
    step, back = CK.restore_checkpoint(path, state)
    assert step == 7 and back["c"] is None and isinstance(back["b"], Pair)
    assert list(back) == list(state)
    for (_, a), (_, b) in zip(CK._flatten(state), CK._flatten(back)):
        _same(a, b)


def test_checkpoint_gc_keeps_latest(tmp_path):
    for s in [1, 2, 3, 4, 5]:
        CK.save_checkpoint(str(tmp_path), s, {"x": torch.zeros(())}, keep=2)
    assert sorted(d for d in os.listdir(tmp_path) if d.startswith("step_")) \
        == ["step_00000004", "step_00000005"]
    assert CK.latest_checkpoint(str(tmp_path / "none")) is None


def test_async_checkpoint(tmp_path):
    state = {"x": torch.arange(10.0)}
    t = CK.save_checkpoint(str(tmp_path), 3, state, async_save=True)
    t.join()
    step, back = CK.restore_checkpoint(CK.latest_checkpoint(str(tmp_path)),
                                       state)
    assert step == 3 and torch.equal(back["x"], state["x"])


def test_restore_raises_on_a_missing_leaf_and_on_shardings(tmp_path):
    CK.save_checkpoint(str(tmp_path), 1, {"x": torch.zeros(2)})
    path = CK.latest_checkpoint(str(tmp_path))
    with pytest.raises(KeyError, match="'y'"):
        CK.restore_checkpoint(path, {"y": torch.zeros(2)})
    with pytest.raises(NotImplementedError, match="Queue A 15"):
        CK.restore_checkpoint(path, {"x": torch.zeros(2)}, shardings={})


def _stores(packed, monkeypatch):
    """A traced Store after a few ops, in both packages."""
    monkeypatch.setattr(P, "PACKED", packed)
    monkeypatch.setattr(JP, "PACKED", packed)
    cfg = JP.ProtoConfig(n_caches=4, n_words=256)
    js = JT.with_trace(JP.make_store(cfg), 16)
    from repro.core import ops as JO
    js, _ = JO.store(cfg, js, jnp.ones(4, bool),
                     jnp.asarray([0, 31, 64, 95], jnp.int32), 5)
    ps = convert.from_numpy(jax.tree.map(np.asarray, js), "cpu")
    ps2, _ = O.store(P.ProtoConfig(n_caches=4, n_words=256),
                     T.with_trace(P.make_store(
                         P.ProtoConfig(n_caches=4, n_words=256), "cpu"), 16),
                     torch.ones(4, dtype=torch.bool),
                     torch.tensor([0, 31, 64, 95], dtype=torch.int32), 5)
    for a, b in zip(convert.leaves(ps), convert.leaves(ps2)):
        assert torch.equal(a, b)
    return js, ps


def _same_store(port, ref):
    """Port tree against JAX tree, packed planes through uint32 views."""
    for a, b in zip(convert.leaves(convert.to_numpy(port)),
                    jax.tree.leaves(ref)):
        _same(a, np.asarray(b))


@pytest.mark.parametrize("packed", [True, False], ids=["packed", "bool"])
def test_jax_checkpoint_restores_in_the_port(tmp_path, monkeypatch, packed):
    js, ps = _stores(packed, monkeypatch)
    tree = {"store": js, "step": jnp.int32(4), "w": jnp.ones((2, 2))}
    JCK.save_checkpoint(str(tmp_path), 4, tree)
    like = {"store": P.make_store(P.ProtoConfig(n_caches=4, n_words=256),
                                  "cpu"),
            "step": torch.zeros((), dtype=torch.int32),
            "w": torch.zeros(2, 2)}
    like["store"] = T.with_trace(like["store"], 16)
    step, back = CK.restore_checkpoint(CK.latest_checkpoint(str(tmp_path)),
                                       like)
    assert step == 4
    _same_store(back["store"], js)
    for a, b in zip(convert.leaves(back["store"]), convert.leaves(ps)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    _same(back["step"], np.int32(4))
    _same(back["w"], np.ones((2, 2), np.float32))


@pytest.mark.parametrize("packed", [True, False], ids=["packed", "bool"])
def test_port_checkpoint_restores_in_jax(tmp_path, monkeypatch, packed):
    js, ps = _stores(packed, monkeypatch)
    CK.save_checkpoint(str(tmp_path), 9, {"store": ps,
                                          "lr": torch.tensor(0.5)})
    step, back = JCK.restore_checkpoint(CK.latest_checkpoint(str(tmp_path)),
                                        {"store": js, "lr": jnp.float32(0)})
    assert step == 9
    for a, b in zip(jax.tree.leaves(back["store"]), jax.tree.leaves(js)):
        _same(a, b)
    _same(back["lr"], np.float32(0.5))
    # the manifest the reference writes for the same tree
    JCK.save_checkpoint(str(tmp_path / "j"), 9, {"store": js,
                                                  "lr": jnp.float32(0.5)})
    mine = json.loads((pathlib.Path(CK.latest_checkpoint(str(tmp_path)))
                       / "manifest.json").read_text())
    ref = json.loads((pathlib.Path(JCK.latest_checkpoint(
        str(tmp_path / "j"))) / "manifest.json").read_text())
    assert [(r["path"], r["shape"], r["dtype"]) for r in mine["leaves"]] \
        == [(r["path"], r["shape"], r["dtype"]) for r in ref["leaves"]]


def _times(monkeypatch, timer, seq):
    flags = []
    for dt in seq:
        timer._t0 = 100.0
        monkeypatch.setattr(time, "perf_counter", lambda dt=dt: 100.0 + dt)
        flags.append(timer.stop()[1])
    monkeypatch.undo()
    return flags


def test_step_timer_flags_the_references_steps(monkeypatch):
    rng = np.random.default_rng(5)
    seq = (0.01 + 0.001 * rng.random(40)).tolist()
    for i in (5, 12, 33):       # 33 is past 12's stay in the window
        seq[i] = 0.05
    ref, got = JF.StepTimer(window=20), F.StepTimer(window=20)
    want = _times(monkeypatch, ref, seq)
    flags = _times(monkeypatch, got, seq)
    assert flags == want and got.stragglers == ref.stragglers
    # the window holds < 10 steps at step 5
    assert [i for i, f in enumerate(flags) if f] == [12, 33]


def test_fault_tolerant_runner_restarts_after_a_failure(tmp_path):
    """A failure at step 8 of 12, saving every 5: one restart from the
    step-5 checkpoint, and the run ends where a clean run does."""
    failed = []

    def step_fn(state, step):
        if step == 8 and not failed:
            failed.append(step)
            raise RuntimeError("injected failure")
        return {"w": state["w"] * 2 + step, "n": state["n"] + 1}

    init = {"w": torch.ones(3), "n": torch.zeros((), dtype=torch.int32)}
    seen = []
    r = F.FaultTolerantRunner(str(tmp_path), save_every=5)
    step, state = r.run(init, step_fn, 12,
                        on_step=lambda s, st, dt, strag: seen.append(s))
    assert r.restarts == 1 and step == 12 and failed == [8]
    assert seen == list(range(8)) + list(range(5, 12))
    clean = init
    for s in range(12):
        clean = step_fn(clean, s)
    assert torch.equal(state["w"], clean["w"]) and int(state["n"]) == 12
    assert CK.latest_checkpoint(str(tmp_path)).endswith("step_00000010")


def test_fault_tolerant_runner_gives_up(tmp_path):
    def step_fn(state, step):
        raise ValueError("always")

    r = F.FaultTolerantRunner(str(tmp_path), max_restarts=2)
    with pytest.raises(RuntimeError, match="max_restarts=2"):
        r.run({"x": torch.zeros(1)}, step_fn, 3)
    assert r.restarts == 3


def test_heartbeat_beats_and_stop_removes_its_file(tmp_path):
    path = tmp_path / "hb"
    hb = F.Heartbeat(str(path), interval=0.0)
    hb.beat(3)
    assert path.read_text().split()[0] == "3"
    hb.stop()
    assert not path.exists()
    hb.stop()                       # idempotent


_WATCHDOG = r"""
import json, os, sys, time
from repro_torch.workloads import sweep
path = sys.argv[1]
wd = sweep.CellWatchdog(path)
for i in range(12):                 # fill the straggler window
    wd.start(f"quick{i}")
    time.sleep(0.005)
    wd.stop()
wd.start("slow")
time.sleep(0.2)
wd.stop()
beat = os.path.exists(path)
interrupted = False
wd.start("hang")
try:
    for _ in range(2000):
        time.sleep(0.01)
except KeyboardInterrupt:
    interrupted = True
wd.close()
print(json.dumps({"interrupted": interrupted, "label": wd.label,
                  "stragglers": wd.stragglers, "beat": beat,
                  "left": os.path.exists(path), "enabled": wd.enabled,
                  "budget": sweep.WATCHDOG_S}))
"""


def test_cell_watchdog_interrupts_a_hung_cell(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(SRC), REPRO_WATCHDOG_S="0.5")
    env.pop("REPRO_NO_WATCHDOG", None)
    out = subprocess.run([sys.executable, "-c", _WATCHDOG,
                          str(tmp_path / "hb")], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["interrupted"] and res["label"] == "hang" and res["enabled"]
    assert res["budget"] == 0.5 and res["beat"] and not res["left"]
    assert [s["cell"] for s in res["stragglers"]] == ["slow"]
    assert "WATCHDOG: cell hang exceeded" in out.stderr


def test_cell_watchdog_off(monkeypatch, tmp_path):
    from repro_torch.workloads import sweep
    monkeypatch.setenv("REPRO_NO_WATCHDOG", "1")
    wd = sweep.CellWatchdog(str(tmp_path / "hb"))
    wd.start("c")
    wd.stop()
    wd.close()
    assert not wd.enabled and wd.cells == 1 and wd._t is None
    assert not (tmp_path / "hb").exists()
    default = sweep.CellWatchdog()
    assert default.hb.path.endswith(f"sweep_heartbeat.{os.getpid()}")
