"""The port's serving engine against the JAX package's, at granite SMOKE.

The 5-request ragged set of tests/test_serve_engine.py (more requests
than slots, one that finishes at prefill) goes through the port's
`Engine`, the JAX `Engine` and a serial one-request-at-a-time loop of the
port's own prefill and decode step, with the same numpy-drawn weights.
Greedy tokens are compared exactly (float32 on the CPU; no top-1/top-2
margin of this set is within 1e-3, so a summation-order difference
cannot flip one).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models.registry import build as jbuild  # noqa: E402
from repro.models.registry import get_config as jget  # noqa: E402
from repro.serve.engine import Engine as JEngine  # noqa: E402
from repro.serve.engine import Request as JRequest  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.models.registry import build, get_config  # noqa: E402
from repro_torch.serve.engine import (Engine, Request,  # noqa: E402
                                      throughput_bench)

torch.use_deterministic_algorithms(True)
ARCH = "granite-moe-1b-a400m"
MAX_LEN = 48
LENS, BUDGETS = (5, 3, 7, 5, 3), (4, 6, 1, 5, 3)


@pytest.fixture(scope="module")
def setup():
    cfg = get_config(ARCH, smoke=True)
    tree = convert.numpy_lm_params(cfg, seed=0)
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, cfg.vocab, (n,)).astype(np.int32)
               for n in LENS]
    return (cfg, build(cfg), convert.lm_params_to_torch(tree, "cpu"),
            jax.tree.map(jnp.asarray, tree), prompts)


def _serial(model, params, prompt, budget):
    """One request alone: B=1 prefill, then B=1 decode steps."""
    logits, cache = model.prefill(
        params, {"tokens": torch.from_numpy(prompt[None])})
    cache = model.grow_cache(cache, MAX_LEN)
    toks = [int(logits[0].argmax())]
    kv = len(prompt)
    for _ in range(budget - 1):
        logits, cache = model.decode_step(
            params, cache, torch.tensor([[toks[-1]]]),
            torch.tensor([kv], dtype=torch.int32))
        kv += 1
        toks.append(int(logits[0].argmax()))
    return toks


@pytest.fixture(scope="module")
def jax_tokens(setup):
    _, _, _, jp, prompts = setup
    jm = jbuild(jget(ARCH, smoke=True))
    out = JEngine(jm, jp, max_len=MAX_LEN, slots=2).generate(
        [JRequest(prompt=p, max_new_tokens=m)
         for p, m in zip(prompts, BUDGETS)])
    jax.clear_caches()
    return [r.out.tolist() for r in out]


@pytest.mark.parametrize("slots", [2, 5])
def test_engine_matches_jax_engine_and_serial(setup, jax_tokens, slots):
    _, model, tp, _, prompts = setup
    out = Engine(model, tp, max_len=MAX_LEN, slots=slots).generate(
        [Request(prompt=p, max_new_tokens=m)
         for p, m in zip(prompts, BUDGETS)])
    for i, (r, want) in enumerate(zip(out, jax_tokens)):
        assert len(r.out) == BUDGETS[i]
        assert r.out.dtype == np.int32
        assert r.out.tolist() == want, f"request {i}"
        assert r.out.tolist() == _serial(model, tp, prompts[i],
                                         BUDGETS[i]), f"request {i}"


def test_engine_stops_at_eos_and_max_len(setup):
    _, model, tp, _, prompts = setup
    first = Engine(model, tp, max_len=MAX_LEN, slots=2).generate(
        [Request(prompt=prompts[1], max_new_tokens=6)])[0].out
    eos = int(first[2])
    stop = Engine(model, tp, max_len=MAX_LEN, slots=2, eos=eos).generate(
        [Request(prompt=prompts[1], max_new_tokens=6)])[0].out
    assert stop.tolist() == first[: first.tolist().index(eos) + 1].tolist()
    short = Engine(model, tp, max_len=len(prompts[0]) + 2, slots=1).generate(
        [Request(prompt=prompts[0], max_new_tokens=10)])[0].out
    # the prefill token, then decode until kv_len reaches max_len
    assert short.tolist() == _serial(model, tp, prompts[0], 3)


def test_throughput_bench_runs_on_the_cpu(setup):
    _, model, tp, _, _ = setup
    res = throughput_bench(model, tp, batch=2, seq=6, new_tokens=3)
    assert res["device"] == "cpu" and res["decode_tok_s"] > 0
