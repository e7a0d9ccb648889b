"""Golden serving run of granite-moe-1b-a400m for the PyTorch port.

`src/repro_torch/golden/granite_moe_serve.json` holds the JAX package's
serving run at full width, depth cut to 2 layers, float32, weights from
`repro_torch.convert.numpy_lm_params(seed=0)`: 5 ragged prompts through
`repro.serve.engine.Engine` with 3 slots, 8 new tokens each, and per step
the top-5 logits of the teacher-forced path (`repro_torch.serve.golden`).
`chip_smoke.py` holds the card's run to the same file.  Here, on the CPU:

* the file's config is the port's granite config with the listed cuts;
* the port's teacher-forced logits match the golden top-5 within 1e-3
  and its greedy tokens match wherever the margin exceeds 2e-3;
* the port's `Engine` gives the golden's tokens.

Regenerate the file from the JAX package with

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_serve_golden.py --write
"""
import dataclasses
import json
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import convert  # noqa: E402
from repro_torch.models.registry import build  # noqa: E402
from repro_torch.serve import golden as G  # noqa: E402
from repro_torch.serve.engine import Engine, Request  # noqa: E402

# float32 on two CPUs' orders of summation: ~1e-6 apart on logits of size
# ~1; 1e-3 is the bound the card's run is held to as well
TOL = 1e-3


def _to_jax(tree: dict) -> dict:
    """numpy leaves -> jax arrays, each numpy leaf dropped once converted,
    so a full-width tree is held about once, not twice."""
    import jax.numpy as jnp
    out = {}
    for k in list(tree):
        v = tree.pop(k)
        out[k] = _to_jax(v) if isinstance(v, dict) else jnp.asarray(v)
        del v
    return out


def golden_from_jax(base=None, port_base=None) -> dict:
    """Run the golden requests through the JAX package, for the JAX
    package's CONFIG `base` (granite-moe-1b-a400m's unless named) and
    the port's same config `port_base`."""
    import jax
    import jax.numpy as jnp

    from repro.configs.granite_moe_1b import CONFIG
    from repro.models.registry import build as jbuild
    from repro.serve.engine import Engine as JEngine
    from repro.serve.engine import Request as JRequest

    cfg = dataclasses.replace(base or CONFIG, n_layers=G.N_LAYERS,
                              dtype="float32")
    model = jbuild(cfg)
    params = _to_jax(convert.numpy_lm_params(G.config(port_base), G.SEED))
    prompts = G.prompts(cfg.vocab)
    reqs = JEngine(model, params, max_len=G.MAX_LEN, slots=G.SLOTS).generate(
        [JRequest(prompt=p, max_new_tokens=G.NEW_TOKENS) for p in prompts])
    decode = jax.jit(model.decode_step)
    out = []
    for p, r in zip(prompts, reqs):
        logits, cache = model.prefill(params, {"tokens": jnp.asarray(p[None])})
        cache = model.grow_cache(cache, G.MAX_LEN)
        steps = [np.asarray(logits[0], np.float32)]
        for j, tok in enumerate(r.out[:-1]):
            logits, cache = decode(params, cache,
                                   jnp.asarray([[tok]], jnp.int32),
                                   jnp.asarray([len(p) + j], jnp.int32))
            steps.append(np.asarray(logits[0], np.float32))
        tops = [G.top(s) for s in steps]
        greedy = [int(i[0]) for _, i in tops]
        assert greedy == [int(t) for t in r.out], \
            "the JAX engine and its teacher-forced path disagree"
        out.append({"prompt": p.tolist(), "tokens": greedy,
                    "top5_values": [v.tolist() for v, _ in tops],
                    "top5_indices": [i.tolist() for _, i in tops],
                    "margins": [float(v[0] - v[1]) for v, _ in tops]})
    return {"config": dataclasses.asdict(G.config(port_base)),
            "reduced": G.reduced(port_base),
            "weights": f"repro_torch.convert.numpy_lm_params(cfg, "
                       f"seed={G.SEED})",
            "engine": {"max_len": G.MAX_LEN, "slots": G.SLOTS,
                       "new_tokens": G.NEW_TOKENS},
            "requests": out}


def _provenance() -> dict:
    try:
        commit = subprocess.run(["git", "rev-parse", "HEAD"],
                                cwd=G.PATH.parents[3], capture_output=True,
                                text=True, check=True).stdout.strip()
    except (OSError, subprocess.CalledProcessError):
        commit = None
    import jax
    return {"generator": "tests/test_torch_serve_golden.py --write",
            "jax": jax.__version__, "backend": jax.default_backend(),
            "parent_commit": commit}


@pytest.fixture(scope="module")
def golden():
    return G.load()


@pytest.fixture(scope="module")
def port(golden):
    torch.use_deterministic_algorithms(True)
    cfg = G.config()
    model = build(cfg)
    params = convert.lm_params_to_torch(
        convert.numpy_lm_params(cfg, G.SEED), "cpu", torch.float32)
    return model, params


def test_golden_file_describes_the_cut_config(golden):
    assert golden["config"] == json.loads(json.dumps(
        dataclasses.asdict(G.config())))
    assert golden["reduced"] == G.REDUCED
    lens = [len(r["prompt"]) for r in golden["requests"]]
    assert lens == list(G.PROMPT_LENS) and max(lens) >= 17
    for r in golden["requests"]:
        assert len(r["tokens"]) == G.NEW_TOKENS
        assert [i[0] for i in r["top5_indices"]] == r["tokens"]
    assert [r["prompt"] for r in golden["requests"]] == \
        [p.tolist() for p in G.prompts(G.config().vocab)]


def test_port_teacher_forced_logits_match_golden(golden, port):
    model, params = port
    logits = [G.teacher_forced(model, params, r["prompt"], r["tokens"])
              for r in golden["requests"]]
    res = G.compare(golden, logits, TOL)
    assert res["steps"] == len(G.PROMPT_LENS) * G.NEW_TOKENS
    assert res["max_abs_err"] <= TOL, res
    assert not res["mismatches"], res


def test_port_engine_reproduces_golden_tokens(golden, port):
    model, params = port
    reqs = Engine(model, params, max_len=G.MAX_LEN, slots=G.SLOTS).generate(
        [Request(prompt=np.asarray(r["prompt"], np.int32),
                 max_new_tokens=G.NEW_TOKENS) for r in golden["requests"]])
    for r, g in zip(reqs, golden["requests"]):
        assert r.out.tolist() == g["tokens"]


@pytest.mark.slow
def test_golden_regenerates_from_jax(golden):
    fresh = golden_from_jax()
    for a, b in zip(fresh["requests"], golden["requests"]):
        assert a["tokens"] == b["tokens"]
        np.testing.assert_allclose(a["top5_values"], b["top5_values"],
                                   rtol=0, atol=1e-5)


if __name__ == "__main__":
    if "--write" not in sys.argv[1:]:
        sys.exit("usage: python tests/test_torch_serve_golden.py --write")
    data = golden_from_jax()
    data["provenance"] = _provenance()
    G.PATH.write_text(json.dumps(data, indent=1) + "\n")
    print(f"wrote {G.PATH} ({len(data['requests'])} requests)")
