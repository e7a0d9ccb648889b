"""Golden serving run of qwen2.5-32b for the PyTorch port.

`src/repro_torch/golden/qwen2_5_serve.json` holds the JAX package's
serving run of qwen2.5-32b at full width (d_model 5120, 40/8 heads of
128, QKV bias, vocab 152064), depth cut 64 -> 2, float32, weights from
`repro_torch.convert.numpy_lm_params(seed=0)` with nonzero QKV biases:
granite's golden prompts (lengths and seed, over qwen's vocab) through
`repro.serve.engine.Engine` with 3 slots, 8 new tokens each, and per
step the top-5 logits of the teacher-forced path
(`repro_torch.serve.golden`).  `chip_smoke.py` phase 10 holds the
card's run to the same file.  Here, on the CPU, tier-1 checks the file's
config, cuts and prompts; the full-width comparison (~10 GB of weights
in each package) is marked slow:

* the port's teacher-forced logits match the golden top-5 within 1e-3
  and its greedy tokens match wherever the margin exceeds 2e-3;
* the port's `Engine` gives the golden's tokens.

Regenerate the file from the JAX package (~13 GB of RAM, a few minutes)
with

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_dense_golden.py --write
"""
import dataclasses
import json
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import convert  # noqa: E402
from repro_torch.configs import qwen2_5_32b  # noqa: E402
from repro_torch.models.registry import build  # noqa: E402
from repro_torch.serve import golden as G  # noqa: E402
from repro_torch.serve.engine import Engine, Request  # noqa: E402

from test_torch_serve_golden import TOL, _provenance, golden_from_jax  # noqa: E402,E501

BASE = qwen2_5_32b.CONFIG


def qwen_golden_from_jax() -> dict:
    from repro.configs.qwen2_5_32b import CONFIG
    return golden_from_jax(CONFIG, BASE)


@pytest.fixture(scope="module")
def golden():
    return G.load(G.QWEN_PATH)


def test_golden_file_describes_the_cut_config(golden):
    cfg = G.config(BASE)
    assert golden["config"] == json.loads(json.dumps(dataclasses.asdict(cfg)))
    assert (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
            cfg.qkv_bias, cfg.vocab) == (5120, 40, 8, 128, True, 152064)
    assert golden["reduced"] == G.reduced(BASE) == [
        "n_layers 64 -> 2", "dtype bfloat16 -> float32"]
    assert golden["engine"] == {"max_len": G.MAX_LEN, "slots": G.SLOTS,
                                "new_tokens": G.NEW_TOKENS}
    assert [len(r["prompt"]) for r in golden["requests"]] \
        == list(G.PROMPT_LENS)
    assert [r["prompt"] for r in golden["requests"]] == \
        [p.tolist() for p in G.prompts(cfg.vocab)]
    for r in golden["requests"]:
        assert len(r["tokens"]) == G.NEW_TOKENS
        assert [i[0] for i in r["top5_indices"]] == r["tokens"]


@pytest.fixture(scope="module")
def port():
    torch.use_deterministic_algorithms(True)
    cfg = G.config(BASE)
    params = convert.lm_params_to_torch(convert.numpy_lm_params(cfg, G.SEED),
                                        "cpu", torch.float32)
    return build(cfg), params


@pytest.mark.slow
def test_port_matches_golden_at_full_width(golden, port):
    model, params = port
    logits = [G.teacher_forced(model, params, r["prompt"], r["tokens"])
              for r in golden["requests"]]
    res = G.compare(golden, logits, TOL)
    assert res["steps"] == len(G.PROMPT_LENS) * G.NEW_TOKENS
    assert res["max_abs_err"] <= TOL, res
    assert not res["mismatches"], res
    reqs = Engine(model, params, max_len=G.MAX_LEN, slots=G.SLOTS).generate(
        [Request(prompt=np.asarray(r["prompt"], np.int32),
                 max_new_tokens=G.NEW_TOKENS) for r in golden["requests"]])
    for r, g in zip(reqs, golden["requests"]):
        assert r.out.tolist() == g["tokens"]


if __name__ == "__main__":
    if "--write" not in sys.argv[1:]:
        sys.exit("usage: python tests/test_torch_dense_golden.py --write")
    data = qwen_golden_from_jax()
    data["provenance"] = _provenance() | {
        "generator": "tests/test_torch_dense_golden.py --write"}
    G.QWEN_PATH.write_text(json.dumps(data, indent=1) + "\n")
    print(f"wrote {G.QWEN_PATH} ({len(data['requests'])} requests)")
