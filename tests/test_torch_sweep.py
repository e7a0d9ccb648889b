"""The sweep's document (`repro.workloads.sweep.main`) in the port
(`repro_torch.workloads.sweep.run_sweep`), held to the reference's.

`src/repro_torch/golden/sweep.json` is the reference's document at
GOLDEN_ARGV (the six workloads, four scenarios, sizes 4 and 8, two
replicas, one timed call, fused srsp rows, both churned cells, the
remote-batch, fused-engine and packed-metadata A/Bs at their smallest,
the serving comparison at n=4 and 8 requests an agent under both skews,
no scale cell), run on the CPU under REPRO_TRACE=1, its wall times
nulled; `golden/sweep_traces.npz` the request traces its kv_serving
lanes drew, which the port replays (`sweep.reference_traces`): its
float samplers agree with XLA's to a few ulps, not bit for bit.

Checks, on the CPU:

* every row and section of the port's document has the reference's
  keys (this file);
* the port's document at GOLDEN_ARGV, traced, run in parts (`PARTS`,
  one a test file, each with the warm-up calls skipped), equals the
  golden in every modeled column (`sweep_doc.modeled`): counters, makespan,
  events, check verdicts, the latency, trace, traffic and churn columns,
  the table geometry, api, remote_batch, n_replicas, iters_timed, every
  comparison and the A/B makespans.  The parts together cover every row
  and comparison of the golden;
* `check_doc` passes the golden and fails a fused/batched makespan
  mismatch, a missing latency column and a failed churned row;
* the packed-metadata child process runs both arms on the CPU;
* `diff_modeled(columns=)` holds a document of part of a grid row by
  row against the reference's rows of the same labels;
* `--serving-scale R` runs the document's scale cell (cut to n=4);
* slow: the reference's document regenerates to the golden.

Regenerate the golden files with

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_sweep.py --write

(~15 min: the reference compiles every cell).
"""
import copy
import dataclasses
import json
import os
import pathlib
import subprocess
import sys
import tempfile

import pytest

torch = pytest.importorskip("torch")

from repro_torch.obs import trace as T  # noqa: E402
from repro_torch.workloads import sweep, sweep_doc  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
GOLDEN_DIR = ROOT / "src" / "repro_torch" / "golden"
GOLDEN = GOLDEN_DIR / "sweep.json"
GOLDEN_TRACES = GOLDEN_DIR / "sweep_traces.npz"
TRACE_CAP = 4096
GOLDEN_ARGV = ["--sizes", "4", "8", "--seeds", "2", "--iters", "1",
               "--remote-batch-sizes", "4", "--fuse-sizes", "4",
               "--pack-sizes", "4", "--pack-iters", "1",
               "--serving-sizes", "4", "--serving-requests", "8",
               "--serving-scale-replicas", "0", "--no-donation"]
# the parts the tier-1 tests run the golden's document in, as extra
# arguments; each is a test file of its own
PARTS = {
    "kv_directory": ["--workloads", "kv_directory", "worksteal",
                     "--no-serving", "--no-remote-batch-ab"],
    "kv_serving": ["--workloads", "kv_serving", "--no-pack-ab",
                   "--no-remote-batch-ab", "--no-fuse-ab"],
    "producer_consumer": ["--workloads", "producer_consumer",
                          "producer_consumer_mc", "--no-serving",
                          "--no-churn", "--no-pack-ab", "--no-fuse-ab"],
    "reader_lock": ["--workloads", "reader_lock", "--no-serving",
                    "--no-churn", "--no-pack-ab", "--no-remote-batch-ab",
                    "--no-fuse-ab"],
}


def golden() -> dict:
    """The golden document, without its provenance."""
    doc = json.loads(GOLDEN.read_text())
    doc.pop("provenance")
    return doc


def part_args(part: str):
    return sweep.parser().parse_args(GOLDEN_ARGV + PARTS[part]
                                     + ["--device", "cpu"])


def select(doc: dict, args) -> dict:
    """The rows and comparisons of `doc` (a GOLDEN_ARGV document) that a
    run with `args` makes: the same grid and sections, restricted."""
    names = args.workloads
    out = dict(doc)
    out["runs"] = [
        r for r in doc["runs"]
        if (not r["churn_events"] and r["workload"] in names)
        or (r["churn_events"] and not args.no_churn
            and (r["workload"] == "worksteal" or "kv_serving" in names))]
    for sec, off in (("serving", args.no_serving),
                     ("pack_ab", args.no_pack_ab),
                     ("remote_batch_ab", args.no_remote_batch_ab),
                     ("fuse_ab", args.no_fuse_ab)):
        out[sec] = [] if off else doc[sec]
    churned = {f"churn/{r['workload']}/n={r['n_agents']}"
               for r in out["runs"] if r["churn_events"]}

    def kept(key):
        head, rest = key.split("/", 1)
        if head in ("serving", "serving_scale"):
            return not args.no_serving
        if head == "churn":
            return key in churned
        if head == "fused":
            return rest.split("/")[0] in names
        if head in ("packed", "remote_batch", "fuse"):
            return not {"packed": args.no_pack_ab,
                        "remote_batch": args.no_remote_batch_ab,
                        "fuse": args.no_fuse_ab}[head]
        return head in names

    out["comparisons"] = {k: v for k, v in doc["comparisons"].items()
                          if kept(k)}
    out["config"] = dict(doc["config"], workloads=names,
                         serving=None if args.no_serving
                         else doc["config"]["serving"])
    first = next((r for r in out["runs"] if r["scenario"] == "srsp"
                  and r["trace_events"]), None)
    out["trace"] = dict(doc["trace"], cell=first and (
        f"{first['workload']}/srsp+crash/churned" if first["churn_events"]
        else f"{first['workload']}/srsp/n={first['n_agents']}/"
             f"{first['engine']}"))
    return out


def run_part(part: str, monkeypatch, tmp_path) -> dict:
    """The port's document of one part on the golden traces, traced at
    the golden's ring capacity, no warm-up, on one CPU thread (these
    tensors are tiny; more threads only add overhead)."""
    monkeypatch.setattr(T, "TRACE", True)
    monkeypatch.setattr(T, "DEFAULT_CAP", TRACE_CAP)
    args = part_args(part)
    args.trace_out = str(tmp_path / "trace.json")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return sweep.run_sweep(args, sweep.reference_traces(
            str(GOLDEN_TRACES), "cpu"), warmup=False)
    finally:
        torch.set_num_threads(threads)


def assert_part(part: str, monkeypatch, tmp_path) -> dict:
    """The part's document == the golden's rows and comparisons of that
    part, in every modeled column; returns the document."""
    doc = run_part(part, monkeypatch, tmp_path)
    assert sweep_doc.diff_modeled(doc, select(golden(), part_args(part))) == []
    return doc


def keysets(doc: dict) -> dict:
    """Every row's and section's key set, in document order."""
    return {"top": sorted(doc),
            **{sec: [sorted(r) for r in doc[sec]] for sec in sweep_doc.SECTIONS},
            "comparisons": {k: sorted(v)
                            for k, v in doc["comparisons"].items()},
            "trace": sorted(doc["trace"]), "config": sorted(doc["config"])}


# ---------------------------------------------------------------------------
# the golden files, from the reference
# ---------------------------------------------------------------------------

def _timed_seeds(replicas: int, iters: int) -> list:
    return [s for it in range(max(1, iters))
            for s in range((it + 1) * replicas, (it + 2) * replicas)]


def jax_traces(argv=GOLDEN_ARGV) -> dict:
    """The reference's request trace of every kv_serving lane of a timed
    call the sweep makes at `argv`, as `traffic.trace.save_set` takes
    them (the installed JAX's PRNG layout)."""
    from repro.traffic import trace as JT
    from repro.traffic.samplers import TrafficConfig
    from repro.workloads import kv_serving

    args = sweep.parser().parse_args(argv)
    specs = []
    if args.workloads == ["all"] or "kv_serving" in args.workloads:
        specs += [(n, {}, s) for n in args.sizes
                  for s in _timed_seeds(args.seeds, args.iters)]
        if not args.no_churn:
            c = sweep.CHURNED["kv_serving"]
            specs.append((c["n_agents"], c["build_kw"], c["seed"]))
    if not args.no_serving:
        for n in args.serving_sizes:
            for z in args.serving_zipf:
                tc = TrafficConfig(requests_per_agent=args.serving_requests,
                                   zipf_s=z, gap_mean=8.0, burstiness=4.0,
                                   remote_frac=0.03)
                specs += [(n, {"traffic": tc}, s) for s in _timed_seeds(
                    args.serving_seeds, args.iters)]
    out = {}
    for n, kw, seed in specs:
        cfg = kv_serving.Config(n_agents=n, **kw)
        tc = cfg.traffic
        name = (f"n{n}_keys{cfg.n_pages}_r{tc.requests_per_agent}"
                f"_z{tc.zipf_s}_seed{seed}")
        out[name] = {"tr": JT.generate(tc, n, cfg.n_pages, seed),
                     "cfg": tc, "n_agents": n, "n_keys": cfg.n_pages,
                     "seed": seed}
    return out


def strip_walls(doc: dict) -> dict:
    """`doc` with every wall time nulled (the stragglers emptied, the
    trace file's path dropped): what a rerun reproduces."""
    doc = copy.deepcopy(doc)
    for sec in sweep_doc.SECTIONS:
        for r in doc[sec]:
            for k in sweep_doc.WALL_KEYS:
                if k in r:
                    r[k] = None
    for c in doc["comparisons"].values():
        for k in c:
            if k.startswith("steady_speedup"):
                c[k] = None
    doc["stragglers"] = []
    doc["trace"]["file"] = None
    return doc


def jax_golden() -> dict:
    """The reference's document at GOLDEN_ARGV, traced, on the CPU, in a
    child process (REPRO_TRACE is read at import), wall times nulled."""
    with tempfile.TemporaryDirectory() as tmp:
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                   JAX_PLATFORMS="cpu", REPRO_TRACE="1",
                   REPRO_TRACE_CAP=str(TRACE_CAP))
        out = os.path.join(tmp, "sweep.json")
        subprocess.run([sys.executable, "-m", "repro.workloads.sweep",
                        *GOLDEN_ARGV, "--out", out, "--trace-out",
                        os.path.join(tmp, "trace.json")],
                       env=env, cwd=tmp, check=True, capture_output=True)
        with open(out) as f:
            return strip_walls(json.load(f))


def _provenance() -> dict:
    import jax
    try:
        commit = subprocess.run(["git", "rev-parse", "HEAD"], cwd=ROOT,
                                capture_output=True, text=True,
                                check=True).stdout.strip()
    except (OSError, subprocess.CalledProcessError):
        commit = None
    return {"reference": "python -m repro.workloads.sweep <argv> under "
                         "REPRO_TRACE=1, JAX_PLATFORMS=cpu, kernel_mode ref;"
                         " wall times nulled",
            "argv": GOLDEN_ARGV, "jax_commit": commit,
            "prng_layout": "kv_serving traces: jax_threefry_partitionable"
                           f"=True (the installed JAX {jax.__version__}'s "
                           "default), in sweep_traces.npz",
            "generator": "tests/test_torch_sweep.py --write"}


def write() -> None:
    from repro_torch.traffic import trace as TT
    doc = jax_golden()
    TT.save_set(str(GOLDEN_TRACES), jax_traces())
    GOLDEN.write_text(json.dumps({"provenance": _provenance(), **doc},
                                 indent=1) + "\n")
    print(f"wrote {GOLDEN}, {GOLDEN_TRACES}")


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------

def test_golden_is_the_argv_and_covered_by_the_parts():
    assert json.loads(GOLDEN.read_text())["provenance"]["argv"] \
        == GOLDEN_ARGV
    doc = golden()
    assert doc["schema_version"] == sweep_doc.SCHEMA_VERSION
    covered = {"runs": set(), "serving": set(), "comparisons": set()}
    for part in PARTS:
        sel = select(doc, part_args(part))
        for sec in ("runs", "serving"):
            covered[sec] |= {json.dumps(r, sort_keys=True)
                             for r in sel[sec]}
        covered["comparisons"] |= set(sel["comparisons"])
    for sec in ("runs", "serving"):
        assert covered[sec] == {json.dumps(r, sort_keys=True)
                                for r in doc[sec]}, sec
    assert covered["comparisons"] == set(doc["comparisons"])
    for sec in ("pack_ab", "remote_batch_ab", "fuse_ab"):
        assert doc[sec] and any(
            select(doc, part_args(p))[sec] == doc[sec] for p in PARTS), sec


def test_part_kv_directory(monkeypatch, tmp_path):
    """kv_directory and worksteal, both churned rows, the fused-engine and
    packed-metadata A/Bs; the Perfetto export of the first traced srsp
    row."""
    doc = assert_part("kv_directory", monkeypatch, tmp_path)
    assert doc["trace"]["cell"] == "kv_directory/srsp/n=4/batched"
    trace = json.loads((tmp_path / "trace.json").read_text())
    assert trace["srsp"]["label"] == doc["trace"]["cell"]
    assert all(r["compile_s"] is None for r in doc["runs"])


def test_keys_are_the_references(monkeypatch, tmp_path):
    """Every row, section and comparison of a small port document
    (kv_serving at n=4, untraced, on the port's own draws) has the
    golden's keys, and the golden's top level, trace and config keys."""
    monkeypatch.setattr(T, "TRACE", False)
    args = sweep.parser().parse_args(
        GOLDEN_ARGV + ["--sizes", "4", "--workloads", "kv_serving",
                       "--scenarios", "baseline", "rsp", "srsp",
                       "--serving-zipf", "1.2", "--no-pack-ab",
                       "--device", "cpu"])
    doc = sweep.run_sweep(args, warmup=False)
    want = keysets(golden())
    want_top = want.pop("top")
    got = keysets(doc)
    assert sorted(doc) == want_top
    for sec in sweep_doc.SECTIONS:
        assert all(k in want[sec] for k in got[sec]), sec
    assert got["trace"] == want["trace"] and got["config"] == want["config"]
    for k, v in got["comparisons"].items():
        assert v == want["comparisons"][k], k
    assert doc["donation_ab"] == [] and doc["donate_buffers"] is None
    assert (doc["backend"], doc["kernel_mode"], doc["fuse_enabled"]) == (
        "cpu", "plain", True)
    assert {r["kernel_mode"] for r in doc["runs"] + doc["serving"]} \
        == {"plain"}
    assert all(r["compile_s"] is None for r in doc["runs"])


def test_pack_child_runs_both_arms():
    """The packed-metadata A/B's child process on the CPU at n_wgs=4:
    both layouts process every node (and launch no kernel on the CPU)."""
    for packed in (True, False):
        rec = sweep.measure_pack(4, 1, packed, "cpu")
        assert rec["proc_errors"] == 0 and rec["packed"] is packed
        assert rec.pop("_launches") == {"drain_writeback": 0,
                                         "drain_writeback_bool": 0}
        assert sorted(rec) == sorted(golden()["pack_ab"][0])


def test_check_doc_cases():
    """The golden passes `check_doc` (under the port's kernel modes) and
    fails a fused/batched makespan mismatch, a missing latency column
    and a failed churned row."""
    doc = golden()
    doc["kernel_mode"] = "plain"
    for r in doc["runs"]:
        r["kernel_mode"] = "plain"
    assert sweep_doc.check_doc(doc, expect_trace=False) == []
    assert sweep_doc.check_doc(dict(doc, kernel_mode="ref"),
                           expect_trace=False) != []

    bad = copy.deepcopy(doc)
    fused = next(r for r in bad["runs"] if r["engine"] == "fused")
    fused["makespan"] += 1.0
    assert any("fused/batched makespan diverges" in f
               for f in sweep_doc.check_doc(bad, expect_trace=False))

    bad = copy.deepcopy(doc)
    del bad["runs"][3]["latency_p99"]
    assert any("missing v6 latency columns" in f
               for f in sweep_doc.check_doc(bad, expect_trace=False))

    bad = copy.deepcopy(doc)
    churned = next(r for r in bad["runs"] if r["churn_events"])
    churned["lost_updates"] = 2
    assert any("churned cell failed" in f
               for f in sweep_doc.check_doc(bad, expect_trace=False))

    # traced: the golden names no trace file (its path was dropped)
    assert any("names no trace file" in f
               for f in sweep_doc.check_doc(doc, expect_trace=True))


@pytest.mark.parametrize("case", ["subset", "makespan", "events",
                                  "unmatched", "remote_arm"])
def test_diff_modeled_rows_by_label(case):
    """`diff_modeled(columns=ROW_COLUMNS)` holds each row of a document
    that holds part of a grid against the reference's row of the same
    label: a subset is equal; a changed makespan or event count, a row
    the reference lacks and a changed serialized remote-batch arm each
    give one line naming the row."""
    ref = golden()
    doc = copy.deepcopy(ref)
    doc["runs"] = [r for r in doc["runs"]
                   if r["workload"] == "producer_consumer_mc"
                   or r["churn_events"]]
    doc["serving"] = doc["serving"][:2]
    want = []
    row = doc["runs"][0]
    label = (f"runs/producer_consumer_mc/{row['scenario']}"
             f"/n={row['n_agents']}/R=2/{row['engine']}")
    if case == "makespan":
        row["makespan"] += 1.0
        want = [f"{label}.makespan"]
    elif case == "events":
        row["events"] += 1
        want = [f"{label}.events"]
    elif case == "unmatched":
        row["n_agents"] = 5
        want = [label.replace("n=4", "n=5").replace("n=8", "n=5")]
    elif case == "remote_arm":
        arm = next(r for r in doc["remote_batch_ab"]
                   if not r["remote_batch"])
        arm["makespan"] += 1.0
        want = ["remote_batch_ab/producer_consumer_mc/srsp/n=4/R=2/batched"
                "/serialized.makespan"]
    got = sweep_doc.diff_modeled(doc, ref, columns=sweep_doc.ROW_COLUMNS)
    assert [line.split(":")[0] for line in got] == want
    assert sweep_doc.diff_modeled(ref, ref, columns=sweep_doc.ROW_COLUMNS) \
        == []


def test_serving_scale_mode_is_the_documents_cell(monkeypatch, tmp_path):
    """`--serving-scale R` runs the document's scale cell
    (`sweep.serving_scale`, cut here to n=4 and 8 requests an agent):
    srsp, rsp and baseline, each row equal in every modeled column to
    the scale row of a document run with `--serving-scale-replicas R`."""
    monkeypatch.setattr(sweep, "SERVING_SCALE_N", 4)
    monkeypatch.setattr(sweep, "SERVING_SCALE_TRAFFIC", dataclasses.replace(
        sweep.SERVING_SCALE_TRAFFIC, requests_per_agent=8))
    out = tmp_path / "scale.json"
    assert sweep.main(["--serving-scale", "2", "--device", "cpu",
                       "--out", str(out)]) == 0
    rows = json.loads(out.read_text())["rows"]
    args = sweep.parser().parse_args(
        ["--workloads", "kv_serving", "--scenarios", "srsp", "--sizes", "4",
         "--fused-scenarios", "none", "--no-churn", "--no-pack-ab",
         "--no-remote-batch-ab", "--no-fuse-ab", "--serving-sizes", "4",
         "--serving-requests", "8", "--serving-zipf", "1.2",
         "--serving-scale-replicas", "2", "--device", "cpu"])
    doc = json.loads(json.dumps(sweep.run_sweep(args, warmup=False)))

    def modeled(r):
        return {k: v for k, v in r.items()
                if k not in sweep_doc.WALL_KEYS + ("wall_s",)}

    assert [r["scenario"] for r in rows] == list(sweep.SCALE_SCENARIOS)
    assert all(r["check_ok"] and r["n_replicas"] == 2 for r in rows)
    assert [modeled(r) for r in rows] \
        == [modeled(r) for r in doc["serving"][-3:]]


@pytest.mark.slow
def test_golden_regenerates_from_jax():
    assert jax_golden() == golden()
    from repro_torch.traffic import trace as TT
    stored = TT.load_set(str(GOLDEN_TRACES), "cpu")
    fresh = jax_traces()
    assert sorted(stored) == sorted(fresh)
    for name, t in fresh.items():
        for f in ("arrival", "key", "kind", "agent"):
            assert stored[name][0]._asdict()[f].numpy().tolist() \
                == getattr(t["tr"], f).tolist(), (name, f)
        assert dataclasses.asdict(stored[name][1]["config"]) \
            == dataclasses.asdict(t["cfg"])


if __name__ == "__main__":
    if "--write" not in sys.argv:
        sys.exit("usage: python tests/test_torch_sweep.py --write")
    write()
