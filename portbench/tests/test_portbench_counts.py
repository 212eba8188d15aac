"""The yardstick's counts, every loop's result line at a tiny size on the
CPU, run.py's refusal without a card, and a cell, mix, configuration and
per-layer metric added by new files alone."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from portbench import counts, harness  # noqa: E402
from portbench.tests import tiny  # noqa: E402

QWEN = dict(hidden_size=1024, intermediate_size=3072, num_hidden_layers=28, num_attention_heads=16,
            num_key_value_heads=8, head_dim=128)
BERT = dict(hidden_size=768, intermediate_size=3072, num_hidden_layers=12, num_attention_heads=12)


def _load(name):
    from portbench import spec

    return spec.metric_reader(name)


def test_bounds_at_the_kernel_tables_shapes():
    assert _load("b1_roofline.search").b1_bound_ms(1024, 1_048_576, 1024) == pytest.approx(1.111, abs=5e-4)
    assert _load("b2_roofline.embed").b2_bound_ms(512, 64, 16, 8, 128) == pytest.approx(0.125, abs=5e-4)
    assert counts.bound(3.35e9, {"bf16": 1.0})["bound_by"] == "bytes"


def test_model_flops_by_hand():
    # qwen, one sequence of 20 tokens: per layer q 1024x2048, k and v
    # 1024x1024, o 2048x1024, gate/up/down 3 x 1024x3072, norms
    # 2 x 1024 + 2 x 128; the final norm 1024; causal pairs 20*21/2
    per_layer = 2097152 + 2 * 1048576 + 2097152 + 3 * 3145728 + 2048 + 256
    p = 28 * per_layer + 1024
    assert counts.non_embedding_params(QWEN, "qwen") == p == 440_467_456
    att = 28 * 4 * 16 * 128 * 210
    assert counts.model_flops(QWEN, "qwen", [20]) == 2 * p * 20 + att
    # BERT, one sequence of 10 tokens: per layer 4 x (768^2 + 768),
    # 768x3072 + 3072, 3072x768 + 768, two LayerNorms; the embedding
    # LayerNorm; all 10 x 10 pairs
    per_layer = 4 * (589824 + 768) + (2359296 + 3072) + (2359296 + 768) + 4 * 768
    p = 12 * per_layer + 2 * 768
    assert counts.non_embedding_params(BERT, "bert") == p == 85_056_000
    assert counts.model_flops(BERT, "bert", [10]) == 2 * p * 10 + 12 * 4 * 768 * 100


LINE_KEYS = ["correct", "attempted", "failed", "metrics", "device", "notes", "checks"]
CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]
CELLS += tiny.SERVE_CELLS


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_every_loop_gives_the_whole_line_on_the_cpu(cell, trace):
    o = tiny.overrides(cell)
    o["params"].update(trace_offset_s=0.2, trace_seconds=0.5)
    out = harness.run(cell, 2**31 + 11, 3.0, trace, device="cpu", overrides=o)
    keys = [k for k in out if k != "breakdown"]
    assert keys == LINE_KEYS and list(out)[-1] == "checks"
    assert out["attempted"] > 0 and out["failed"] == 0
    assert set(out["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    assert out["checks"] and all(set(c) == {"value", "limit"} for c in out["checks"].values())
    from portbench import spec

    cs = spec.cell_spec(cell, o)
    want = cs["per_layer"] if trace else cs["end_to_end"]
    host_only = {m["name"] for m in want if m["source"] != "device_trace"}
    assert host_only <= set(out["metrics"])
    if trace:
        assert {"busy_s", "window_s"} <= set(out["device"])
        assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert "setup_s" in out["metrics"] and len(out["metrics"]) >= 2


def test_search_check_covers_every_batch():
    """The calls the search loop keeps for its check take in every batch
    of queries it cycles through, whatever the seeded offset."""
    cell = "qwen3-emb-0.6b.search-b1024"
    for seed in (5, 2**31 + 6):
        o = tiny.overrides(cell)
        o["params"].update(batch=16, query_batches=4, keep_every=2)
        out = harness.run(cell, seed, 6.0, False, device="cpu", overrides=o)
        assert out["notes"]["kept_batches"] == [0, 1, 2, 3], out["notes"]


def test_blocked_lengths_vary_by_page_not_by_seed():
    """Every block of slogan lengths holds the same multiset whatever the
    seed, while the longest slogan of a page varies from page to page."""
    from portbench import textgen

    spec = {"median": 40, "p5": 16, "p95": 140, "min": 4, "max": 510}
    a = textgen.blocked_lengths(3 * 4096, 4096, spec, textgen.seed_rng(1, "slen"))
    b = textgen.blocked_lengths(3 * 4096, 4096, spec, textgen.seed_rng(2**33 + 1, "slen"))
    for blk in range(3):
        assert sorted(a[blk * 4096 : (blk + 1) * 4096]) == sorted(b[blk * 4096 : (blk + 1) * 4096])
    page_max = a.reshape(-1, 256).max(axis=1)
    assert page_max.max() > 300 and page_max.min() < 254 and len(set(page_max.tolist())) > 8
    assert not (a == b).all()


def test_one_reader_serves_a_metric_in_every_cell():
    from portbench import spec

    for name in ("device_idle.search", "device_idle.embed", "device_idle.train"):
        assert Path(spec.metric_reader(name).__file__).name == "device_idle.py"
    assert Path(spec.metric_reader("b1_roofline.search").__file__).name == "b1_roofline.search.py"


def test_run_refuses_without_a_card(tmp_path):
    r = subprocess.run([sys.executable, str(ROOT / "portbench" / "run.py"), "--workload",
                        CELLS[0], "--seed", "5", "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, cwd=ROOT, timeout=120)
    assert r.returncode != 0 and r.stdout.strip() == ""
    # and in a checkout of the benchmark's files alone
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "_cache"))
    r = subprocess.run([sys.executable, "portbench/run.py", "--workload", CELLS[0], "--seed", "5",
                        "--seconds", "1", "--trace", "0"], capture_output=True, text=True,
                       cwd=tmp_path, timeout=120)
    assert r.returncode != 0 and r.stdout.strip() == ""


def test_a_cell_mix_config_and_metric_by_new_files_alone(tmp_path):
    """A throwaway cell (a new mix, configuration, cell and per-layer
    metric) in a copy of the benchmark: files added, none edited."""
    pb = tmp_path / "portbench"
    shutil.copytree(ROOT / "portbench", pb, ignore=shutil.ignore_patterns("__pycache__", "_cache"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cfg = json.loads((pb / "configs" / "qwen3-emb-0.6b.json").read_text())
    cfg["name"] = "qwen3-emb-0.6b-copy"
    (pb / "configs" / "qwen3-emb-0.6b-copy.json").write_text(json.dumps(cfg))
    mix = json.loads((pb / "traffic" / "search-b1024.json").read_text())
    mix["batch"] = 256
    (pb / "traffic" / "search-b256.json").write_text(json.dumps(mix))
    (pb / "workloads" / "qwen3-emb-0.6b-copy.search-b256.json").write_text(json.dumps(
        {"config": "qwen3-emb-0.6b-copy", "traffic": "search-b256", "chips": 1, "params": {},
         "limits": {"recall_miss": 1.0, "score_gap": 1.0}}))
    (pb / "metrics" / "calls.search256.py").write_text(
        "def read(ctx):\n    return float(ctx.attempted)\n")
    cell = "qwen3-emb-0.6b-copy.search-b256"
    bench["workloads"].append({"name": cell, "config": "qwen3-emb-0.6b-copy",
                               "traffic": "search-b256", "chips": 1, "why": "test"})
    for m in bench["end_to_end"]:
        if m["name"] == "search_qps":
            m["workloads"].append(cell)
    bench["per_layer"].append({"name": "calls.search256", "unit": "queries", "better": "higher",
                               "source": "host_clock", "layer": "engine", "moves": "search_qps",
                               "workloads": [cell]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    before = {p.relative_to(ROOT / "portbench"): p.read_bytes() for p in (ROOT / "portbench").rglob("*")
              if p.is_file() and "__pycache__" not in p.parts and "_cache" not in p.parts}
    after = {p.relative_to(pb): p.read_bytes() for p in pb.rglob("*")
             if p.is_file() and "__pycache__" not in p.parts}
    assert all(after[k] == v for k, v in before.items())    # nothing edited
    code = (
        "import sys, json\n"
        f"sys.path[:0] = [{str(tmp_path)!r}, {str(ROOT)!r}]\n"
        "from portbench import harness\n"
        "from portbench.tests import tiny\n"
        f"o = tiny.overrides('qwen3-emb-0.6b.search-b1024'); o['params']['batch'] = 32\n"
        f"out = harness.run({cell!r}, 3, 1.0, True, device='cpu', overrides=o)\n"
        "print(json.dumps(out))\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=tmp_path,
                       timeout=300, env={**os.environ, "PYTHONDONTWRITEBYTECODE": "1"})
    assert r.returncode == 0, r.stderr[-2000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["metrics"]["calls.search256"]["value"] == out["attempted"] > 0
    assert out["correct"] is True
