"""What a run loads: no module whose top-level name is jax, jaxlib, flax
or theoremsearch_tpu (whole names: theoremsearch_tpu_torch is the port);
and the reference imports nothing of the port."""

import ast
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
PB = ROOT / "portbench"
FORBIDDEN = {"jax", "jaxlib", "flax", "theoremsearch_tpu"}


def _fresh(code: str) -> list:
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       cwd=ROOT, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


def test_every_cell_loads_no_jax():
    code = (
        "import sys, json\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        "from portbench import harness, spec, calibrate, knee\n"
        "from portbench.tests import tiny\n"
        "bench = spec.benchmark()\n"
        "for m in tiny.with_serve(bench)['per_layer']: spec.metric_reader(m['name'])\n"
        "for name in [w['name'] for w in bench['workloads']] + tiny.SERVE_CELLS:\n"
        "    o = tiny.overrides(name); o['params'].update(trace_offset_s=0.2, trace_seconds=0.3)\n"
        "    harness.run(name, 5, 0.8, True, device='cpu', overrides=o)\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    loaded = set(_fresh(code))
    assert "theoremsearch_tpu_torch" in loaded and "torch" in loaded
    assert not loaded & FORBIDDEN, loaded & FORBIDDEN


def _imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def test_reference_imports_nothing_of_the_port():
    for path in (PB / "reference").glob("*.py"):
        assert not _imports(path) & (FORBIDDEN | {"theoremsearch_tpu_torch", "portbench"}), path
    code = (
        "import sys, json\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        "import portbench.reference.towers, portbench.reference.search, portbench.reference.tokenizer\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    loaded = set(_fresh(code))
    assert not loaded & (FORBIDDEN | {"theoremsearch_tpu_torch"})


def test_no_benchmark_file_imports_jax():
    for path in PB.rglob("*.py"):
        assert not _imports(path) & FORBIDDEN, path
