"""The port stands alone: it imports torch and never jax, ml_dtypes or
the reference package (the CUDA machine has no jax)."""

import ast
import importlib
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest

import theoremsearch_tpu_torch

PKG = Path(theoremsearch_tpu_torch.__file__).resolve().parent
ROOT = PKG.parent
MODULES = sorted(
    m.name for m in pkgutil.walk_packages([str(PKG)], "theoremsearch_tpu_torch.")
)
SOURCES = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def test_every_module_imports_with_jax_blocked():
    code = (
        "import sys, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['ml_dtypes'] = None\n"
        f"for m in {MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "assert not any(k == 'jax' or k.startswith(('jax.', 'theoremsearch_tpu.'))"
        " or k == 'theoremsearch_tpu' for k in sys.modules if sys.modules[k] is not None)\n"
        "print(len(sys.modules))\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-3000:]


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_source_names_no_jax_or_reference_package(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        for n in names:
            top = n.split(".")[0]
            assert top not in ("jax", "jaxlib", "ml_dtypes", "theoremsearch_tpu"), (path, n)


def test_module_list_covers_the_slice():
    for want in ("kernels.mips", "kernels.attention", "kernels.layer_int8", "encoder.model",
                 "encoder.batching", "search.engine", "serve.scheduler", "serve.app",
                 "serve.http_api", "index.flat", "index.quant", "index.ivf", "index.builder",
                 "eval.oracle"):
        assert f"theoremsearch_tpu_torch.{want}" in MODULES
    assert {p.name for p in (PKG / "csrc").iterdir()} >= {
        "mips_g.cu", "mips_topk.cu", "attention.cu", "layer_int8.cu", "ivf_scores.cu",
        "int8_mma.cuh"}
    importlib.import_module("theoremsearch_tpu_torch.kernels._build")


# the jax-free reference modules the port carries as copies, because
# their packages' __init__s import jax
VERBATIM = ["core/config.py", "utils/shapes.py", "utils/gc_tuning.py", "search/metadata.py",
            "search/filters.py", "encoder/tokenizer.py", "serve/latex_display.py",
            "eval/metrics.py"]


@pytest.mark.parametrize("rel", VERBATIM)
def test_verbatim_copies_match_their_source(rel):
    lines = (PKG / rel).read_text().splitlines(keepends=True)
    assert lines[0].startswith(f"# Verbatim copy of theoremsearch_tpu/{rel} ")
    assert "".join(lines[2:]) == (ROOT / "theoremsearch_tpu" / rel).read_text()
