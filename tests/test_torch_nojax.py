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
SOURCES = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py", ROOT / "tools" / "torch_kernel_ab.py",
                                       ROOT / "tools" / "torch_mp_train_probe.py",
                                       ROOT / "tests" / "torch_multihost_worker.py",
                                       ROOT / "tests" / "test_torch_distributed.py",
                                       ROOT / "tests" / "test_torch_profiling.py",
                                       ROOT / "tests" / "test_torch_spans.py",
                                       ROOT / "tests" / "test_torch_moe_cuda.py"]


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
                 "eval.oracle", "train.contrastive", "train.lora", "train.checkpoint", "train.data",
                 "eval.harness", "cli", "encoder.gemma", "encoder.bert", "encoder.families",
                 "encoder.loader", "core.meshes", "core.distributed", "utils.profiling",
                 "ingest.parse_driver", "ingest.latex.extract", "slogans.generate", "eval.quality",
                 "serve.ui", "encoder.deepseek", "encoder.towers", "kernels.moe"):
        assert f"theoremsearch_tpu_torch.{want}" in MODULES
    assert {p.name for p in (PKG / "csrc").iterdir()} >= {
        "mips_g.cu", "mips_topk.cu", "attention.cu", "attention_bwd.cu", "layer_int8.cu",
        "ivf_scores.cu", "int8_mma.cuh", "moe.cu"}
    importlib.import_module("theoremsearch_tpu_torch.kernels._build")


def test_test_helpers_and_meshes_need_no_jax():
    """tests/torch_helpers.py (which the card tests import, on a machine
    without jax) and a CPU mesh engine import and run with jax blocked."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['ml_dtypes'] = None\n"
        "sys.path.insert(0, 'tests')\n"
        "import numpy as np\n"
        "from torch_helpers import cpu_mesh, ids_agree\n"
        "from theoremsearch_tpu_torch.core import make_mesh, shard_axis_size\n"
        "from theoremsearch_tpu_torch.index.flat import FlatIndex\n"
        "from theoremsearch_tpu_torch.search.engine import SearchEngine\n"
        "x = np.random.default_rng(0).standard_normal((600, 32)).astype(np.float32)\n"
        "m = cpu_mesh(4)\n"
        "assert shard_axis_size(m) == 4\n"
        "e = SearchEngine(FlatIndex.build(x, device='cpu'), mesh=m, row_block=128)\n"
        "s, i = e.search_vectors(x[:3], k=5)\n"
        "ids_agree(s, i, s, i)\n"
        "assert (i[:, 0] == np.arange(3)).all()\n"
        "assert not any(k == 'jax' or k.startswith(('jax.', 'theoremsearch_tpu.'))"
        " or k == 'theoremsearch_tpu' for k in sys.modules if sys.modules[k] is not None)\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-3000:]


# the jax-free reference modules the port carries as copies, because
# their packages' __init__s import jax
VERBATIM = ["core/config.py", "utils/shapes.py", "utils/gc_tuning.py", "search/metadata.py",
            "search/filters.py", "encoder/tokenizer.py", "serve/latex_display.py",
            "eval/metrics.py", "train/data.py", "eval/harness.py", "encoder/families.py",
            "ingest/catalog.py", "eval/experiments.py",
            # the front of the pipeline: ingest, slogans, the quality probes
            "utils/tracing.py", "utils/progress.py", "ingest/__init__.py",
            "ingest/latex/__init__.py", "ingest/latex/scanner.py", "ingest/latex/numbering.py",
            "ingest/latex/declarations.py", "ingest/latex/macros.py", "ingest/latex/extract.py",
            "ingest/main_tex.py", "ingest/sources.py", "ingest/methods/__init__.py",
            "ingest/methods/flatten.py", "ingest/methods/tex_capture.py",
            "ingest/methods/plastex_method.py", "ingest/parse_driver.py", "ingest/stacks.py",
            "ingest/citations.py", "ingest/arxiv_api.py", "slogans/__init__.py",
            "slogans/prompts.py", "slogans/client.py", "slogans/cost.py", "slogans/generate.py",
            "slogans/batch.py", "eval/quality.py"]
PROMPT_CONFIGS = sorted(p.name for p in (ROOT / "theoremsearch_tpu" / "slogans" / "prompt_configs").iterdir())


@pytest.mark.parametrize("rel", VERBATIM)
def test_verbatim_copies_match_their_source(rel):
    lines = (PKG / rel).read_text().splitlines(keepends=True)
    assert lines[0].startswith(f"# Verbatim copy of theoremsearch_tpu/{rel} ")
    assert "".join(lines[2:]) == (ROOT / "theoremsearch_tpu" / rel).read_text()


@pytest.mark.parametrize("name", PROMPT_CONFIGS)
def test_prompt_configs_are_byte_equal(name):
    """The shipped slogan prompt configs (and their README) are data the
    port carries byte for byte: prompt ids key the slogan versions."""
    assert len(PROMPT_CONFIGS) == 4
    got = PKG / "slogans" / "prompt_configs" / name
    assert got.read_bytes() == (ROOT / "theoremsearch_tpu" / "slogans" / "prompt_configs" / name).read_bytes()


def test_ingest_and_slogans_leave_cuda_alone():
    """The front of the pipeline is host work: importing it loads no torch
    (so a parse child forked from it carries no CUDA state), and a process
    that has imported it has no CUDA context."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "import theoremsearch_tpu_torch.ingest, theoremsearch_tpu_torch.slogans\n"
        "import theoremsearch_tpu_torch.ingest.parse_driver, theoremsearch_tpu_torch.ingest.stacks\n"
        "import theoremsearch_tpu_torch.ingest.arxiv_api, theoremsearch_tpu_torch.slogans.batch\n"
        "assert 'torch' not in sys.modules, 'the ingest and slogan modules imported torch'\n"
        "import torch\n"
        "assert not torch.cuda.is_initialized()\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-3000:]
