"""serve/ui.py's service on the CPU: the port's build_service(device="cpu")
and the reference's build_service, each from the environment variables
the Streamlit app reads (THEOREMSEARCH_CATALOG, THEOREMSEARCH_SPOOL,
THEOREMSEARCH_MODEL_DIR) over copies of one catalog and one checkpoint,
answer the same query with the same ids. Without a device the port's
service wants the card; the Streamlit page itself stays behind its gated
import in both packages."""

import gzip
import json
import shutil

import numpy as np
import pytest
import torch

from chip_smoke import qwen_checkpoint, write_safetensors
from theoremsearch_tpu.serve import ui as jax_ui
from theoremsearch_tpu_torch.core.config import EncoderConfig
from theoremsearch_tpu_torch.ingest import Catalog
from theoremsearch_tpu_torch.ingest.parse_driver import parse_papers
from theoremsearch_tpu_torch.serve import ui
from theoremsearch_tpu_torch.slogans import OfflineStubClient, generate_slogans, load_prompt

torch.set_num_threads(1)
TOPICS = [f"{a} {b}" for a in ("compact", "prime", "random", "smooth", "finite")
          for b in ("groups", "gaps", "walks", "curves", "spaces", "forms")]
CFG = EncoderConfig(vocab_size=1024, hidden_size=64, intermediate_size=128, num_layers=2,
                    num_heads=4, num_kv_heads=2, head_dim=16, embedding_dim=64)


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """A catalog filled through the port's ingest (30 papers, one theorem
    and one slogan each) and a qwen-layout checkpoint of a small config."""
    root = tmp_path_factory.mktemp("ui")
    cat = Catalog(str(root / "cat.db"))
    sources = {}
    for i, topic in enumerate(TOPICS):
        pid = f"2403.{i:05d}"
        cat.upsert_paper({
            "paper_id": pid, "title": f"A paper on {topic}", "authors": [f"Author {i % 4}"],
            "summary": f"We study {topic}.", "link": f"https://arxiv.org/abs/{pid}",
            "last_updated": f"{2001 + i % 20}-01-01", "journal_ref": None,
            "primary_category": "math.NT", "categories": ["math.NT"], "citations": i})
        sources[pid] = gzip.compress(
            ("\\documentclass{article}\n\\newtheorem{theorem}{Theorem}\n\\begin{document}\n"
             f"\\begin{{theorem}} Every statement about {topic} has constant {i}. \\end{{theorem}}\n"
             "\\end{document}\n").encode())
    assert parse_papers(cat, source_fetcher=lambda pid: sources[pid], timeout_s=30).parsed == 30
    generate_slogans(cat, load_prompt("body-only-v1"), OfflineStubClient())
    cat.close()
    model_dir = root / "qwen"
    model_dir.mkdir()
    config, tensors = qwen_checkpoint(CFG, torch.device("cpu"), seed=4)
    (model_dir / "config.json").write_text(json.dumps(config))
    write_safetensors(str(model_dir / "model.safetensors"), tensors)
    return root / "cat.db", str(model_dir)


def _env(monkeypatch, workdir, catalog, model_dir):
    workdir.mkdir()
    db = shutil.copy(catalog, workdir / "cat.db")
    monkeypatch.chdir(workdir)                       # feedback.jsonl lands here
    monkeypatch.setenv("THEOREMSEARCH_CATALOG", str(db))
    monkeypatch.setenv("THEOREMSEARCH_SPOOL", str(workdir / "spool"))
    monkeypatch.setenv("THEOREMSEARCH_MODEL_DIR", model_dir)
    monkeypatch.setenv("THEOREMSEARCH_EMBEDDER", "qwen")


def test_build_service_matches_the_reference(inputs, tmp_path, monkeypatch):
    catalog, model_dir = inputs
    _env(monkeypatch, tmp_path / "jax", catalog, model_dir)
    jsvc = jax_ui.build_service()
    _env(monkeypatch, tmp_path / "torch", catalog, model_dir)
    svc = ui.build_service(device="cpu")
    assert svc.engine.n_valid == jsvc.engine.n_valid == 30
    assert svc.load_theorem_count() == jsvc.load_theorem_count() == 30
    assert svc.load_authors() == jsvc.load_authors()
    for query in ("prime gaps", "smooth curves", "random walks with constant 7"):
        for filters in ({"top_k": 5}, {"top_k": 5, "year_range": (2005, 2015), "citation_weight": 0.2}):
            want = jsvc.search_and_display(query, filters)
            got = svc.search_and_display(query, filters)
            assert len(got) == len(want) > 0
            ws = np.array([r["score"] for r in want])
            np.testing.assert_allclose([r["score"] for r in got], ws, atol=2e-3)
            for r, (a, b) in enumerate(zip(got, want)):
                near = np.abs(ws - ws[r]) <= 4e-3
                assert a["doc_id"] == b["doc_id"] or near.sum() > 1, (query, r)
    assert svc.save_feedback("up", "prime gaps", "https://arxiv.org/abs/2403.00001", "Theorem 1.")
    rec = json.loads((tmp_path / "torch" / "feedback.jsonl").read_text().splitlines()[-1])
    assert rec["feedback"] == "up" and rec["query"] == "prime gaps"


def test_build_service_defaults_to_the_card(inputs, tmp_path, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is the card")
    _env(monkeypatch, tmp_path / "torch", *inputs)
    with pytest.raises(RuntimeError, match="CUDA device is required"):
        ui.build_service()


def test_streamlit_page_is_gated_in_both():
    """Neither package imports streamlit until main() runs; without it,
    main() raises ImportError in both."""
    try:
        import streamlit  # noqa: F401

        pytest.skip("streamlit installed")
    except ImportError:
        pass
    for mod in (jax_ui, ui):
        with pytest.raises(ImportError):
            mod.main()
