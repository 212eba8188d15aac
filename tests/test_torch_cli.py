"""The port's command line (theoremsearch_tpu_torch/cli.py) on the CPU:
every device subcommand through `run([...])` with `--device cpu`, on a
catalog filled as the JAX tests fill theirs and a synthetic qwen
checkpoint (`--model-dir`), held to the JAX package's CLI on the same
inputs where both compute the same thing; the serving stack with a
catalog refresh thread (a twin of tests/test_live_refresh.py's server
case); the compare-embedders cases of tests/test_experiments.py; and the
entry point."""

import csv
import gzip
import json
import shutil
import subprocess
import sys
import threading
import time
import urllib.request
from argparse import Namespace
from pathlib import Path

import numpy as np
import pytest
import torch

from theoremsearch_tpu.cli import main as jax_main
from theoremsearch_tpu.ingest.catalog import Catalog as JCatalog
from theoremsearch_tpu.ingest.parse_driver import parse_papers
from theoremsearch_tpu.slogans import OfflineStubClient, generate_slogans, load_prompt
from theoremsearch_tpu_torch.cli import build_parser, main, make_search_server, run
from theoremsearch_tpu_torch.entry import entry
from theoremsearch_tpu_torch.eval.experiments import compare_embedders
from theoremsearch_tpu_torch.index.builder import IndexBuilder
from theoremsearch_tpu_torch.index.ivf import IVFIndex
from theoremsearch_tpu_torch.ingest import Catalog

safetensors_numpy = pytest.importorskip("safetensors.numpy")

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parent.parent
QWEN = {"vocab_size": 1024, "hidden_size": 64, "intermediate_size": 128, "num_hidden_layers": 2,
        "num_attention_heads": 4, "num_key_value_heads": 2, "head_dim": 16,
        "rope_theta": 1000000.0, "rms_norm_eps": 1e-6}
DEVICE_CMDS = ["embed", "build-ivf", "search", "serve", "eval", "compare-embedders", "train"]
HOST_ONLY = ["ingest-arxiv", "locate-s3", "parse", "stacks", "slogans", "ingest-tex", "quality"]


def _fill(cat, topics, prefix="2401", start=0):
    sources = {}
    for i, topic in enumerate(topics, start):
        pid = f"{prefix}.{i:05d}"
        cat.upsert_paper({
            "paper_id": pid, "title": f"A paper on {topic}", "authors": ["Author X"],
            "summary": f"We study {topic}.", "link": f"https://arxiv.org/abs/{pid}",
            "last_updated": f"{2000 + i % 20}-01-01", "journal_ref": None,
            "primary_category": "math.NT", "categories": ["math.NT"], "citations": i,
        })
        tex = ("\\documentclass{article}\n\\newtheorem{theorem}{Theorem}[section]\n"
               "\\begin{document}\\section{Intro}\n"
               f"\\begin{{theorem}} Every result about {topic} holds with bound {i}. "
               "\\end{theorem}\n\\end{document}\n")
        sources[pid] = gzip.compress(tex.encode())
    parse_papers(cat, source_fetcher=lambda pid: sources[pid], timeout_s=30)
    generate_slogans(cat, load_prompt("body-only-v1"), OfflineStubClient())


TOPICS = [f"{a} {b}" for a in ("compact", "prime", "random", "smooth", "finite", "modular")
          for b in ("groups", "gaps", "walks", "curves", "spaces", "forms", "graphs")]


@pytest.fixture(scope="module")
def catalog_file(tmp_path_factory):
    path = tmp_path_factory.mktemp("catalog") / "cat.db"
    cat = JCatalog(str(path))
    _fill(cat, TOPICS)
    assert cat.count("theorem_slogan") == len(TOPICS) == 42
    cat.close()
    return path


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    """A qwen-layout safetensors checkpoint with the qwen role prompts."""
    path = tmp_path_factory.mktemp("qwen")
    rng = np.random.default_rng(0)
    H, I, Dh = QWEN["hidden_size"], QWEN["intermediate_size"], QWEN["head_dim"]
    q, kv = Dh * QWEN["num_attention_heads"], Dh * QWEN["num_key_value_heads"]

    def w(*shape):
        return (0.05 * rng.standard_normal(shape)).astype(np.float32)

    t = {"model.embed_tokens.weight": 0.4 * w(QWEN["vocab_size"], H),
         "model.norm.weight": np.ones(H, np.float32)}
    for i in range(QWEN["num_hidden_layers"]):
        p = f"model.layers.{i}."
        t |= {p + "input_layernorm.weight": np.ones(H, np.float32),
              p + "post_attention_layernorm.weight": np.ones(H, np.float32),
              p + "self_attn.q_norm.weight": np.ones(Dh, np.float32),
              p + "self_attn.k_norm.weight": np.ones(Dh, np.float32),
              p + "self_attn.q_proj.weight": w(q, H), p + "self_attn.k_proj.weight": w(kv, H),
              p + "self_attn.v_proj.weight": w(kv, H), p + "self_attn.o_proj.weight": w(H, q),
              p + "mlp.gate_proj.weight": w(I, H), p + "mlp.up_proj.weight": w(I, H),
              p + "mlp.down_proj.weight": w(H, I)}
    safetensors_numpy.save_file(t, str(path / "model.safetensors"))
    (path / "config.json").write_text(json.dumps({"model_type": "qwen3", **QWEN}))
    (path / "config_sentence_transformers.json").write_text(json.dumps(
        {"prompts": {"query": "Instruct: find the theorem\nQuery:", "document": ""}}))
    return str(path)


def _copy(src, dst_dir):
    dst_dir.mkdir(parents=True, exist_ok=True)
    return str(shutil.copy(src, dst_dir / "cat.db"))


def _spool_rows(spool):
    ids, emb = map(np.concatenate, zip(*IndexBuilder(spool).batches()))
    order = np.argsort(ids)
    return ids[order], emb[order]


# ------------------------------------------------------------ the surface


def test_help_lists_the_device_subcommands():
    res = subprocess.run([sys.executable, "-m", "theoremsearch_tpu_torch", "--help"], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]
    for cmd in DEVICE_CMDS:
        assert cmd in res.stdout
    for cmd in HOST_ONLY:
        assert cmd not in res.stdout
    sub = build_parser()._subparsers._group_actions[0].choices
    assert sorted(sub) == sorted(DEVICE_CMDS)
    for cmd, parser in sub.items():
        assert "--device" in parser.format_help(), cmd


@pytest.mark.parametrize("cmd", DEVICE_CMDS)
def test_device_subcommands_need_the_card_without_device_cpu(cmd, tmp_path, catalog_file):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is the card")
    db = _copy(catalog_file, tmp_path)
    spool = str(tmp_path / "spool")
    if cmd == "build-ivf":      # a spool to pack, so the build reaches the device
        IndexBuilder(spool).add(np.arange(4), np.eye(4, 8, dtype=np.float32))
    argv = {"embed": ["embed", "--spool", spool], "build-ivf": ["build-ivf", "--spool", spool],
            "search": ["search", "x", "--spool", spool], "serve": ["serve", "--spool", spool],
            "eval": ["eval"], "compare-embedders": ["compare-embedders", "--families", "qwen"],
            "train": ["train", "--steps", "1"]}[cmd]
    with pytest.raises(RuntimeError, match="CUDA device is required"):
        main(["--catalog", db] + argv)


def test_model_dir_without_tokenizer_files_gets_the_hermetic_tokenizer(model_dir, monkeypatch):
    """A checkpoint dir whose tokenizer transformers refuses to load gets
    the hermetic tokenizer, as in the reference's get_tokenizer."""
    from theoremsearch_tpu_torch.cli import _batched_encoder
    from theoremsearch_tpu_torch.encoder import tokenizer as tokenizer_mod

    def refuse(path):
        raise OSError(f"no tokenizer files in {path}")

    monkeypatch.setattr(tokenizer_mod, "HFTokenizer", refuse)
    be = _batched_encoder(Namespace(model_dir=model_dir, device="cpu"))
    assert type(be.tokenizer).__name__ == "SimpleTokenizer"
    assert len(be.tokenizer.tokenize("every compact group")) == 3
    emb = be.encode(["every compact group", "a random walk"])
    assert float(emb[0] @ emb[1]) < 0.99


def test_model_dir_tokenizer_without_tokens_raises(model_dir, monkeypatch):
    """Some transformers versions build a tokenizer from config.json alone
    that maps every text to no tokens; every slogan would then embed
    alike, so the CLI refuses it."""
    from theoremsearch_tpu_torch.cli import _batched_encoder
    from theoremsearch_tpu_torch.encoder import tokenizer as tokenizer_mod

    class Empty:
        def __init__(self, path):
            pass

        def tokenize(self, text):
            return []

    monkeypatch.setattr(tokenizer_mod, "HFTokenizer", Empty)
    with pytest.raises(ValueError, match="maps text to no tokens"):
        _batched_encoder(Namespace(model_dir=model_dir, device="cpu"))


def test_model_dir_with_tokenizer_files_loads_them(model_dir, tmp_path):
    """A checkpoint dir with tokenizer files (chip_smoke.py's WordLevel
    tokenizer): both CLIs load the same HuggingFace tokenizer and embed
    alike."""
    from chip_smoke import word_level_tokenizer
    from theoremsearch_tpu.cli import _batched_encoder as jax_batched_encoder
    from theoremsearch_tpu_torch.cli import _batched_encoder

    md = tmp_path / "qwen"
    shutil.copytree(model_dir, md)
    word_level_tokenizer(str(md), ["every", "compact", "group", "a", "random", "walk", "of", "rank"])
    be = _batched_encoder(Namespace(model_dir=str(md), device="cpu"))
    jbe = jax_batched_encoder(Namespace(model_dir=str(md)))
    assert type(be.tokenizer).__name__ == "HFTokenizer"
    assert be.tokenizer.tokenize("Every compact group of rank 12") == [3, 4, 5, 9, 10, 1]
    texts = ["every compact group of rank 12", "a random walk of rank 21"]
    emb, jemb = be.encode(texts), np.asarray(jbe.encode(texts))
    assert float(emb[0] @ emb[1]) < 0.99
    assert float(np.min(np.sum(emb.astype(np.float64) * jemb, axis=1))) > 0.999


def test_entry_on_the_cpu():
    fn, args = entry(device="cpu")
    out = fn(*args)
    assert out.shape == (8, 128) and bool(torch.isfinite(out).all())
    torch.testing.assert_close(out.norm(dim=1), torch.ones(8))
    assert torch.equal(out[0], out[2])          # the two texts, four times


# ------------------------------------------- embed, search, build-ivf


def test_embed_search_build_ivf_twin(tmp_path, catalog_file, model_dir, capsys):
    """embed through both CLIs on the same checkpoint: the same slogan ids
    spooled, vectors at cosine > 0.999 (bf16 forwards), the same manifest;
    a second embed embeds 0. Then search (the speed route on the residual
    spool, the reference CLI's first hit) and build-ivf --calibrate."""
    db_j, db_p = _copy(catalog_file, tmp_path / "jax"), _copy(catalog_file, tmp_path / "torch")
    sp_j, sp_p = str(tmp_path / "jax" / "spool"), str(tmp_path / "torch" / "spool")
    common = ["embed", "--model-dir", model_dir, "--index-dtype", "int8-global-residual"]
    jax_main(["--catalog", db_j] + common + ["--spool", sp_j])
    assert run(["--catalog", db_p] + common + ["--spool", sp_p, "--device", "cpu"]) == 42
    assert run(["--catalog", db_p] + common + ["--spool", sp_p, "--device", "cpu"]) == 0
    (ids_j, emb_j), (ids_p, emb_p) = _spool_rows(sp_j), _spool_rows(sp_p)
    np.testing.assert_array_equal(ids_p, ids_j)
    assert float(np.min(np.sum(emb_p.astype(np.float64) * emb_j, axis=1))) > 0.999
    man = [sorted(map(tuple, Catalog(db).conn.execute(
        "SELECT embedder, slogan_id, shard FROM embedding_manifest"))) for db in (db_j, db_p)]
    assert man[0] == man[1] and len(man[0]) == 42
    capsys.readouterr()

    query = Catalog(db_p).conn.execute(
        "SELECT slogan FROM theorem_slogan ORDER BY slogan_id LIMIT 1 OFFSET 7").fetchone()[0]
    search = ["search", query, "--model-dir", model_dir, "--top-k", "3"]
    jax_main(["--catalog", db_j] + search + ["--spool", sp_j])
    jax_out = capsys.readouterr().out.splitlines()
    engine = run(["--catalog", db_p] + search + ["--spool", sp_p, "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert engine.route_counts.get("speed", 0) == 1 and engine.n_valid == 42
    assert len([ln for ln in out if ln.startswith("[")]) == 3
    # the same first hit as the reference's CLI (the line after its score)
    assert out[0].split("] ", 1)[1] == jax_out[0].split("] ", 1)[1]
    assert abs(float(out[0][1:7]) - float(jax_out[0][1:7])) <= 2e-3

    index, (nprobe, recall) = run(["--catalog", db_p, "build-ivf", "--spool", sp_p, "--nlist", "4",
                                    "--calibrate", "--out", str(tmp_path / "ivf"), "--device", "cpu"])
    assert recall >= 0.99 and index.config.ivf_nprobe == nprobe
    assert index.config.ivf_nprobe_calibrated and index.slabs.shape[0] == 4
    loaded = IVFIndex.load(tmp_path / "ivf", device="cpu")
    assert loaded.num_rows == 42 and loaded.config.ivf_nprobe == nprobe
    assert "calibrated nprobe=" in capsys.readouterr().out


# ----------------------------------------------------- eval and compare


def test_eval_with_model_dir(model_dir, capsys, validation_csv):
    argv = ["eval", "--model-dir", model_dir, "--validation", validation_csv]
    jax_main(argv)
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    m = run(argv + ["--device", "cpu"])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(printed) == set(m) == set(want) and len(m) == 7
    assert m["num_queries"] == want["num_queries"] > 0
    assert all(np.isfinite(v) and 0.0 <= v <= 1.0 for k, v in m.items() if k != "num_queries")
    # both print 4 decimal places: the same metrics, to one unit of the last
    # (queries and documents through their own role encoders in both)
    for k in want:
        assert abs(printed[k] - want[k]) <= 1.0001e-4, (k, printed[k], want[k])
        assert printed[k] == round(m[k], 4)


def test_compare_embedders_cli(capsys, validation_csv, model_dir):
    """Twin of tests/test_experiments.py's CLI case, plus a checkpoint dir."""
    assert main(["compare-embedders", "--families", "qwen", "bert", "--model-dir", model_dir,
                 "--validation", validation_csv, "--device", "cpu"]) == 0   # a console exit code
    lines = [ln for ln in capsys.readouterr().out.strip().splitlines() if ln]
    assert lines[0].startswith("embedder\t")
    assert {ln.split("\t")[0] for ln in lines[1:-1]} == {"qwen", "bert", model_dir}
    assert lines[-1].startswith("best (by H@k):")


def test_compare_embedders_role_pairs(validation_csv):
    """Twin of tests/test_experiments.py's role-pair case: documents are
    encoded by the document encoder, queries by the query encoder."""
    calls = {"q": 0, "d": 0}

    def bow(texts):
        out = np.zeros((len(texts), 64), np.float32)
        for i, t in enumerate(texts):
            for tok in t.lower().split():
                out[i, sum(map(ord, tok)) % 64] += 1.0
        return out / np.maximum(np.linalg.norm(out, axis=1, keepdims=True), 1e-9)

    def q_enc(texts):
        calls["q"] += 1
        return bow(texts)

    def d_enc(texts):
        calls["d"] += 1
        return bow(texts)

    results = compare_embedders({"paired": (q_enc, d_enc)}, validation_csv)
    assert calls == {"q": 1, "d": 1}
    assert results[0].name == "paired"


# ------------------------------------------------------------------ train


def test_train_with_catalog_and_model_dir(tmp_path, catalog_file, model_dir, capsys,
                                          validation_csv):
    db = _copy(catalog_file, tmp_path)
    ck = tmp_path / "ck"
    argv = ["train", "--model-dir", model_dir, "--catalog", db, "--catalog-limit", "16",
            "--validation", validation_csv, "--steps", "2", "--batch-size", "8", "--seq-len", "32",
            "--checkpoint-dir", str(ck), "--device", "cpu"]
    losses = run(argv)
    out = capsys.readouterr().out
    assert len(losses) == 2 and all(np.isfinite(losses))
    with open(validation_csv, newline="") as f:
        n_val = sum(1 for _ in csv.DictReader(f))
    n_pairs = int(out.split("[train] ")[1].split()[0])
    assert n_val < n_pairs <= n_val + 16            # the catalog's pairs were added
    assert any(ck.iterdir()) and "checkpoint saved" in out
    assert run(argv) == [] and "resumed at step 2" in capsys.readouterr().out


# ------------------------------------------------------------------ serve


def test_serve_refresh_thread_end_to_end(tmp_path, catalog_file):
    """Twin of tests/test_live_refresh.py's server case: the refresh thread
    (its own sqlite connection) makes a new sloganed paper live while the
    server runs, durably (spooled), and the server's stop() ends it."""
    db = _copy(catalog_file, tmp_path)
    args = Namespace(catalog=db, spool=str(tmp_path / "spool"), model_dir=None, embedder="qwen",
                     host="127.0.0.1", port=0, no_batching=False, max_batch=16, max_wait_ms=5.0,
                     max_pending=64, warm=True, refresh_interval=0.2, quant="none", device="cpu")
    srv, sched = make_search_server(args)
    srv.start()
    cat = Catalog(db)
    try:
        base = f"http://127.0.0.1:{srv.port}"

        def corpus():
            with urllib.request.urlopen(base + "/health", timeout=30) as r:
                return json.loads(r.read())["corpus"]

        assert corpus() == 42
        _fill(cat, ["tropical geometry"], prefix="2407", start=99)
        deadline = time.time() + 30
        n = corpus()
        while n < 43 and time.time() < deadline:
            time.sleep(0.25)
            n = corpus()
        assert n == 43, "refresh thread never picked up the new doc"
        body = json.dumps({"query": "tropical geometry", "top_k": 43}).encode()
        req = urllib.request.Request(base + "/search", data=body,
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as r:
            out = json.loads(r.read())
        assert "2407.00099" in [r["paper_id"] for r in out["results"]]
    finally:
        srv.stop()
        if sched is not None:
            sched.shutdown()
    poller = [t for t in threading.enumerate() if t.name == "catalog-refresh"]
    assert not poller, "the refresh thread outlived the server"
    assert IndexBuilder(args.spool).total_rows == 43       # the refreshed vector was spooled
    cat.close()
