"""The port's command line (theoremsearch_tpu_torch/cli.py) on the CPU:
the reference's fourteen subcommands and their flags; every device
subcommand through `run([...])` with `--device cpu`, on a catalog filled
as the JAX tests fill theirs and a synthetic qwen checkpoint
(`--model-dir`), held to the JAX package's CLI on the same inputs where
both compute the same thing; the seven host subcommands through both
CLIs, from a source bundle and a fake arXiv listing to equal catalogs,
and on to the same search ids; the serving stack with a
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


def _flags(parser) -> dict:
    """A subparser's arguments: dest -> (option strings, default, choices,
    nargs, type, required)."""
    return {a.dest: (a.option_strings, a.default, a.choices, a.nargs, a.type, a.required)
            for a in parser._actions if a.dest != "help"}


def test_help_lists_the_device_subcommands():
    """`--help` lists the reference's fourteen subcommands, in its order;
    each takes the reference's flags with its defaults, plus `--device` on
    the seven device subcommands and on no host subcommand, and
    `--embedder` takes the port's own deepseek tower beside the
    reference's families."""
    from theoremsearch_tpu.cli import build_parser as jax_build_parser

    res = subprocess.run([sys.executable, "-m", "theoremsearch_tpu_torch", "--help"], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]
    ref = jax_build_parser()._subparsers._group_actions[0].choices
    sub = build_parser()._subparsers._group_actions[0].choices
    assert list(sub) == list(ref) and len(sub) == 14
    assert sorted(DEVICE_CMDS + HOST_ONLY) == sorted(sub)
    for cmd, parser in sub.items():
        assert cmd in res.stdout
        mine = _flags(parser)
        if cmd in DEVICE_CMDS:
            assert mine.pop("device")[0] == ["--device"], cmd
        else:
            assert "device" not in mine and "--device" not in parser.format_help(), cmd
        theirs = _flags(ref[cmd])
        if "embedder" in theirs:
            opts, ref_opts = mine.pop("embedder"), theirs.pop("embedder")
            assert opts[2] == [*ref_opts[2], "deepseek"], cmd
            assert opts[:2] + opts[3:] == ref_opts[:2] + ref_opts[3:], cmd
        assert mine == theirs, cmd


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


# ------------------------------------------- the host subcommands, twinned


def _printed_hits(lines):
    """(score, "name — title") of each hit line search printed."""
    return [(float(ln[1:7]), ln.split("] ", 1)[1]) for ln in lines if ln.startswith("[")]


def test_host_subcommands_twin_sources_to_ids(tmp_path, monkeypatch, capsys, model_dir):
    """ingest-arxiv (a fake listing in place of the arXiv client),
    locate-s3 (a local bundle in place of S3), parse, ingest-tex, stacks,
    slogans (16 workers, a JSONL trace) and quality through both CLIs
    on copies of one catalog: equal paper, theorem, slogan, parse_status
    and location tables and equal printed lines. Then embed and search on
    each package's own catalog with the same checkpoint: the same ids
    wherever the printed scores are unique, from sources to ids."""
    import importlib

    from chip_smoke import bundle_tar, front_words, stacks_json, synthetic_paper, synthetic_week

    # gzip payloads only: the locator skips the rest, and parse's fallback
    # for an unlocated paper is arxiv.org
    papers = [p for p in synthetic_week(24, seed=3, n_thm=5) if p["kind"] in ("gz", "tar")]
    bundle = tmp_path / "arXiv_src_2401_001.tar"
    bundle.write_bytes(bundle_tar(papers))
    cats = sorted({p["meta"]["primary_category"] for p in papers})
    words = front_words(seed=3)
    tags = stacks_json(str(tmp_path / "stacks"), 30, words)
    rng = np.random.default_rng(5)
    tex_files = []
    for k in range(3):
        files, _ = synthetic_paper(rng, f"note{k}", words, 6)
        tex_files.append(str(tmp_path / f"note{k}.tex"))
        Path(tex_files[-1]).write_text(files["main.tex"])
    monkeypatch.setitem(sys.modules, "requests", None)    # no network fallback, ever
    monkeypatch.setitem(sys.modules, "boto3", None)

    def ranged(key, start, end):
        with open(bundle, "rb") as f:
            f.seek(start)
            return f.read(end - start + 1)

    for pkg in ("theoremsearch_tpu", "theoremsearch_tpu_torch"):
        api = importlib.import_module(f"{pkg}.ingest.arxiv_api")
        src = importlib.import_module(f"{pkg}.ingest.sources")

        def listing(query, date_partition="month", api=api, **kw):
            assert query.startswith("cat:") and date_partition == "week"
            return iter([api.ArxivPaper(**p["meta"]) for p in papers
                         if p["meta"]["primary_category"] == query[4:]])

        monkeypatch.setattr(api, "iter_arxiv_papers", listing)
        monkeypatch.setattr(src, "s3_bundle_iterator",
                            lambda bundle_start=0: iter([(bundle.name, open(bundle, "rb"))][bundle_start:]))
        monkeypatch.setattr(src, "default_ranged_get", ranged)

    empty = tmp_path / "empty.db"
    Catalog(str(empty)).close()
    dbs = {"jax": _copy(empty, tmp_path / "jax"), "torch": _copy(empty, tmp_path / "torch")}
    steps = [["ingest-arxiv", "--categories", *cats, "--date-partition", "week"],
             ["locate-s3", "--bundle-start", "0"], ["parse", "--timeout", "30"],
             ["ingest-tex", *tex_files, "--authors", "A. Uthor", "B. Author"],
             ["stacks", "--parsed", str(Path(tags).parent), "--tags", tags],
             ["slogans", "--model", "offline-stub", "--workers", "16", "--trace", "TRACE"],
             ["quality", "--sample", "20"]]
    printed, results = {"jax": [], "torch": []}, []
    capsys.readouterr()
    for argv in steps:
        for name, fn in (("jax", jax_main), ("torch", run)):
            trace = str(tmp_path / name / "trace.jsonl")
            out = fn(["--catalog", dbs[name]] + [trace if a == "TRACE" else a for a in argv])
            printed[name].append(capsys.readouterr().out.splitlines())
            if name == "torch":
                results.append(out)
    assert printed["torch"] == printed["jax"]
    n_up, located, stats, n_tex, n_stacks, cost, report = results
    n_thm = sum(len(p["theorems"]) for p in papers)
    assert n_up == len(papers) and located == [(bundle.name, len(papers))]
    assert (stats.parsed, stats.failed, stats.timeouts, stats.theorems) == (len(papers), 0, 0, n_thm)
    assert n_stacks == 30 and n_tex == 3 * 6 and report.ratings == []
    cat_j, cat_p = JCatalog(dbs["jax"]), Catalog(dbs["torch"])
    for table, sql in (("paper", "SELECT * FROM paper"),
                       ("theorem", "SELECT * FROM theorem"),
                       ("theorem_slogan", "SELECT * FROM theorem_slogan"),
                       ("parse_status", "SELECT paper_id, status, theorems FROM parse_status"),
                       ("paper_arxiv_s3_location", "SELECT * FROM paper_arxiv_s3_location")):
        rows = [sorted(map(tuple, c.conn.execute(sql))) for c in (cat_j, cat_p)]
        assert rows[0] == rows[1], table
    n_all = cat_p.count("theorem")
    assert n_all == n_thm + 30 + 18 == cost.calls == cat_p.count("theorem_slogan")
    got = {(r[0], r[1], r[2]) for r in cat_p.conn.execute(
        "SELECT paper_id, name, label FROM theorem WHERE paper_id NOT LIKE 'stacks-%' "
        "AND paper_id NOT LIKE 'local-%'")}
    assert got == {(p["paper_id"], n, lbl) for p in papers for n, lbl in p["theorems"]}
    traces = [len((tmp_path / name / "trace.jsonl").read_text().splitlines()) for name in dbs]
    assert traces == [n_all, n_all]

    # sources -> ids: embed and search on each package's own catalog
    query = cat_p.conn.execute("SELECT slogan FROM theorem_slogan ORDER BY slogan_id "
                               "LIMIT 1 OFFSET 17").fetchone()[0]
    cat_j.close()
    cat_p.close()
    common = ["embed", "--model-dir", model_dir, "--index-dtype", "int8-global-residual"]
    jax_main(["--catalog", dbs["jax"]] + common + ["--spool", str(tmp_path / "jax" / "spool")])
    assert run(["--catalog", dbs["torch"]] + common +
               ["--spool", str(tmp_path / "torch" / "spool"), "--device", "cpu"]) == n_all
    capsys.readouterr()
    search = ["search", query, "--model-dir", model_dir, "--top-k", "10"]
    jax_main(["--catalog", dbs["jax"]] + search + ["--spool", str(tmp_path / "jax" / "spool")])
    want = _printed_hits(capsys.readouterr().out.splitlines())
    engine = run(["--catalog", dbs["torch"]] + search +
                 ["--spool", str(tmp_path / "torch" / "spool"), "--device", "cpu"])
    hits = _printed_hits(capsys.readouterr().out.splitlines())
    assert engine.route_counts == {"speed": 1} and engine.n_valid == n_all
    assert len(hits) == len(want) == 10
    # bf16 forwards of the two packages agree at cosine > 0.999, so a
    # printed score moves by a few 1e-3: a hit may trade places only with
    # one the reference scored within 5e-3 of its rank
    want_at = {hit: s for s, hit in want}
    assert len(want_at) == 10
    for r, ((s, hit), (ws, whit)) in enumerate(zip(hits, want)):
        assert abs(s - ws) <= 5e-3, (r, hits, want)
        if hit != whit:
            assert (hit in want_at and abs(want_at[hit] - ws) <= 5e-3) or r == 9, (r, hits, want)
