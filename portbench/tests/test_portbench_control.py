"""`correct` comes out false when the timed path is broken underneath:
for each fault a cell can have (an answer or a token altered where it is
produced; half of a batch left out), with the harness's look for a card
skipped and everything else a run does. At the tiny CPU sizes the limits
are the test's own, set where the sound run passes; the cells' limits
come from chip readings (PERF.md). The control at the cells' own size
runs on the card."""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from portbench import harness, spec  # noqa: E402
from portbench.tests import tiny  # noqa: E402

from theoremsearch_tpu_torch.encoder.batching import BatchedEncoder  # noqa: E402
from theoremsearch_tpu_torch.index.builder import IndexBuilder  # noqa: E402
from theoremsearch_tpu_torch.search.engine import SearchEngine  # noqa: E402

LIMITS = {
    "serve-text": {"query_cos_gap": 1e-3, "recall_miss": 0.06, "score_gap": 0.01,
                   "answer_errors": 0.0},
    "search-b1024": {"recall_miss": 0.06, "score_gap": 0.01},
    "embed-slogans": {"embed_cos_gap": 1e-3, "rows_cos_gap_bf16": 1e-3, "id_errors": 0.0},
}
SERVE = "qwen3-emb-0.6b.serve-text"
SEARCH = "qwen3-emb-0.6b.search-b1024"
EMBED = "qwen3-emb-0.6b.embed-slogans"


def _run(cell, seed=2**32 + 3):
    o = tiny.overrides(cell)
    o["limits"] = LIMITS[spec.cell_spec(cell)["traffic"]]
    return harness.run(cell, seed, 1.5, False, device="cpu", overrides=o)


def _alter_answer(monkeypatch):
    orig = SearchEngine.search_vectors_async

    def patched(self, q, k=None, filters=None, **kw):
        fin = orig(self, q, k, filters, **kw)

        def finalize():
            s, i = fin()
            i = np.array(i, copy=True)
            i[:, 0] = (i[:, 0] + 1) % self.n_valid
            return s, i
        return finalize
    monkeypatch.setattr(SearchEngine, "search_vectors_async", patched)


def _half_answers(monkeypatch):
    orig = SearchEngine.search_vectors_async

    def patched(self, q, k=None, filters=None, **kw):
        fin = orig(self, q, k, filters, **kw)

        def finalize():
            s, i = (np.array(a, copy=True) for a in fin())
            h = (len(i) + 1) // 2
            s[h:], i[h:] = s[: len(i) - h], i[: len(i) - h]
            return s, i
        return finalize
    monkeypatch.setattr(SearchEngine, "search_vectors_async", patched)


def _half_queries(monkeypatch):
    orig = BatchedEncoder.encode_device

    def patched(self, texts, role=None):
        out = orig(self, texts, role=role).clone()
        h = (len(texts) + 1) // 2
        out[h : len(texts)] = out[: len(texts) - h]
        return out
    monkeypatch.setattr(BatchedEncoder, "encode_device", patched)


def _alter_token(monkeypatch):
    orig = BatchedEncoder.encode_device

    def patched(self, texts, role=None):
        out = orig(self, texts, role=role).clone()
        out[0] = torch.roll(out[0], 1)
        return out
    monkeypatch.setattr(BatchedEncoder, "encode_device", patched)


def _alter_metadata(monkeypatch):
    orig = SearchEngine._join

    def patched(self, ids, scores):
        rows = orig(self, ids, scores)
        if rows:
            rows[-1]["paper_title"] += "x"
        return rows
    monkeypatch.setattr(SearchEngine, "_join", patched)


def _alter_row(monkeypatch):
    orig = BatchedEncoder.encode

    def patched(self, texts, role=None):
        out = orig(self, texts, role=role).copy()
        out[len(out) // 2] = np.roll(out[len(out) // 2], 1)
        return out
    monkeypatch.setattr(BatchedEncoder, "encode", patched)


def _half_page(monkeypatch):
    orig = BatchedEncoder.encode

    def patched(self, texts, role=None):
        h = (len(texts) + 1) // 2
        out = orig(self, texts[:h], role=role)
        return np.concatenate([out, out[: len(texts) - h]])
    monkeypatch.setattr(BatchedEncoder, "encode", patched)


def _lose_id(monkeypatch):
    orig = IndexBuilder.add

    def patched(self, ids, emb):
        return orig(self, ids[:-1], emb[:-1])
    monkeypatch.setattr(IndexBuilder, "add", patched)


@pytest.mark.parametrize("cell", [SERVE, SEARCH, EMBED])
def test_sound_run_is_correct(cell):
    out = _run(cell)
    assert out["correct"], out["checks"]


@pytest.mark.parametrize("cell,fault", [
    (SERVE, _alter_answer), (SERVE, _half_queries),
    (SERVE, _alter_token), (SERVE, _alter_metadata),
    (SEARCH, _alter_answer), (SEARCH, _half_answers),
    (EMBED, _alter_row), (EMBED, _half_page), (EMBED, _lose_id),
])
def test_fault_makes_the_run_incorrect(cell, fault, monkeypatch):
    fault(monkeypatch)
    out = _run(cell)
    assert not out["correct"], (fault.__name__, out["checks"])


@pytest.mark.parametrize("cell", [SERVE, SEARCH, EMBED])
def test_control_readings_are_produced(cell):
    o = tiny.overrides(cell)
    out = harness.run(cell, 17, 1.0, False, device="cpu", overrides=o, control="reference")
    assert out["notes"]["control"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", spec.benchmark()["workloads"], ids=lambda w: w["name"])
def test_control_fails_at_the_cells_size(cell):
    """The control at the cell's own size on the card: its readings break
    at least one limit (the qwen cells: the program's int8 path; the
    others: the reference put in the program's place at int8)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import theoremsearch_tpu_torch.kernels._build as build

    build.load()
    name = cell["name"]
    cs = spec.cell_spec(name)
    ctl = "int8" if cs["config"]["family"] == "qwen" and cs["traffic"] != "search-b1024" else "reference"
    out = harness.run(name, 991, 3.0, False, device="cuda", control=ctl)
    limits = cs["limits"]
    readings = dict(out["notes"]["control"])
    if ctl == "int8":
        readings.update({k: c["value"] for k, c in out["checks"].items()})
    broken = [k for k, v in readings.items() if k.removesuffix("_int8") in limits
              and v > limits[k.removesuffix("_int8")]]
    broken += [k for k in readings if k.endswith("_reference_int8")
               and readings[k] > limits.get(k.split("_reference")[0], float("inf"))]
    assert broken, readings
