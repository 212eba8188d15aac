"""Port parity: the row-sharded flat engine (`SearchEngine(mesh=)`) and
`core/meshes.py` against the JAX package on its 8-device CPU mesh
(tests/conftest.py), twins of the mesh cases of tests/test_search_engine.py.

The port's mesh is a grid of repeated "cpu" devices of the same shape
(`torch_helpers.cpu_mesh`). Both packages get the same numpy inputs;
the JAX engines run their Pallas kernels in interpret mode where the
reference tests do. Ids must be equal wherever the scores are unique
(a neighbouring score further than 1e-5) and scores within 1e-5
(`test_torch_live_updates._agree`); the approximate routes also keep the
reference tests' own gates."""

import numpy as np
import pytest
import torch

from theoremsearch_tpu.core import MeshConfig as JMeshConfig
from theoremsearch_tpu.core import make_mesh as j_make_mesh
from theoremsearch_tpu.core.config import IndexConfig as JIndexConfig
from theoremsearch_tpu.index.flat import FlatIndex as JFlatIndex
from theoremsearch_tpu.index.quant import quantize_residual_int8 as j_quant_residual
from theoremsearch_tpu.kernels.mips import fused_mips_topk_g as j_fused_g
from theoremsearch_tpu.search.engine import SearchEngine as JSearchEngine
from theoremsearch_tpu.search.filters import SearchFilters as JSearchFilters
from theoremsearch_tpu.search.metadata import CorpusMetadata as JCorpusMetadata
from theoremsearch_tpu_torch.core import Mesh, make_mesh, shard_axis_size
from theoremsearch_tpu_torch.core.config import IndexConfig, MeshConfig
from theoremsearch_tpu_torch.eval.metrics import recall_vs_exact
from theoremsearch_tpu_torch.eval.oracle import exact_topk
from theoremsearch_tpu_torch.index.flat import FlatIndex
from theoremsearch_tpu_torch.index.quant import quantize_residual_int8
from theoremsearch_tpu_torch.kernels.mips import (
    auto_merge_tiles, fused_mips_topk_g, mips_g_scan, quantize_queries,
)
from theoremsearch_tpu_torch.search.engine import SearchEngine
from theoremsearch_tpu_torch.search.filters import SearchFilters, compile_filter_mask
from theoremsearch_tpu_torch.search.metadata import CorpusMetadata

from test_torch_live_updates import _agree
from test_torch_mips import _assert_same_selection, _numpy_packed
from torch_helpers import cpu_mesh, serialize_reference_native

torch.set_num_threads(2)
# the reference normalizes through its native library in every worker
serialize_reference_native()

GLOBAL = dict(pad_multiple=256, dtype="int8", int8_scale="global")


@pytest.fixture(scope="module")
def corpus():
    rng = np.random.default_rng(42)
    emb = rng.standard_normal((3000, 64)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    q = rng.standard_normal((13, 64)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    return emb, q


@pytest.fixture(scope="module")
def rows(corpus):
    rng = np.random.default_rng(7)
    out = []
    for i in range(corpus[0].shape[0]):
        is_arx = i % 5 != 0
        out.append({
            "paper_id": f"{2000 + i % 26}.{i:05d}", "paper_title": f"Paper about topic {i % 50}",
            "authors": [f"Author {i % 100}", f"Author {(i * 7) % 100}"],
            "link": f"https://arxiv.org/abs/{i}" if is_arx else f"https://stacks.math.columbia.edu/tag/{i}",
            "year": 2000 + (i % 25), "primary_category": f"math.{['AG', 'NT', 'CO', 'PR'][i % 4]}",
            "journal_ref": "J. Math" if i % 3 == 0 else None,
            "citations": int(rng.integers(0, 500)) if i % 4 != 0 else None,
            "theorem_name": ["Theorem 1.", "Lemma 2.", "Proposition 3.", "Corollary 4."][i % 4],
            "theorem_body": f"body {i}", "slogan": f"slogan {i}",
        })
    return out


def _pair(emb, cfg: dict, shards: int | None, rows=None, pallas=True, residual=False, **kw):
    """(JAX engine, port engine) over the same corpus, on meshes of
    `shards` shards (None: one device)."""
    jidx = JFlatIndex.build(emb, config=JIndexConfig(**cfg), normalize=False)
    tidx = FlatIndex.build(emb, config=IndexConfig(**cfg), normalize=False, device="cpu")
    jkw, tkw = dict(kw), dict(kw)
    if residual:
        n = emb.shape[0]
        jkw["rescore_residual"] = j_quant_residual(emb, np.asarray(jidx.vectors[:n]), jidx.global_scale)
        tkw["rescore_residual"] = quantize_residual_int8(torch.from_numpy(emb), tidx.vectors[:n],
                                                         tidx.global_scale)
    jm = j_make_mesh(JMeshConfig(data=1, shard=shards)) if shards else None
    tm = cpu_mesh(shards) if shards else None
    jeng = JSearchEngine(jidx, meta=JCorpusMetadata.from_rows(rows) if rows else None, mesh=jm,
                         use_pallas=pallas, pallas_interpret=pallas, row_block=128, **jkw)
    teng = SearchEngine(tidx, meta=CorpusMetadata.from_rows(rows) if rows else None, mesh=tm,
                        device=None if tm is not None else "cpu", row_block=128, **tkw)
    return jeng, teng


def _overlap(a, b):
    return float(np.mean([len(set(x.tolist()) & set(y.tolist())) / a.shape[1] for x, y in zip(a, b)]))


# ---------------------------------------------------------------- meshes


def test_make_mesh_layout_and_repeats():
    m = make_mesh(MeshConfig(data=2, shard=4), devices=["cpu"] * 8)
    assert isinstance(m, Mesh) and m.shape == {"data": 2, "shard": 4}
    assert m.axis_names == ("data", "shard") and shard_axis_size(m) == 4
    assert m.devices.shape == (2, 4) and m.first_device == torch.device("cpu")
    assert len(m.shard_devices) == 4 and len(m.data_devices) == 2
    # no config: every device on the shard axis
    assert make_mesh(devices=["cpu"] * 3).shape == {"data": 1, "shard": 3}


@pytest.mark.parametrize("cfg, n, match", [
    (MeshConfig(data=2, shard=4), 7, "needs 8 devices, have 7"),
    (MeshConfig(data=0, shard=4), 8, "positive"),
])
def test_make_mesh_errors(cfg, n, match):
    with pytest.raises(ValueError, match=match):
        make_mesh(cfg, devices=["cpu"] * n)


def test_make_mesh_default_devices_need_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_mesh(MeshConfig(shard=2))


def test_engine_device_must_match_the_mesh(corpus):
    emb, _ = corpus
    idx = FlatIndex.build(emb, config=IndexConfig(pad_multiple=256), normalize=False, device="cpu")
    with pytest.raises(ValueError, match="disagrees"):
        SearchEngine(idx, mesh=cpu_mesh(2), device="meta")


# ------------------------------------------------- the sharded engine


def test_shard_layout_matches_reference(corpus):
    """rows_per_shard, padding and each shard's valid row count
    (`local_valid`) as the reference lays them out."""
    emb, _ = corpus
    jeng, teng = _pair(emb[:2900], dict(pad_multiple=256, dtype="float32"), 8, pallas=False)
    assert (teng.padded_rows, teng.rows_per_shard, teng.n_shards) == \
        (jeng.padded_rows, jeng.rows_per_shard, jeng.n_shards)
    valid = [int(np.clip(2900 - s * jeng.rows_per_shard, 0, jeng.rows_per_shard)) for s in range(8)]
    assert [sh["valid"] for sh in teng._shards] == valid
    assert valid[-1] < teng.rows_per_shard


@pytest.mark.parametrize("shards", [2, 8])
def test_sharded_matches_single(corpus, shards):
    """The exact route once a shard (f32) == the JAX mesh engine, the
    port's single-device engine and the oracle."""
    emb, q = corpus
    jeng, teng = _pair(emb, dict(pad_multiple=256, dtype="float32"), shards, pallas=False)
    _, t1 = _pair(emb, dict(pad_multiple=256, dtype="float32"), None, pallas=False)
    js, ji = jeng.search_vectors(q, k=10)
    ts, ti = teng.search_vectors(q, k=10)
    _agree(js, ji, ts, ti, "mesh vs JAX mesh")
    s1, i1 = t1.search_vectors(q, k=10)
    np.testing.assert_array_equal(ti, i1)
    np.testing.assert_allclose(ts, s1, atol=1e-5)
    np.testing.assert_array_equal(ti, exact_topk(q, emb, k=10, device="cpu")[1])


def test_sharded_pallas_matches_single(corpus):
    """The reference's production kernel under shard_map (interpret) vs
    the port's B5 a shard: equal ids, and both equal the oracle."""
    emb, q = corpus
    jeng, teng = _pair(emb, dict(pad_multiple=256, dtype="float32"), 8)
    js, ji = jeng.search_vectors(q, k=10)
    ts, ti = teng.search_vectors(q, k=10)
    _agree(js, ji, ts, ti, "pallas mesh")
    np.testing.assert_array_equal(ti, exact_topk(q, emb, k=10, device="cpu")[1])


def test_sharded_int8_recall(corpus):
    """Raw per-row int8 a shard (no rescore), k=20: the JAX mesh engine's
    ids, and the reference's 0.95 top-10-in-top-20 bound."""
    emb, q = corpus
    jeng, teng = _pair(emb, dict(pad_multiple=256, dtype="int8"), 4, pallas=False)
    js, ji = jeng.search_vectors(q, k=20)
    ts, ti = teng.search_vectors(q, k=20)
    _agree(js, ji, ts, ti, "int8 mesh")
    ref = exact_topk(q, emb, k=10, device="cpu")[1]
    assert np.mean([len(set(ti[r]) & set(ref[r])) / 10 for r in range(len(q))]) >= 0.95


def test_sharded_int8_rescored_hits_gate(corpus):
    """Per-row int8 a shard + the host rescore at rescore_factor 8: the
    JAX mesh engine's ids and the 0.99 gate."""
    emb, q = corpus
    jeng, teng = _pair(emb, dict(pad_multiple=256, dtype="int8"), 4, pallas=False,
                       rescore_vectors=emb, rescore_factor=8)
    js, ji = jeng.search_vectors(q, k=10)
    ts, ti = teng.search_vectors(q, k=10)
    _agree(js, ji, ts, ti, "int8 rescored mesh")
    assert recall_vs_exact(ti, exact_topk(q, emb, k=10, device="cpu")[1], k=10) >= 0.99


def test_sharded_int8_with_filter(corpus, rows):
    """Per-row int8 + a filter bias, sharded 8 ways: B5's bias form a
    shard against the JAX mesh engine's production kernel."""
    emb, q = corpus
    jeng, teng = _pair(emb, dict(pad_multiple=256, dtype="int8"), 8, rows=rows)
    jf = JSearchFilters(sources=["arXiv"], year_range=(2010, 2024))
    tf = SearchFilters(sources=["arXiv"], year_range=(2010, 2024))
    js, ji = jeng.search_vectors(q[:4], k=10, filters=jf)
    ts, ti = teng.search_vectors(q[:4], k=10, filters=tf)
    _agree(js, ji, ts, ti, "filtered int8 mesh")
    mask = compile_filter_mask(tf, teng.meta)
    assert all(mask[d] for d in ti.ravel() if d >= 0)


def test_b1_candidates_bit_equal_a_shard(corpus):
    """B1 on each shard's rows with the shard's valid count: the packed
    candidates bit-equal the numpy packing of the same shard, and the
    selection (scores, rows) that of the JAX kernel (interpret) on it."""
    emb, q = corpus
    jeng, teng = _pair(emb[:2900], GLOBAL, 4, rescore_vectors=emb[:2900], rescore_factor=8)
    vecs = np.asarray(jeng.vectors)
    q8, _ = quantize_queries(torch.from_numpy(q))
    rps, rb = teng.rows_per_shard, teng.row_block
    m = auto_merge_tiles(emb.shape[1], rb // 128, rps // rb)
    for s, sh in enumerate(teng._shards):
        shard_codes = vecs[sh["lo"] : sh["lo"] + rps]
        np.testing.assert_array_equal(sh["vectors"].numpy(), shard_codes)
        cand = mips_g_scan(q8, sh["vectors"], sh["valid"], rb, m)
        np.testing.assert_array_equal(cand.numpy(), _numpy_packed(q, shard_codes, sh["valid"], rb, m),
                                      err_msg=f"shard {s}")
        ts, ti = fused_mips_topk_g(torch.from_numpy(q), sh["vectors"], teng._global_scale, sh["valid"],
                                   k=40, row_block=rb)
        js, ji = j_fused_g(q, shard_codes, jeng._global_scale, sh["valid"], k=40, row_block=rb,
                           interpret=True)
        _assert_same_selection(js, ji, ts, ti)


@pytest.mark.parametrize("residual", [False, True])
def test_sharded_speed_path(corpus, residual):
    """The speed path a shard (B1 scan, local rescore against the bf16
    copy or the two-level codes, merge): the JAX mesh engine's ids; the
    0.99 gate; overlap with the single-device engine >= 0.99 and scores
    within 5e-3 (the reference's bar); the residual form equals its
    single-device run outright (`test_engine_residual_sharded`)."""
    emb, q = corpus
    kw = dict(residual=True, rescore_factor=8) if residual else dict(rescore_vectors=emb, rescore_factor=8)
    jeng, teng = _pair(emb, GLOBAL, 4, **kw)
    assert jeng._sharded_speed_ok and teng._speed_ok
    js, ji = jeng.search_vectors(q, k=10)
    ts, ti = teng.search_vectors(q, k=10)
    _agree(js, ji, ts, ti, "speed path mesh")
    assert recall_vs_exact(ti, exact_topk(q, emb, k=10, device="cpu")[1], k=10) >= 0.99
    _, t1 = _pair(emb, GLOBAL, None, **kw)
    s1, i1 = t1.search_vectors(q, k=10)
    assert _overlap(ti, i1) >= 0.99
    np.testing.assert_allclose(ts, s1, atol=5e-3)
    if residual:
        np.testing.assert_array_equal(ti, i1)
        np.testing.assert_allclose(ts, s1, atol=1e-5)
    sa, ia = teng.search_vectors_async(q, k=10)()
    np.testing.assert_array_equal(ia, ti)


def test_sharded_speed_path_filtered(corpus, rows):
    """A narrow filter on the sharded speed path: the masked B1 form a
    shard, the mask row-sharded; the JAX mesh engine's ids, every id
    passing, overlap >= 0.9 with the single-device filtered engine."""
    emb, q = corpus
    jeng, teng = _pair(emb, GLOBAL, 4, rows=rows, rescore_vectors=emb, rescore_factor=8)
    jf = JSearchFilters(sources=["arXiv"], year_range=(2010, 2016))
    tf = SearchFilters(sources=["arXiv"], year_range=(2010, 2016))
    js, ji = jeng.search_vectors(q[:8], k=10, filters=jf)
    ts, ti = teng.search_vectors(q[:8], k=10, filters=tf)
    _agree(js, ji, ts, ti, "filtered speed mesh")
    assert teng.route_counts == {"masked": 1}
    mask = compile_filter_mask(tf, teng.meta)
    assert all(mask[d] for d in ti.ravel() if d >= 0)
    _, t1 = _pair(emb, GLOBAL, None, rows=rows, rescore_vectors=emb, rescore_factor=8)
    s1, i1 = t1.search_vectors(q[:8], k=10, filters=tf)
    assert _overlap(ti, i1) >= 0.9
    np.testing.assert_allclose(ts, s1, atol=5e-3)


def _grouped_filters(pkg_filters, n):
    out = []
    for i in range(n):
        if i % 4 == 0:
            out.append(None)
        elif i % 4 == 1:
            lo = 2000 + (i % 5) * 4
            out.append(pkg_filters(year_range=(lo, lo + 4)))
        elif i % 4 == 2:
            out.append(pkg_filters(sources=["Stacks Project"]))
        else:
            out.append(pkg_filters(tags=[f"math.{['AG', 'NT'][i % 2]}"]))
    return out


@pytest.mark.parametrize("speed", [True, False])
def test_grouped_filters_sharded(corpus, rows, speed):
    """A heterogeneous filtered batch over the mesh: one grouped scan
    with the (G, rows) stack sharded on its row axis (speed path), or a
    dispatch a signature (the exact route, where the reference runs its
    grouped XLA scan): the JAX mesh engine's ids, and each query's ids
    those of its own single-signature dispatch."""
    emb, q = corpus
    if speed:
        jeng, teng = _pair(emb, GLOBAL, 4, rows=rows, rescore_vectors=emb, rescore_factor=8)
    else:
        jeng, teng = _pair(emb, dict(pad_multiple=256, dtype="float32"), 8, rows=rows, pallas=False)
    jfl, tfl = _grouped_filters(JSearchFilters, len(q)), _grouped_filters(SearchFilters, len(q))
    js, ji = jeng.search_vectors(q, k=8, filters=jfl)
    ts, ti = teng.search_vectors(q, k=8, filters=tfl)
    _agree(js, ji, ts, ti, "grouped mesh")
    assert teng.route_counts.get("grouped", 0) == (1 if speed else 0)
    for b in range(len(q)):
        _, i1 = teng.search_vectors(q[b : b + 1], k=8, filters=tfl[b])
        assert set(ti[b].tolist()) == set(i1[0].tolist()), b
