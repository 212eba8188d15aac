"""Port parity: the residual capacity mode (2 bytes/dim) against the JAX
package: `device_rescore_residual`, FlatIndex's residual sidecars and
SearchEngine's residual route, twins of tests/test_search_engine.py's
single-device residual cases and tests/test_kernels_mips.py's capacity
pipeline. The JAX side runs its Pallas kernels in interpret mode."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from theoremsearch_tpu.core.config import IndexConfig as JIndexConfig
from theoremsearch_tpu.eval.oracle import exact_topk as j_exact_topk
from theoremsearch_tpu.index.flat import FlatIndex as JFlatIndex
from theoremsearch_tpu.index.quant import quantize_global_int8 as j_quantize_global_int8
from theoremsearch_tpu.index.quant import quantize_residual_int8 as j_quantize_residual_int8
from theoremsearch_tpu.kernels.mips import device_rescore_residual as j_device_rescore_residual
from theoremsearch_tpu.kernels.mips import fused_mips_topk_g as j_fused_mips_topk_g
from theoremsearch_tpu.search.engine import SearchEngine as JSearchEngine
from theoremsearch_tpu.search.filters import SearchFilters as JSearchFilters
from theoremsearch_tpu.search.filters import compile_filter_mask
from theoremsearch_tpu.search.metadata import CorpusMetadata as JCorpusMetadata
from theoremsearch_tpu_torch.core.config import IndexConfig
from theoremsearch_tpu_torch.eval.metrics import recall_vs_exact
from theoremsearch_tpu_torch.index.flat import FlatIndex
from theoremsearch_tpu_torch.index.quant import quantize_residual_int8
from theoremsearch_tpu_torch.kernels.mips import device_rescore_residual, fused_mips_topk_g
from theoremsearch_tpu_torch.search.engine import SearchEngine
from theoremsearch_tpu_torch.search.filters import SearchFilters
from theoremsearch_tpu_torch.search.metadata import CorpusMetadata

from torch_helpers import serialize_reference_native

torch.set_num_threads(2)
# the reference normalizes through its native library in every worker
serialize_reference_native()
GLOBAL = dict(pad_multiple=256, dtype="int8", int8_scale="global")


@pytest.fixture(scope="module")
def corpus():
    # tests/test_search_engine.py's fixture
    rng = np.random.default_rng(42)
    emb = rng.standard_normal((3000, 64)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    q = rng.standard_normal((13, 64)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    return emb, q


def _rows(n):
    return [{"paper_id": f"{2000 + i % 26}.{i:05d}", "paper_title": f"Paper {i % 50}",
             "authors": [f"Author {i % 100}"],
             "link": f"https://arxiv.org/abs/{i}" if i % 5 else f"https://stacks.math.columbia.edu/tag/{i}",
             "year": 2000 + (i % 25), "primary_category": f"math.{['AG', 'NT', 'CO', 'PR'][i % 4]}",
             "journal_ref": "J. Math" if i % 3 == 0 else None, "citations": i % 500,
             "theorem_name": "Theorem 1.", "theorem_body": f"body {i}", "slogan": f"slogan {i}"}
            for i in range(n)]


def _agree(sj, ij, st, it, tol=1e-5):
    """Scores within tol; ids equal wherever the scores are unique."""
    sj, st, ij, it = (np.asarray(a) for a in (sj, st, ij, it))
    fin = np.isfinite(sj)
    np.testing.assert_array_equal(fin, np.isfinite(st))
    np.testing.assert_allclose(st[fin], sj[fin], atol=tol)
    near = np.zeros(sj.shape, bool)
    gap = np.abs(np.diff(np.where(fin, sj, -9.0), axis=1)) <= tol
    near[:, 1:] |= gap
    near[:, :-1] |= gap
    np.testing.assert_array_equal(it[~near], ij[~near])


def _residual_engines(emb, speed=True, **kw):
    """The reference's `_residual_engine` in both packages: a global int8
    index with (res_codes, res_scales) passed explicitly."""
    jidx = JFlatIndex.build(emb, config=JIndexConfig(**GLOBAL), normalize=False)
    n = emb.shape[0]
    rc, rs = j_quantize_residual_int8(emb, np.asarray(jidx.vectors[:n]), jidx.global_scale)
    jeng = JSearchEngine(jidx, rescore_residual=(rc, rs), rescore_factor=8, row_block=128,
                         use_pallas=speed, pallas_interpret=speed, **kw)
    tidx = FlatIndex.build(emb, config=IndexConfig(**GLOBAL), normalize=False, device="cpu")
    trc, trs = quantize_residual_int8(emb, tidx.vectors[:n], tidx.global_scale)
    np.testing.assert_array_equal(trc.numpy(), rc)
    np.testing.assert_array_equal(trs.numpy(), rs)
    # a row block that is not a power-of-two multiple of 128 turns the
    # port's speed path off, as use_pallas=False does the reference's
    teng = SearchEngine(tidx, rescore_residual=(trc, trs), rescore_factor=8,
                        row_block=128 if speed else 384, device="cpu", **kw)
    return jeng, teng


def test_device_rescore_residual_matches_reference():
    """tests/test_kernels_mips.py:254's pipeline: global-int8 scan, then
    the two-level rescore; the port's rescore of the same candidates
    within 1e-5 of the reference's, ids equal where scores are unique."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((8192, 256)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    q = rng.standard_normal((16, 256)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    codes, scale = j_quantize_global_int8(x)
    rcodes, rscales = j_quantize_residual_int8(x, np.asarray(codes), scale)
    n_valid = x.shape[0] - 64
    _, i40 = j_fused_mips_topk_g(jnp.asarray(q), jnp.asarray(codes), scale, n_valid, k=40,
                                 row_block=512, interpret=True)
    js, ji = j_device_rescore_residual(jnp.asarray(q), i40, jnp.asarray(codes), scale,
                                       jnp.asarray(rcodes), jnp.asarray(rscales), n_valid, k=10)
    _, ti40 = fused_mips_topk_g(torch.from_numpy(q), torch.from_numpy(np.asarray(codes)), scale,
                                n_valid, k=40, row_block=512)
    np.testing.assert_array_equal(np.sort(ti40.numpy(), 1), np.sort(np.asarray(i40), 1))
    ts, ti = device_rescore_residual(torch.from_numpy(q), ti40, torch.from_numpy(np.asarray(codes)),
                                     scale, torch.from_numpy(rcodes), torch.from_numpy(rscales),
                                     n_valid, k=10)
    _agree(js, ji, ts.numpy(), ti.numpy())
    ri = ti.numpy()
    assert (ri >= 0).all() and (ri < n_valid).all()
    expected = np.take_along_axis(q @ x.T, ri, 1)
    np.testing.assert_allclose(ts.numpy(), expected, atol=5e-4)
    ref = np.argsort(-(q @ x[:n_valid].T), axis=1)[:, :10]
    assert (ri[:, :, None] == ref[:, None, :]).any(1).mean() >= 0.99


def test_engine_residual_capacity_mode(corpus):
    emb, q = corpus
    jeng, teng = _residual_engines(emb)
    assert teng._speed_ok and teng.rescore_residual is not None
    js, ji = jeng.search_vectors(q, k=10)
    ts, ti = teng.search_vectors(q, k=10)
    _agree(js, ji, ts, ti)
    _, ref = j_exact_topk(q, emb, k=10)
    assert recall_vs_exact(ti, np.asarray(ref), k=10) >= 0.99
    np.testing.assert_allclose(ts, np.take_along_axis(q @ emb.T, ti, axis=1), atol=5e-4)


def test_engine_residual_filtered(corpus):
    emb, q = corpus
    jeng, teng = _residual_engines(emb)
    rows = _rows(emb.shape[0])
    jeng.meta = JCorpusMetadata.from_rows(rows)
    teng.meta = CorpusMetadata.from_rows(rows)
    jf = JSearchFilters(sources=["arXiv"], year_range=(2010, 2024))
    tf = SearchFilters(sources=["arXiv"], year_range=(2010, 2024))
    js, ji = jeng.search_vectors(q[:8], k=10, filters=jf)
    ts, ti = teng.search_vectors(q[:8], k=10, filters=tf)
    _agree(js, ji, ts, ti)
    mask = compile_filter_mask(jf, jeng.meta)
    assert mask[ti[ti >= 0]].all()
    valid = ti >= 0
    exp = np.take_along_axis(q[:8] @ emb.T, np.clip(ti, 0, None), axis=1)
    np.testing.assert_allclose(ts[valid], exp[valid], atol=5e-4)


def test_engine_residual_host_fallback(corpus):
    """The speed path off: the exact route rescores on the host from the
    two-level reconstruction."""
    emb, q = corpus
    jeng, teng = _residual_engines(emb, speed=False)
    assert not teng._speed_ok and teng._res_codes_device is None
    js, ji = jeng.search_vectors(q, k=10)
    ts, ti = teng.search_vectors(q, k=10)
    _agree(js, ji, ts, ti)
    _, ref = j_exact_topk(q, emb, k=10)
    assert recall_vs_exact(ti, np.asarray(ref), k=10) >= 0.99
    np.testing.assert_allclose(ts, np.take_along_axis(q @ emb.T, ti, axis=1), atol=5e-4)


def test_engine_residual_validation(corpus):
    emb, _ = corpus
    idx8 = FlatIndex.build(emb, config=IndexConfig(**GLOBAL), normalize=False, device="cpu")
    n = emb.shape[0]
    rc = np.zeros((n, emb.shape[1]), np.int8)
    rs = np.zeros((n,), np.float32)
    with pytest.raises(ValueError, match="not both"):
        SearchEngine(idx8, rescore_vectors=emb, rescore_residual=(rc, rs), device="cpu")
    with pytest.raises(ValueError, match="int8"):
        SearchEngine(idx8, rescore_residual=(rc.astype(np.int16), rs), device="cpu")
    idx_f = FlatIndex.build(emb, config=IndexConfig(pad_multiple=256), normalize=False, device="cpu")
    with pytest.raises(ValueError, match="global-scale"):
        SearchEngine(idx_f, rescore_residual=(rc, rs), device="cpu")
    idx_c = FlatIndex.build(emb, ids=np.arange(n) + 5, config=IndexConfig(**GLOBAL),
                            normalize=False, device="cpu")
    with pytest.raises(ValueError, match="row-order"):
        SearchEngine(idx_c, rescore_residual=(rc, rs), device="cpu")


def test_flat_index_residual_build_save_load_autoadopt(corpus, tmp_path):
    """config.residual packs the two-level data into the index, bit-equal
    to the reference's; it survives save/load and the engine adopts it."""
    emb, q = corpus
    cfg = dict(GLOBAL, residual=True)
    tidx = FlatIndex.build(emb, config=IndexConfig(**cfg), normalize=False, device="cpu")
    jidx = JFlatIndex.build(emb, config=JIndexConfig(**cfg), normalize=False)
    assert tidx.rescore_residual is not None
    np.testing.assert_array_equal(tidx.rescore_residual[0].numpy(), jidx.rescore_residual[0])
    np.testing.assert_array_equal(tidx.rescore_residual[1].numpy(), jidx.rescore_residual[1])
    tidx.save(tmp_path / "flat_resid")
    idx2 = FlatIndex.load(tmp_path / "flat_resid")
    assert idx2.global_scale == tidx.global_scale
    for a, b in zip(idx2.rescore_residual, tidx.rescore_residual):
        assert torch.equal(a, b)
    eng = SearchEngine(idx2, row_block=128, device="cpu")
    assert eng.rescore_residual is not None and eng._speed_ok
    jeng = JSearchEngine(jidx, use_pallas=True, pallas_interpret=True, row_block=128)
    js, ji = jeng.search_vectors(q, k=10)
    ts, ti = eng.search_vectors(q, k=10)
    _agree(js, ji, ts, ti)
    _, ref = j_exact_topk(q, emb, k=10)
    assert recall_vs_exact(ti, np.asarray(ref), k=10) >= 0.99


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_residual_index_files_load_in_the_other_package(corpus, tmp_path, writer):
    """shard_0000.rescodes.npy / resscales.npy written by one package load
    in the other, bit for bit; a re-save without them clears them."""
    emb, _ = corpus
    cfg = dict(GLOBAL, residual=True)
    path = tmp_path / "idx"
    if writer == "jax":
        src = JFlatIndex.build(emb, config=JIndexConfig(**cfg), normalize=False)
        src.save(path)
        got = FlatIndex.load(path)
        want = [np.asarray(a) for a in src.rescore_residual]
        got_arrays = [a.numpy() for a in got.rescore_residual]
        np.testing.assert_array_equal(got.vectors.numpy(), np.asarray(src.vectors))
    else:
        src = FlatIndex.build(emb, config=IndexConfig(**cfg), normalize=False, device="cpu")
        src.save(path)
        got = JFlatIndex.load(path)
        want = [a.numpy() for a in src.rescore_residual]
        got_arrays = [np.asarray(a) for a in got.rescore_residual]
        np.testing.assert_array_equal(np.asarray(got.vectors), src.vectors.numpy())
    for g, w in zip(got_arrays, want):
        np.testing.assert_array_equal(g, w)
    FlatIndex.build(emb, config=IndexConfig(**GLOBAL), normalize=False, device="cpu").save(path)
    assert not (path / "shard_0000.rescodes.npy").exists()
    assert JFlatIndex.load(path).rescore_residual is None


def test_flat_index_residual_requires_global():
    emb = np.eye(8, 64, dtype=np.float32)
    with pytest.raises(ValueError, match="residual"):
        FlatIndex.build(emb, config=IndexConfig(pad_multiple=8, dtype="bfloat16", residual=True),
                        device="cpu")
    with pytest.raises(ValueError, match="residual"):
        FlatIndex.build(emb, config=IndexConfig(pad_multiple=8, dtype="int8", residual=True),
                        device="cpu")


def test_engine_autoadopt_skips_non_arange_ids(corpus):
    emb, q = corpus
    ids = np.arange(emb.shape[0], dtype=np.int64) * 3 + 7
    idx = FlatIndex.build(emb, ids=ids, config=IndexConfig(**GLOBAL, residual=True),
                          normalize=False, device="cpu")
    with pytest.warns(UserWarning, match="row-order"):
        eng = SearchEngine(idx, row_block=128, device="cpu")
    assert eng.rescore_residual is None
    _, i = eng.search_vectors(q, k=5)
    _, ref = j_exact_topk(q, emb, k=5)
    overlap = np.mean([len(set(i[r].tolist()) & set(ids[np.asarray(ref)[r]].tolist())) / 5
                       for r in range(len(q))])
    assert overlap >= 0.9
