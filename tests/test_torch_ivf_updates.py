"""Port parity: IVFIndex.with_updates and remap_ids (the engine's compact
and reclaim folds) against the JAX package, twins of tests/test_ivf.py's
update cases. Both packages start from one index (the reference builds
it, the port loads its saved copy: k-means differs by design), apply the
same update, and must hold the same slabs, ids, scales, spill and
rescore rows, bit for bit; then the reference test's checks run on the
port's index."""

import numpy as np
import pytest
import torch

from theoremsearch_tpu.core.config import IndexConfig as JIndexConfig
from theoremsearch_tpu.eval.oracle import l2_normalize
from theoremsearch_tpu.index.flat import FlatIndex as JFlatIndex
from theoremsearch_tpu.index.ivf import IVFIndex as JIVFIndex
from theoremsearch_tpu.search.engine import SearchEngine as JSearchEngine
from theoremsearch_tpu_torch.core.config import IndexConfig
from theoremsearch_tpu_torch.eval.metrics import recall_vs_exact
from theoremsearch_tpu_torch.eval.oracle import exact_topk
from theoremsearch_tpu_torch.index.flat import FlatIndex
from theoremsearch_tpu_torch.index.ivf import IVFIndex
from theoremsearch_tpu_torch.search.engine import SearchEngine

from torch_helpers import serialize_reference_native

torch.set_num_threads(2)
# the reference normalizes through its native library in every worker
serialize_reference_native()
CPU = "cpu"
FIELDS = ("slabs", "slab_scales", "slab_ids", "spill", "spill_scales", "spill_ids",
          "raw_flat", "res_flat", "res_scales_flat")


@pytest.fixture(scope="module")
def clustered_corpus():
    rng = np.random.default_rng(0)
    centers = rng.standard_normal((50, 64)).astype(np.float32) * 3
    pts = centers[np.repeat(np.arange(50), 80)] + rng.standard_normal((4000, 64)).astype(np.float32)
    emb = np.asarray(l2_normalize(pts))
    queries = np.asarray(l2_normalize(centers[:20] + 0.5 * rng.standard_normal((20, 64)).astype(np.float32)))
    return emb, queries


def _pair(tmp_path, emb, slab_rows=None, **cfg):
    jidx = JIVFIndex.build(emb, config=JIndexConfig(**cfg), slab_rows=slab_rows, normalize=False)
    jidx.save(tmp_path / "ivf")
    return jidx, IVFIndex.load(tmp_path / "ivf", device=CPU)


def _as_np(a):
    if a is None:
        return None
    if isinstance(a, torch.Tensor):
        return a.view(torch.int16).numpy() if a.dtype == torch.bfloat16 else a.numpy()
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def _same(jidx, tidx):
    assert tidx.num_rows == jidx.num_rows
    for name in FIELDS:
        j, t = _as_np(getattr(jidx, name)), _as_np(getattr(tidx, name))
        assert (j is None) == (t is None), name
        if j is not None:
            np.testing.assert_array_equal(t, j, err_msg=name)


@pytest.mark.parametrize("cfg", [dict(dtype="int8", ivf_assign2_margin=0.05),
                                 dict(dtype="int8", residual=True)], ids=["bf16_copy", "residual"])
def test_ivf_with_updates_append_and_remove(clustered_corpus, tmp_path, cfg):
    emb, q = clustered_corpus
    n = emb.shape[0]
    jidx, tidx = _pair(tmp_path, emb, ivf_nlist=50, **cfg)
    rng = np.random.default_rng(3)
    new = np.asarray(l2_normalize(emb[:32] + 0.1 * rng.standard_normal((32, 64)).astype(np.float32)))
    new_ids = n + np.arange(32)
    removed = np.arange(0, 200, 10)
    jidx2 = jidx.with_updates(add_emb=new, add_ids=new_ids, remove_ids=removed)
    tidx2 = tidx.with_updates(add_emb=new, add_ids=new_ids, remove_ids=removed)
    _same(jidx2, tidx2)
    _same(jidx, tidx)                       # both originals untouched
    assert tidx2.num_rows == n - removed.size + 32
    assert (tidx.slab_ids != tidx2.slab_ids).any()
    _, i = tidx2.search(new, k=1, nprobe=8)
    assert (i[:, 0] == new_ids).all(), "appended rows must be their own top-1"
    _, i = tidx2.search(q, k=10, nprobe=50)
    assert not np.isin(i, removed).any()
    live = np.ones(n + 32, bool)
    live[removed] = False
    ref = exact_topk(q, np.concatenate([emb, new])[live], k=10, device=CPU)[1]
    assert recall_vs_exact(i, np.nonzero(live)[0][np.asarray(ref)], k=10) >= 0.95


def test_ivf_with_updates_spill_growth(clustered_corpus, tmp_path):
    emb, _ = clustered_corpus
    n = emb.shape[0]
    jidx, tidx = _pair(tmp_path, emb, slab_rows=32, ivf_nlist=50, dtype="float32")
    rng = np.random.default_rng(4)
    new = np.asarray(l2_normalize(rng.standard_normal((400, 64)).astype(np.float32)))
    jidx2 = jidx.with_updates(add_emb=new, add_ids=n + np.arange(400))
    tidx2 = tidx.with_updates(add_emb=new, add_ids=n + np.arange(400))
    _same(jidx2, tidx2)
    assert len(tidx2.spill_ids) % tidx2.slabs.shape[1] == 0
    assert len(tidx2.spill_ids) > len(tidx.spill_ids)
    _, i = tidx2.search(new[:16], k=1, nprobe=50)
    assert (i[:, 0] == n + np.arange(16)).all()


def test_ivf_remap_ids(clustered_corpus, tmp_path):
    emb, q = clustered_corpus
    n = emb.shape[0]
    jidx, tidx = _pair(tmp_path, emb, ivf_nlist=50, dtype="int8")
    drop = np.zeros(n, bool)
    drop[::7] = True
    id_map = np.full(n, -1, np.int64)
    id_map[~drop] = np.arange(int((~drop).sum()))
    jidx2, tidx2 = jidx.remap_ids(id_map), tidx.remap_ids(id_map)
    _same(jidx2, tidx2)
    assert tidx2.num_rows == int((~drop).sum())
    _, i = tidx2.search(q, k=10, nprobe=50)
    ref = exact_topk(q, emb[~drop], k=10, device=CPU)[1]
    assert recall_vs_exact(i, np.asarray(ref), k=10) >= 0.95


def test_engine_ivf_route_with_live_updates(tmp_path):
    """tests/test_ivf.py's engine case: adds merge into IVF-routed queries
    and a delete keeps the IVF route (over-fetch + host drop); the port's
    ids equal the reference engine's."""
    rng = np.random.default_rng(3)
    centers = np.asarray(l2_normalize(rng.standard_normal((32, 128)).astype(np.float32)))
    pts = centers[rng.integers(0, 32, 16384)] + (0.7 / np.sqrt(128)) * rng.standard_normal(
        (16384, 128)).astype(np.float32)
    emb = np.asarray(l2_normalize(pts))
    q = np.asarray(l2_normalize(centers[rng.integers(0, 32, 16)] + (0.7 / np.sqrt(128))
                                * rng.standard_normal((16, 128)).astype(np.float32)))
    jivf, tivf = _pair(tmp_path, emb, slab_rows=768, ivf_nlist=32, dtype="int8",
                       ivf_assign2_margin=0.02)
    jeng = JSearchEngine(JFlatIndex.build(emb, config=JIndexConfig(pad_multiple=1024, dtype="float32"),
                                          normalize=False),
                         use_pallas=True, pallas_interpret=True, row_block=128, ivf_index=jivf,
                         ivf_nprobe=8, rescore_factor=8)
    teng = SearchEngine(FlatIndex.build(emb, config=IndexConfig(pad_multiple=1024, dtype="float32"),
                                        normalize=False, device=CPU),
                        row_block=128, ivf_index=tivf, ivf_nprobe=8, rescore_factor=8, device=CPU)
    new = np.asarray(l2_normalize(np.random.default_rng(9).standard_normal((4, 128)).astype(np.float32)))
    ids = teng.add_documents(new, normalize=False)
    np.testing.assert_array_equal(jeng.add_documents(new, normalize=False), ids)
    for eng_q in (new, q[:1]):
        np.testing.assert_array_equal(teng.search_vectors(eng_q, k=1)[1],
                                      jeng.search_vectors(eng_q, k=1)[1])
    np.testing.assert_array_equal(teng.search_vectors(new, k=1)[1][:, 0], ids)
    victim = int(teng.search_vectors(q[:1], k=1)[1][0, 0])
    assert teng.delete_documents([victim]) == jeng.delete_documents([victim]) == 1
    _, i1 = teng.search_vectors(q[:1], k=10)
    np.testing.assert_array_equal(i1, jeng.search_vectors(q[:1], k=10)[1])
    assert victim not in i1[0].tolist()
    np.testing.assert_array_equal(teng.search_vectors(new, k=1)[1][:, 0], ids)
    assert teng.route_counts["ivf"] >= 4 and "masked" not in teng.route_counts
    # compact and reclaim keep the route, through with_updates and remap_ids
    assert teng.compact() == jeng.compact() == 4
    assert teng.compact(reclaim=True) == jeng.compact(reclaim=True)
    _same(jeng.ivf, teng.ivf)
    np.testing.assert_array_equal(teng.search_vectors(q, k=10)[1], jeng.search_vectors(q, k=10)[1])
    np.testing.assert_array_equal(teng.search_vectors(new, k=1)[1][:, 0], teng.last_id_map[ids])
