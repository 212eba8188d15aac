"""Port parity: the IVF index (theoremsearch_tpu_torch/index/ivf.py and
index/builder.py) against the JAX reference, on the CPU, mirroring the
single-device cases of tests/test_ivf.py on the same fixtures.

k-means differs by design in two ways, both bounded here: k-means++
draws its D^2 seeds from a torch.Generator (the reference from
jax.random), and the centroid sums run in another order. With
init="random" both packages start from the same numpy-drawn rows, so
their centroids are compared directly. Given the same centroids, the
packing is exact host numpy and must match the reference array for
array. Searches of one index (built by the reference, loaded by the
port) return equal ids."""

import warnings

import numpy as np
import pytest
import torch

from theoremsearch_tpu.core import IndexConfig as JIndexConfig
from theoremsearch_tpu.eval.oracle import l2_normalize
from theoremsearch_tpu.index.builder import IndexBuilder as JIndexBuilder
from theoremsearch_tpu.index.ivf import IVFIndex as JIVFIndex
from theoremsearch_tpu.index.ivf import calibrate_nprobe as j_calibrate
from theoremsearch_tpu.index.ivf import train_kmeans as j_train_kmeans
from theoremsearch_tpu_torch.core.config import IndexConfig
from theoremsearch_tpu_torch.eval.metrics import recall_vs_exact
from theoremsearch_tpu_torch.eval.oracle import exact_topk
from theoremsearch_tpu_torch.index import ivf as ivf_mod
from theoremsearch_tpu_torch.index.builder import IndexBuilder
from theoremsearch_tpu_torch.index.ivf import IVFIndex, calibrate_nprobe, train_kmeans

torch.set_num_threads(2)
CPU = "cpu"


@pytest.fixture(scope="module")
def clustered_corpus():
    # tests/test_ivf.py's fixture: 50 centers, 80 points each, D = 64
    rng = np.random.default_rng(0)
    centers = rng.standard_normal((50, 64)).astype(np.float32) * 3
    pts = centers[np.repeat(np.arange(50), 80)] + rng.standard_normal((4000, 64)).astype(np.float32)
    emb = np.asarray(l2_normalize(pts))
    queries = np.asarray(l2_normalize(centers[:20] + 0.5 * rng.standard_normal((20, 64)).astype(np.float32)))
    return emb, queries


@pytest.fixture(scope="module")
def pallas_scale_corpus():
    # tests/test_ivf.py's fixture: 32 clusters x ~512 members at D = 128,
    # slab rows 768 (a multiple of 128: the probe-major route)
    rng = np.random.default_rng(3)
    centers = np.asarray(l2_normalize(rng.standard_normal((32, 128)).astype(np.float32)))
    assign = rng.integers(0, 32, 16384)
    pts = centers[assign] + (0.7 / np.sqrt(128)) * rng.standard_normal((16384, 128)).astype(np.float32)
    emb = np.asarray(l2_normalize(pts))
    q = centers[rng.integers(0, 32, 16)] + (0.7 / np.sqrt(128)) * rng.standard_normal((16, 128)).astype(np.float32)
    queries = np.asarray(l2_normalize(q))
    idx = JIVFIndex.build(emb, config=JIndexConfig(ivf_nlist=32, dtype="int8", ivf_assign2_margin=0.02),
                          slab_rows=768, normalize=False)
    return emb, queries, idx


def _oracle(q, emb, k=10):
    return exact_topk(q, emb, k=k, device=CPU)[1]


def _no_dups(ids):
    for row in np.asarray(ids):
        real = row[row >= 0]
        assert len(set(real.tolist())) == len(real)


def _jax_saved(tmp_path_factory, jidx, name):
    path = tmp_path_factory.mktemp(name) / "ivf"
    jidx.save(path)
    return path


# ---------------------------------------------------------------- k-means


def test_kmeans_reduces_quantization_error(clustered_corpus):
    emb, _ = clustered_corpus
    cents = train_kmeans(emb, nlist=50, iters=20, seed=0, device=CPU)
    assert cents.shape == (50, 64)
    np.testing.assert_allclose(np.linalg.norm(cents, axis=1), 1.0, rtol=1e-4)
    assert (emb @ cents.T).max(axis=1).mean() > 0.8


def test_kmeans_random_init_matches_reference(clustered_corpus):
    """init="random" seeds from the same numpy draw in both packages; the
    Lloyd rounds then differ only in f32 summation order. Bounds: every
    centroid at cosine >= 0.999 to the reference's of the same index, and
    the rows' nearest centroid the same for >= 99% of rows."""
    emb, _ = clustered_corpus
    want = j_train_kmeans(emb, 50, iters=10, seed=3, init="random")
    got = train_kmeans(emb, 50, iters=10, seed=3, init="random", device=CPU)
    cos = (want * got).sum(axis=1) / np.linalg.norm(want, axis=1) / np.linalg.norm(got, axis=1)
    assert cos.min() >= 0.999, cos.min()
    agree = np.mean((emb @ want.T).argmax(1) == (emb @ got.T).argmax(1))
    assert agree >= 0.99, agree


def test_kmeans_checkpoint_kill_and_resume(clustered_corpus, tmp_path, monkeypatch):
    """A build killed mid-k-means resumes from the last persisted round
    and lands on the centroids of an uninterrupted run."""
    emb, _ = clustered_corpus
    full = train_kmeans(emb, 16, iters=9, seed=1, sample=None, device=CPU)
    real = ivf_mod._kmeans_device
    calls = {"n": 0}

    def dying(x, cents, *, nlist, iters):
        calls["n"] += 1
        if calls["n"] == 3:
            raise RuntimeError("killed")
        return real(x, cents, nlist=nlist, iters=iters)

    monkeypatch.setattr(ivf_mod, "_kmeans_device", dying)
    with pytest.raises(RuntimeError):
        train_kmeans(emb, 16, iters=9, seed=1, sample=None, checkpoint_dir=tmp_path, ckpt_every=3,
                     device=CPU)
    monkeypatch.setattr(ivf_mod, "_kmeans_device", real)
    resumed = train_kmeans(emb, 16, iters=9, seed=1, sample=None, checkpoint_dir=tmp_path,
                           ckpt_every=3, device=CPU)
    np.testing.assert_allclose(resumed, full, atol=1e-6)


def test_kmeans_checkpoint_key_is_the_references(clustered_corpus, tmp_path):
    """A k-means checkpoint the reference wrote resumes in the port (same
    file, same key): the port's centroids are then the reference's."""
    emb, _ = clustered_corpus
    want = j_train_kmeans(emb, 16, iters=4, seed=2, sample=None, checkpoint_dir=tmp_path, ckpt_every=2)
    got = train_kmeans(emb, 16, iters=4, seed=2, sample=None, checkpoint_dir=tmp_path, ckpt_every=2,
                       device=CPU)
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------- build


def test_ivf_build_layout(clustered_corpus):
    emb, _ = clustered_corpus
    idx = IVFIndex.build(emb, config=IndexConfig(ivf_nlist=50, dtype="int8"), normalize=False, device=CPU)
    L, R, D = idx.slabs.shape
    assert L == 50 and D == 64
    # every doc id exactly once across slabs + spill
    all_ids = np.concatenate([idx.slab_ids.numpy().ravel(), idx.spill_ids.numpy()])
    real = all_ids[all_ids >= 0]
    assert len(real) == 4000 and len(set(real.tolist())) == 4000
    # padding slots are zero vectors; int8 slab rows a power-of-two multiple of 128
    assert not idx.slabs[idx.slab_ids < 0].any()
    assert R % 128 == 0 and (R // 128) & (R // 128 - 1) == 0
    assert idx.spill.shape[0] % R == 0 and idx.spill.shape[0] >= R
    # one corpus-wide scale, repeated in slab_scales
    assert idx.global_scale > 0
    np.testing.assert_allclose(idx.slab_scales[idx.slab_ids >= 0].numpy(), idx.global_scale, rtol=1e-6)
    assert idx.raw_flat.dtype == torch.bfloat16 and idx.raw_flat.shape == (L * R + idx.spill.shape[0], D)


@pytest.mark.parametrize("cfg", [
    dict(ivf_nlist=50, dtype="int8"),
    dict(ivf_nlist=50, dtype="int8", ivf_assign2_margin=0.05),
    dict(ivf_nlist=50, dtype="int8", residual=True),
    dict(ivf_nlist=50, dtype="float32", slab_rows=32),
], ids=["int8", "int8_dual", "int8_residual", "f32_spill"])
def test_packing_given_the_references_centroids_is_the_references(clustered_corpus, tmp_path, cfg):
    """With the reference's k-means checkpoint (its centroids): (a) with
    its assignment checkpoint too, every array of the port's build equals
    the reference's; (b) with the port's own top-2 assignment, every slab
    and the spill hold the same doc ids, each with the same codes."""
    emb, _ = clustered_corpus
    cfg = dict(cfg)
    slab_rows = cfg.pop("slab_rows", None)
    jidx = JIVFIndex.build(emb, config=JIndexConfig(**cfg), slab_rows=slab_rows, normalize=False,
                           checkpoint_dir=tmp_path)
    tidx = IVFIndex.build(emb, config=IndexConfig(**cfg), slab_rows=slab_rows, normalize=False,
                          checkpoint_dir=tmp_path, device=CPU)
    for name in ("centroids", "slabs", "slab_scales", "slab_ids", "spill", "spill_scales",
                 "spill_ids", "res_flat", "res_scales_flat"):
        a, b = getattr(jidx, name), getattr(tidx, name)
        assert (a is None) == (b is None), name
        if a is not None:
            np.testing.assert_array_equal(b.numpy(), a, err_msg=name)
    if jidx.raw_flat is not None:
        np.testing.assert_array_equal(tidx.raw_flat.view(torch.int16).numpy().view(np.uint16),
                                      jidx.raw_flat.view(np.uint16))
    assert tidx.global_scale == jidx.global_scale and tidx.config.to_dict() == jidx.config.to_dict()

    (tmp_path / "assign_ckpt.npz").unlink()
    own = IVFIndex.build(emb, config=IndexConfig(**cfg), slab_rows=slab_rows, normalize=False,
                         checkpoint_dir=tmp_path, device=CPU)
    codes_of = {}
    for ids, codes in ((jidx.slab_ids.ravel(), jidx.slabs.reshape(-1, 64)),
                       (jidx.spill_ids, jidx.spill)):
        codes_of.update({int(i): c for i, c in zip(ids, codes) if i >= 0})
    for c in range(jidx.slabs.shape[0]):
        assert set(own.slab_ids[c].tolist()) == set(jidx.slab_ids[c].tolist()), c
    assert set(own.spill_ids.tolist()) == set(jidx.spill_ids.tolist())
    for ids, codes in ((own.slab_ids.reshape(-1), own.slabs.reshape(-1, 64)), (own.spill_ids, own.spill)):
        for i, row in zip(ids.tolist(), codes.numpy()):
            if i >= 0:
                np.testing.assert_array_equal(row, codes_of[i])


def test_ivf_build_checkpoint_reuse(clustered_corpus, tmp_path):
    emb, _ = clustered_corpus
    cfg = IndexConfig(ivf_nlist=32, dtype="int8", ivf_assign2_margin=0.02)
    a = IVFIndex.build(emb, config=cfg, checkpoint_dir=tmp_path, device=CPU)
    assert (tmp_path / "kmeans_ckpt.npz").exists() and (tmp_path / "assign_ckpt.npz").exists()
    b = IVFIndex.build(emb, config=cfg, checkpoint_dir=tmp_path, device=CPU)
    assert torch.equal(a.slab_ids, b.slab_ids) and torch.equal(a.spill_ids, b.spill_ids)
    assert torch.equal(a.centroids, b.centroids)


def test_checkpoint_invalidated_by_different_corpus(clustered_corpus, tmp_path):
    emb, _ = clustered_corpus
    cfg = IndexConfig(ivf_nlist=16, dtype="float32")
    a = IVFIndex.build(emb, config=cfg, checkpoint_dir=tmp_path, device=CPU)
    rng = np.random.default_rng(123)
    emb2 = np.asarray(l2_normalize(rng.standard_normal(emb.shape).astype(np.float32)))
    b = IVFIndex.build(emb2, config=cfg, checkpoint_dir=tmp_path, device=CPU)
    assert not torch.allclose(a.centroids, b.centroids)
    _, ids = b.search(emb2[:4], k=1, nprobe=16)
    assert (ids[:, 0] == np.arange(4)).all()


# ---------------------------------------------------------------- search


def test_cross_load_reference_index_ids_equal(pallas_scale_corpus, tmp_path_factory):
    """A reference-built, reference-saved index loads in the port; the
    port's probe-major search (plain B6 on the CPU) returns the ids of the
    reference's `device_searcher(interpret=True)`, scores within 1e-5
    (f32 sums of exact bf16 products in another order)."""
    emb, q, jidx = pallas_scale_corpus
    tidx = IVFIndex.load(_jax_saved(tmp_path_factory, jidx, "jload"), device=CPU)
    assert tidx.probe_major_ok
    for nprobe, b in ((8, 16), (2, 8), (4, 5)):
        js, ji = jidx.device_searcher(k=10, nprobe=nprobe, rescore_factor=8, interpret=True)(q[:b])
        ts, ti = tidx.device_searcher(k=10, nprobe=nprobe, rescore_factor=8)(torch.tensor(q[:b]))
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=0, atol=1e-5)
    # search() pads its chunks with zero queries, as the reference's does
    js, ji = jidx.search(q, k=10, nprobe=4, rescore_factor=8, use_pallas=True, interpret=True,
                         query_chunk=32)
    ts, ti = tidx.search(q, k=10, nprobe=4, rescore_factor=8, query_chunk=32)
    np.testing.assert_array_equal(ti, ji)
    _no_dups(ti)
    ref = _oracle(q, emb)
    assert recall_vs_exact(ti, ref, k=10) >= 0.95


def test_port_saved_index_loads_in_the_reference(clustered_corpus, tmp_path):
    emb, q = clustered_corpus
    for name, cfg in (("bf16", IndexConfig(ivf_nlist=32, dtype="int8")),
                      ("resid", IndexConfig(ivf_nlist=32, dtype="int8", residual=True))):
        idx = IVFIndex.build(emb, config=cfg, normalize=False, device=CPU)
        idx.save(tmp_path / name)
        jidx = JIVFIndex.load(tmp_path / name)
        back = IVFIndex.load(tmp_path / name, device=CPU)
        for attr in ("slabs", "slab_ids", "spill", "spill_ids", "centroids", "res_flat"):
            a = getattr(idx, attr)
            if a is not None:
                np.testing.assert_array_equal(getattr(jidx, attr), a.numpy())
                assert torch.equal(getattr(back, attr), a)
        if idx.raw_flat is not None:
            np.testing.assert_array_equal(jidx.raw_flat.view(np.uint16),
                                          idx.raw_flat.view(torch.int16).numpy().view(np.uint16))
        assert jidx.global_scale == idx.global_scale and jidx.num_rows == idx.num_rows
        assert back.memory_bytes() == idx.memory_bytes() == jidx.memory_bytes()
        # the rows are 128 wide: both packages take the gather route
        s1, i1 = idx.search(q[:5], k=5, nprobe=8, probe_major=False)
        s2, i2 = jidx.search(q[:5], k=5, nprobe=8, use_pallas=False)
        np.testing.assert_array_equal(i1, i2)
        np.testing.assert_allclose(s1, s2, rtol=0, atol=1e-5)


@pytest.mark.parametrize("kind", ["float32", "int8_no_rescore", "int8_bf16", "int8_dual"])
def test_gather_route_matches_reference(clustered_corpus, tmp_path, kind):
    """The gather route (any index the kernel path does not take) against
    the reference's `search(use_pallas=False)` on the same index: ids
    equal, scores within 1e-5."""
    emb, q = clustered_corpus
    cfg = {"float32": dict(dtype="float32"), "int8_no_rescore": dict(dtype="int8"),
           "int8_bf16": dict(dtype="int8"), "int8_dual": dict(dtype="int8", ivf_assign2_margin=0.05)}[kind]
    jidx = JIVFIndex.build(emb, config=JIndexConfig(ivf_nlist=50, **cfg), normalize=False,
                           rescore=False if kind == "int8_no_rescore" else None)
    jidx.save(tmp_path / "i")
    tidx = IVFIndex.load(tmp_path / "i", device=CPU)
    for nprobe in (4, 16, 50):
        js, ji = jidx.search(q, k=10, nprobe=nprobe, rescore_factor=8, use_pallas=False)
        ts, ti = tidx.search(q, k=10, nprobe=nprobe, rescore_factor=8, probe_major=False)
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_allclose(ts, js, rtol=0, atol=1e-5)
        _no_dups(ti)


def test_residual_mode_both_routes(pallas_scale_corpus, tmp_path):
    """Capacity mode (two-level int8 rescore, no bf16 copy) on a
    reference-built index: both routes return the reference's ids, scores
    near-fp32 products (5e-4, the reference's bound)."""
    emb, q, _ = pallas_scale_corpus
    jidx = JIVFIndex.build(emb, config=JIndexConfig(ivf_nlist=32, dtype="int8",
                                                    ivf_assign2_margin=0.02, residual=True),
                           slab_rows=768, normalize=False)
    jidx.save(tmp_path / "r")
    tidx = IVFIndex.load(tmp_path / "r", device=CPU)
    assert tidx.raw_flat is None and tidx.res_flat is not None and tidx.probe_major_ok
    js, ji = jidx.device_searcher(k=10, nprobe=8, rescore_factor=8, interpret=True)(q)
    ts, ti = tidx.device_searcher(k=10, nprobe=8, rescore_factor=8)(q)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=0, atol=1e-5)
    exp = np.take_along_axis(q @ emb.T, ti.numpy(), 1)
    np.testing.assert_allclose(ts.numpy(), exp, atol=5e-4)
    js2, ji2 = jidx.search(q, k=10, nprobe=8, rescore_factor=8, use_pallas=False)
    ts2, ti2 = tidx.search(q, k=10, nprobe=8, rescore_factor=8, probe_major=False)
    np.testing.assert_array_equal(ti2, ji2)
    np.testing.assert_allclose(ts2, js2, rtol=0, atol=1e-5)


def test_residual_build_smaller_and_exact_grade(clustered_corpus):
    emb, q = clustered_corpus
    idx_r = IVFIndex.build(emb, config=IndexConfig(ivf_nlist=50, dtype="int8", residual=True),
                           normalize=False, device=CPU)
    idx_b = IVFIndex.build(emb, config=IndexConfig(ivf_nlist=50, dtype="int8"), normalize=False, device=CPU)
    assert idx_r.raw_flat is None and idx_r.has_rescore
    assert idx_r.memory_bytes() < idx_b.memory_bytes()
    ref = _oracle(q, emb)
    s, i = idx_r.search(q, k=10, nprobe=50, rescore_factor=8)
    assert recall_vs_exact(i, ref, k=10) >= 0.95
    exp = np.take_along_axis(q @ emb.T, i, 1)
    np.testing.assert_allclose(s[i >= 0], exp[i >= 0], atol=5e-4)


def test_full_probe_matches_exact_and_spill_reachable(clustered_corpus):
    emb, q = clustered_corpus
    ref = _oracle(q, emb)
    idx = IVFIndex.build(emb, config=IndexConfig(ivf_nlist=50, dtype="float32"), normalize=False,
                         device=CPU)
    _, i = idx.search(q, k=10, nprobe=50)
    assert recall_vs_exact(i, ref, k=10) == 1.0
    recalls = [recall_vs_exact(idx.search(q, k=10, nprobe=p)[1], ref, k=10) for p in (1, 4, 16, 50)]
    assert all(a <= b + 1e-9 for a, b in zip(recalls, recalls[1:])) and recalls[1] > 0.5
    # tiny slabs force heavy spill; a full probe must still be exact
    sp = IVFIndex.build(emb, config=IndexConfig(ivf_nlist=50, dtype="float32"), slab_rows=32,
                        normalize=False, device=CPU)
    assert (sp.spill_ids >= 0).sum() > 0
    _, i = sp.search(q, k=10, nprobe=50)
    assert recall_vs_exact(i, ref, k=10) == 1.0


def test_probe_major_route_quality_and_dual_dedupe(clustered_corpus):
    """The probe-major route on a port-built index (slab rows 128):
    recall, duplicate-free rows under dual assignment, scores exact-grade
    products of the returned rows."""
    emb, q = clustered_corpus
    idx = IVFIndex.build(emb, config=IndexConfig(ivf_nlist=50, dtype="int8", ivf_assign2_margin=0.05),
                         normalize=False, device=CPU)
    all_ids = np.concatenate([idx.slab_ids.numpy().ravel(), idx.spill_ids.numpy()])
    counts = np.bincount(all_ids[all_ids >= 0], minlength=4000)
    assert counts.min() >= 1 and counts.max() == 2
    assert idx.probe_major_ok
    s, i = idx.search(q, k=10, nprobe=50, rescore_factor=8)
    _no_dups(i)
    assert recall_vs_exact(i, _oracle(q, emb), k=10) >= 0.95
    np.testing.assert_allclose(s, np.take_along_axis(q @ emb.T, i, 1), atol=5e-3)
    _, i2 = idx.search(q, k=10, nprobe=16, rescore_factor=8, probe_major=False)
    _no_dups(i2)
    with pytest.raises(ValueError, match="probe-major"):
        IVFIndex.build(emb, config=IndexConfig(ivf_nlist=8, dtype="float32"), normalize=False,
                       device=CPU).device_searcher()


def test_calibrate_nprobe_picks_the_references(clustered_corpus, tmp_path):
    """On one reference-built index, the port's calibration (oracle on the
    index's device) picks the reference's nprobe, and it holds the gate."""
    emb, _ = clustered_corpus
    jidx = JIVFIndex.build(emb, config=JIndexConfig(ivf_nlist=32, dtype="float32"))
    jidx.save(tmp_path / "c")
    tidx = IVFIndex.load(tmp_path / "c", device=CPU)
    kw = dict(gate=0.95, k=10, n_queries=64, n_draws=2, candidates=(2, 4, 8, 16, 32))
    jn, jr = j_calibrate(jidx, emb, **kw)
    tn, tr = calibrate_nprobe(tidx, emb, **kw)
    assert tn == jn and tr >= 0.95
    assert abs(tr - jr) <= 0.02
    # a tensor corpus gives the same pick
    tn2, tr2 = calibrate_nprobe(tidx, torch.tensor(emb), **kw)
    assert (tn2, tr2) == (tn, tr)


# ---------------------------------------------------------------- builder


def test_builder_finalize_ivf(clustered_corpus, tmp_path):
    emb, q = clustered_corpus
    b = IndexBuilder(tmp_path / "spool", IndexConfig(ivf_nlist=32, dtype="int8", int8_scale="global",
                                                      ivf_assign2_margin=0.02))
    ids = np.arange(emb.shape[0], dtype=np.int64)
    b.add(ids[:2000], emb[:2000])
    b.add(ids[1990:], emb[1990:])          # a restart overlap: first copies kept
    assert b.cursor == 3999 and b.total_rows == 4010
    index, calib = b.finalize_ivf(calibrate_gate=0.9, device=CPU)
    assert calib is not None and calib[1] >= 0.5
    assert index.config.ivf_nprobe == calib[0] and index.config.ivf_nprobe_calibrated
    assert (tmp_path / "spool" / "kmeans_ckpt.npz").exists()
    assert index.num_rows == 4000
    _, found = index.search(q, k=10, nprobe=32)
    assert recall_vs_exact(found, _oracle(q, emb), k=10) >= 0.9
    # the spool resumes in the reference, with the same rows
    jb = JIndexBuilder(tmp_path / "spool")
    jids, jemb = jb._load_deduped()
    tids, temb = b._load_deduped()
    np.testing.assert_array_equal(tids, jids)
    np.testing.assert_array_equal(temb, jemb)
    flat = b.finalize(device=CPU)
    assert flat.num_rows == 4000


def test_finalize_ivf_uncleared_gate_not_stamped_calibrated(clustered_corpus, tmp_path):
    emb, _ = clustered_corpus
    b = IndexBuilder(tmp_path / "spool", IndexConfig(ivf_nlist=32, dtype="int8", int8_scale="global",
                                                      ivf_assign2_margin=0.02))
    b.add(np.arange(emb.shape[0], dtype=np.int64), emb)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        index, calib = b.finalize_ivf(calibrate_gate=1.01, device=CPU)   # unclearable
    assert calib is not None and calib[1] < 1.01
    assert not index.config.ivf_nprobe_calibrated
    assert any("did not clear" in str(x.message) for x in w)
    with pytest.raises(ValueError, match="different IndexConfig"):
        IndexBuilder(tmp_path / "spool", IndexConfig(ivf_nlist=8))
