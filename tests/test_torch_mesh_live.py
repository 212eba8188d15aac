"""Port parity: live updates on the row-sharded engine against the JAX
package on its 8-device CPU mesh, twins of the mesh cases of
tests/test_live_updates.py (add / update / delete / compact / reclaim,
with metadata and filters, concurrent queries, randomized interleavings).

Each case is a scenario over a package namespace, run once per package
through `test_torch_live_updates.twin` (the port on a mesh of repeated
"cpu" devices): their logged searches must agree, ids equal where the
scores are unique and scores within 1e-5. Inside each package the
scenario holds the mesh engine to the single-device engine id for id, as
the reference tests do."""

import threading

import numpy as np
import pytest
import torch

from theoremsearch_tpu.core import MeshConfig as JMeshConfig
from theoremsearch_tpu.core import make_mesh as j_make_mesh
from test_torch_live_random import _check_topk_vs_oracle, _random_op
from test_torch_live_updates import Pkg, _meta_rows, _norm, _oracle, _small, twin
from torch_helpers import cpu_mesh, serialize_reference_native

torch.set_num_threads(2)
# the reference normalizes through its native library in every worker
serialize_reference_native()


class MeshPkg(Pkg):
    """Pkg with engines on a mesh of `n_shards` shards: the JAX package's
    CPU devices, or repeated "cpu" devices for the port."""

    def mesh(self, n_shards):
        return cpu_mesh(n_shards) if self.torch else j_make_mesh(JMeshConfig(data=1, shard=n_shards))

    def sharded_fp32_engine(self, emb, meta=None, n_shards=8):
        return self.fp32_engine(emb, meta=meta, mesh=self.mesh(n_shards))

    def sharded_speed_engine(self, emb, meta=None, n_shards=4):
        idx = self.build(emb, config=self.IndexConfig(pad_multiple=256, dtype="int8", int8_scale="global"))
        return self.engine(idx, True, meta=meta, mesh=self.mesh(n_shards), row_block=128,
                           rescore_factor=8, rescore_vectors=emb)


def sharded_live_mutations_match_single_device(P):
    emb, new, q = _small()
    eng_m, eng_1 = P.sharded_fp32_engine(emb), P.fp32_engine(emb)

    def check():
        s_m, i_m = eng_m.search_vectors(q, k=8)
        s_1, i_1 = eng_1.search_vectors(q, k=8)
        np.testing.assert_array_equal(i_m, i_1)
        np.testing.assert_allclose(s_m, s_1, atol=2e-3)

    ids_m = eng_m.add_documents(new[:6], normalize=False)
    np.testing.assert_array_equal(ids_m, eng_1.add_documents(new[:6], normalize=False))
    check()
    for e in (eng_m, eng_1):
        e.update_document(42, new[6])
    check()
    for e in (eng_m, eng_1):
        assert e.delete_documents([17, int(ids_m[0]), 42]) == 3
    assert eng_m.num_live == eng_1.num_live == 600 + 6 - 3
    check()


def sharded_compact_and_reclaim_match_single_device(P):
    emb, new, q = _small()
    eng_m, eng_1 = P.sharded_fp32_engine(emb), P.fp32_engine(emb)
    for e in (eng_m, eng_1):
        e.add_documents(new[:8], normalize=False)
        e.delete_documents([3, 77, 601])
    assert eng_m.compact() == eng_1.compact()
    assert eng_m.n_valid == eng_1.n_valid
    np.testing.assert_array_equal(eng_m.search_vectors(q, k=10)[1], eng_1.search_vectors(q, k=10)[1])
    for e in (eng_m, eng_1):
        e.add_documents(new[8:12], normalize=False)
    assert eng_m.compact(reclaim=True) == eng_1.compact(reclaim=True)
    np.testing.assert_array_equal(eng_m.last_id_map, eng_1.last_id_map)
    assert eng_m.n_valid == eng_1.n_valid == 600 + 12 - 3
    s_m, i_m = eng_m.search_vectors(q, k=10)
    s_1, i_1 = eng_1.search_vectors(q, k=10)
    np.testing.assert_array_equal(i_m, i_1)
    np.testing.assert_allclose(s_m, s_1, atol=2e-3)


def sharded_speed_path_live_mutations(P):
    emb, new, q = _small()
    eng_m, eng_1 = P.sharded_speed_engine(emb), P.speed_engine(emb)

    def check():
        np.testing.assert_array_equal(eng_m.search_vectors(q, k=8)[1], eng_1.search_vectors(q, k=8)[1])

    for e in (eng_m, eng_1):
        e.add_documents(new[:5], normalize=False)
    check()
    for e in (eng_m, eng_1):
        assert e.delete_documents([0, 1, 2, 603]) == 4
    check()
    for e in (eng_m, eng_1):
        e.update_document(10, new[6])
    check()
    assert eng_m.compact() == eng_1.compact()
    check()
    assert eng_m.compact(reclaim=True) == eng_1.compact(reclaim=True)
    np.testing.assert_array_equal(eng_m.last_id_map, eng_1.last_id_map)
    check()


def sharded_live_mutations_with_meta_and_filters(P):
    emb, new, q = _small()
    eng_m = P.sharded_fp32_engine(emb, meta=P.CorpusMetadata.from_rows(_meta_rows(600)))
    eng_1 = P.fp32_engine(emb, meta=P.CorpusMetadata.from_rows(_meta_rows(600)))
    rows = _meta_rows(6, start=600, year=2021)
    for e in (eng_m, eng_1):
        e.add_documents(new[:6], meta_rows=rows, normalize=False)
        e.delete_documents([9, 602])
    f = P.SearchFilters(year_range=(2021, 2021))
    _, i_m = eng_m.search_vectors(q, k=4, filters=f)
    np.testing.assert_array_equal(i_m, eng_1.search_vectors(q, k=4, filters=f)[1])
    assert {int(d) for d in i_m.ravel() if d >= 0} <= {600, 601, 603, 604, 605}
    for e in (eng_m, eng_1):
        assert e.compact(reclaim=True) == 5
    np.testing.assert_array_equal(eng_m.last_id_map, eng_1.last_id_map)
    _, i_m = eng_m.search_vectors(q, k=4, filters=f)
    np.testing.assert_array_equal(i_m, eng_1.search_vectors(q, k=4, filters=f)[1])
    assert all(int(np.asarray(eng_m.meta.year)[int(d)]) == 2021 for d in i_m.ravel() if d >= 0)


def sharded_compact_concurrent_with_queries(P):
    emb, new, q = _small()
    eng = P.sharded_fp32_engine(emb)
    errs: list = []
    stop = threading.Event()

    def hammer():
        while not stop.is_set():
            try:
                _, i = eng.search_vectors(q, k=5)
                assert i.shape == (9, 5) and (i >= 0).all()
            except Exception as e:  # noqa: BLE001 - collected for the assert below
                errs.append(e)
                return

    t = threading.Thread(target=hammer)
    t.start()
    try:
        for j in range(4):
            eng.add_documents(new[5 * j : 5 * j + 5], normalize=False)
            assert eng.compact() == 5
    finally:
        stop.set()
        t.join(timeout=60)
    assert not errs, errs
    assert eng.n_valid == 620 and eng._main_ids_arange
    _, ref_i = _oracle(q, np.concatenate([emb, new]), np.arange(620), 10)
    np.testing.assert_array_equal(eng.search_vectors(q, k=10)[1], ref_i)


def randomized_sharded_live_ops_vs_oracle(P, seed):
    dim, n0, steps = 32, 96, 18
    rng = np.random.default_rng(700 + seed)
    base = _norm(rng.standard_normal((n0, dim)))
    eng = P.sharded_fp32_engine(base, n_shards=4)
    oracle = {i: base[i] for i in range(n0)}
    qs = _norm(rng.standard_normal((3, dim)))
    for _ in range(steps):
        _random_op(rng, eng, oracle, dim)
        assert eng.num_live == len(oracle)
        _check_topk_vs_oracle(eng, oracle, qs, k=8)
    eng.compact(reclaim=True)
    mp = eng.last_id_map
    if mp is not None:
        oracle = {(int(mp[d]) if d < len(mp) else d): v for d, v in oracle.items()}
    assert eng.num_live == len(oracle)
    _check_topk_vs_oracle(eng, oracle, qs, k=8)


SCENARIOS = [sharded_live_mutations_match_single_device, sharded_compact_and_reclaim_match_single_device,
             sharded_speed_path_live_mutations, sharded_live_mutations_with_meta_and_filters,
             sharded_compact_concurrent_with_queries]


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__)
def test_sharded_live_updates_match_reference(scenario):
    twin(scenario, pkg=MeshPkg)


@pytest.mark.parametrize("seed", [0, 1])
def test_randomized_sharded_live_ops_match_reference(seed):
    twin(randomized_sharded_live_ops_vs_oracle, seed, pkg=MeshPkg)
