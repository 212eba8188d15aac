"""Port parity: FlatIndex's size surface (padded_rows, dim, memory_bytes)
in the four index layouts, and SearchEngine.compact's warm_batches
argument, against the JAX package on the same rows."""

import numpy as np
import pytest
import torch

from theoremsearch_tpu.core.config import IndexConfig as JIndexConfig
from theoremsearch_tpu.index.flat import FlatIndex as JFlatIndex
from theoremsearch_tpu.search.engine import SearchEngine as JSearchEngine
from theoremsearch_tpu_torch.core.config import IndexConfig
from theoremsearch_tpu_torch.index.flat import FlatIndex
from theoremsearch_tpu_torch.search.engine import SearchEngine

from torch_helpers import serialize_reference_native

torch.set_num_threads(1)
# the reference normalizes through its native library in every worker
serialize_reference_native()

LAYOUTS = {
    "bfloat16": {"dtype": "bfloat16"},
    "int8": {"dtype": "int8"},
    "int8-global": {"dtype": "int8", "int8_scale": "global"},
    "int8-global-residual": {"dtype": "int8", "int8_scale": "global", "residual": True},
}


def _rows(n=300, d=96, seed=0):
    x = np.random.default_rng(seed).standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_flat_index_sizes_match_the_reference(layout):
    emb = _rows()
    kw = dict(LAYOUTS[layout], pad_multiple=128)
    ref = JFlatIndex.build(emb, config=JIndexConfig(**kw))
    got = FlatIndex.build(emb, config=IndexConfig(**kw), device="cpu")
    assert (got.dim, got.padded_rows) == (ref.dim, ref.padded_rows) == (96, 384)
    # the reference's flat count stops at the scales; the port adds the
    # residual sidecars, as both packages' IVFIndex.memory_bytes do
    sidecars = sum(a.nbytes for a in ref.rescore_residual) if ref.rescore_residual else 0
    assert got.memory_bytes() == ref.memory_bytes() + sidecars
    assert (sidecars > 0) == (layout == "int8-global-residual")


def _compact_run(pkg: str, reclaim: bool):
    emb, add = _rows(), _rows(40, seed=1)
    q = _rows(16, seed=2)
    if pkg == "torch":
        idx = FlatIndex.build(emb, config=IndexConfig(pad_multiple=128, dtype="float32"),
                              normalize=False, device="cpu")
        eng = SearchEngine(idx, row_block=128, device="cpu")
    else:
        idx = JFlatIndex.build(emb, config=JIndexConfig(pad_multiple=128, dtype="float32"),
                               normalize=False)
        eng = JSearchEngine(idx, row_block=128, use_pallas=False)
    new = eng.add_documents(add)
    eng.delete_documents([3, 17, 250, int(new[2]), int(new[30])])
    folded = eng.compact(reclaim=reclaim, warm_batches=(8, 64))
    s, i = eng.search_vectors(q, k=10)
    return folded, eng.num_live, np.asarray(s, np.float32), np.asarray(i, np.int64)


@pytest.mark.parametrize("reclaim", [False, True])
def test_compact_warm_batches_twin(reclaim):
    jf, jn, js, ji = _compact_run("jax", reclaim)
    pf, pn, ps, pi = _compact_run("torch", reclaim)
    assert (pf, pn) == (jf, jn) == (38, 335)
    np.testing.assert_array_equal(pi, ji)
    np.testing.assert_allclose(ps, js, atol=1e-5)


@pytest.mark.parametrize("bad", [(0,), (8, -1), (2.5,)])
def test_compact_rejects_bad_warm_batches(bad):
    idx = FlatIndex.build(_rows(64), config=IndexConfig(pad_multiple=128, dtype="float32"),
                          device="cpu")
    eng = SearchEngine(idx, row_block=128, device="cpu")
    eng.add_documents(_rows(4, seed=3))
    with pytest.raises(ValueError, match="warm_batches"):
        eng.compact(warm_batches=bad)
    assert eng.num_live == 68
