"""Port parity: parameter placement over a mesh (`encoder/sharding.py`
and each tower's `param_sharding_rules` / `shard_params`) against the JAX
package on its 8-device CPU mesh: the same spec trees, the same pieces
bit for bit, the same refusal of a dimension that does not divide.

The port's meshes repeat "cpu" (`torch_helpers.cpu_mesh`)."""

import jax
import numpy as np
import pytest
import torch

from theoremsearch_tpu.core import MeshConfig as JMeshConfig
from theoremsearch_tpu.core import make_mesh as j_make_mesh
from theoremsearch_tpu.core.config import BertEncoderConfig as JBertConfig
from theoremsearch_tpu.core.config import EncoderConfig as JEncoderConfig
from theoremsearch_tpu.core.config import GemmaEncoderConfig as JGemmaConfig
from theoremsearch_tpu.encoder import bert as j_bert
from theoremsearch_tpu.encoder import gemma as j_gemma
from theoremsearch_tpu.encoder import model as j_model
from theoremsearch_tpu_torch.encoder import bert, gemma, model
from theoremsearch_tpu_torch.encoder.model import params_from_jax
from theoremsearch_tpu_torch.encoder.sharding import (
    ShardedTensor,
    is_sharded,
    place_params,
    row_params,
    unshard_params,
)
from theoremsearch_tpu_torch.train.contrastive import tree_leaves

from torch_helpers import cpu_mesh

torch.set_num_threads(2)

TOWERS = {
    "qwen": (j_model, model, JEncoderConfig.tiny),
    "gemma": (j_gemma, gemma, JGemmaConfig.tiny),
    "bert": (j_bert, bert, JBertConfig.tiny),
}


def _carry(tower, seed=0):
    jmod, mod, jcfg = TOWERS[tower]
    jp = jmod.init_params(jcfg(), jax.random.PRNGKey(seed))
    return jp, params_from_jax(jax.device_get(jp), device="cpu")


@pytest.mark.parametrize("tower", sorted(TOWERS))
def test_rules_equal_the_reference(tower):
    """Key for key, spec for spec (a PartitionSpec as its tuple)."""
    jmod, mod, _ = TOWERS[tower]
    jr = jmod.param_sharding_rules(j_make_mesh(JMeshConfig(data=2, shard=4)))
    pr = mod.param_sharding_rules(cpu_mesh(4, data=2))
    assert sorted(jr) == sorted(pr)
    assert sorted(jr["layers"]) == sorted(pr["layers"])
    for k in jr:
        if k != "layers":
            assert tuple(jr[k]) == pr[k], k
    for k in jr["layers"]:
        assert tuple(jr["layers"][k]) == pr["layers"][k], k
    assert mod.param_sharding_rules(None, tp_axis="tp")["layers"]["wo"] == ("tp", None)


@pytest.mark.parametrize("tower", sorted(TOWERS))
@pytest.mark.parametrize("shard,data", [(2, 1), (4, 2), (8, 1)])
def test_pieces_equal_the_reference_shards(tower, shard, data):
    """Each piece lives on its shard's device of the first data row and
    equals, bit for bit, the JAX shard on the device at that mesh position;
    a replicated leaf is one tensor on the first device; unshard_params
    gives the params back bit-equal; the input is left untouched."""
    jmod, mod, _ = TOWERS[tower]
    jp, tp = _carry(tower)
    before = [t.clone() for t in tree_leaves(tp)]
    jmesh = j_make_mesh(JMeshConfig(data=data, shard=shard))
    mesh = cpu_mesh(shard, data=data)
    js, ts = jmod.shard_params(jp, jmesh), mod.shard_params(tp, mesh)
    assert is_sharded(ts) and not is_sharded(tp)
    jl, tl = jax.tree.leaves(js), tree_leaves(ts)
    assert len(jl) == len(tl)
    for ja, t in zip(jl, tl):
        if not isinstance(t, ShardedTensor):
            assert t.device == mesh.first_device
            np.testing.assert_array_equal(t.float().numpy(), np.asarray(ja, np.float32))
            continue
        assert len(t.pieces) == shard and t.devices == mesh.shard_devices
        assert tuple(t.shape) == ja.shape and str(t.dtype) == f"torch.{ja.dtype}"
        by_dev = {s.device: np.asarray(s.data, np.float32) for s in ja.addressable_shards}
        for s, piece in enumerate(t.pieces):
            assert piece.is_contiguous()
            np.testing.assert_array_equal(piece.float().numpy(), by_dev[jmesh.devices[0, s]])
    for a, b in zip(tree_leaves(unshard_params(ts)), before):
        assert a.dtype == b.dtype and torch.equal(a, b)
    for p in tl:   # pieces share no storage with the input
        for piece in (p.pieces if isinstance(p, ShardedTensor) else [p]):
            piece.zero_()
    for a, b in zip(tree_leaves(tp), before):
        assert torch.equal(a, b)


def test_a_dimension_that_does_not_divide_raises_in_both_packages():
    """vocab 1023 on 4 shards: JAX refuses the uneven split, and so does
    the port, in the same words."""
    jcfg = JEncoderConfig(**{**JEncoderConfig.tiny().__dict__, "vocab_size": 1023})
    jp = j_model.init_params(jcfg, jax.random.PRNGKey(0))
    with pytest.raises(ValueError, match="should be divisible by 4, but it is equal to 1023"):
        j_model.shard_params(jp, j_make_mesh(JMeshConfig(data=2, shard=4)))
    tp = params_from_jax(jax.device_get(jp), device="cpu")
    with pytest.raises(ValueError, match="should be divisible by 4, but it is equal to 1023"):
        model.shard_params(tp, cpu_mesh(4, data=2))
    model.shard_params(tp, cpu_mesh(1, data=2))          # a one-way shard axis takes any size


def test_specs_the_port_refuses():
    """A spec naming another axis than the mesh's shard axis, or of the
    wrong rank, raises."""
    t = {"embed": torch.zeros(8, 4), "layers": []}
    mesh = cpu_mesh(2, data=2)
    with pytest.raises(ValueError, match="'data'"):
        place_params(t, {"embed": ("data", None), "layers": {}}, mesh)
    with pytest.raises(ValueError, match="does not fit"):
        place_params(t, {"embed": ("shard",), "layers": {}}, mesh)


def test_row_params_copies_for_each_data_row_and_sums_gradients():
    """Data row r reads each piece on its own shard devices; gradients
    through two rows' copies add up on the placed leaves."""
    _, tp = _carry("qwen")
    mesh = cpu_mesh(2, data=2)
    ts = model.shard_params(tp, mesh)
    assert row_params(ts, mesh, 0) is ts
    r1 = row_params(ts, mesh, 1)
    w0, w1 = ts["layers"][0]["wq"], r1["layers"][0]["wq"]
    assert w1.devices == list(mesh.devices[1])
    for a, b in zip(w0.pieces, w1.pieces):
        assert torch.equal(a, b)
    piece = w0.pieces[1]
    piece.requires_grad_(True)
    try:
        r1 = row_params(ts, mesh, 1)
        loss = (ts["layers"][0]["wq"].pieces[1].float().sum()
                + 2 * r1["layers"][0]["wq"].pieces[1].float().sum())
        (g,) = torch.autograd.grad(loss, [piece])
    finally:
        piece.requires_grad_(False)
    assert torch.equal(g, torch.full_like(g, 3))
