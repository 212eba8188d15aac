"""Port parity: the dp + tp train step (`init_sharded_train_state`,
`shard_train_state`, `make_train_step(mesh=)`, `make_lora_train_step(mesh=)`,
sharded checkpoints, `entry.dryrun_multichip`'s train item) against the
JAX package's mesh step on its 8-device CPU mesh and the port's own
single-device step: twins of tests/test_encoder.py:139-154.

Both packages start from the same numbers: the reference's sharded state
carried over with `train_state_from_jax` and placed again with
`shard_train_state`. The JAX side runs its mesh default, fused "off" (its
Pallas kernels are opaque to GSPMD); the port runs "off" and "on", the
latter through the plain versions of kernels B2 and B7 a shard (or on
the gathered heads). Losses are compared on one repeated batch of the
template task, as tests/test_torch_train.py does. The port's meshes
repeat "cpu"."""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from theoremsearch_tpu.core import MeshConfig as JMeshConfig
from theoremsearch_tpu.core import make_mesh as j_make_mesh
from theoremsearch_tpu.core.config import EncoderConfig as JEncoderConfig
from theoremsearch_tpu.core.config import TrainConfig as JTrainConfig
from theoremsearch_tpu.encoder.model import shard_params as j_shard_params
from theoremsearch_tpu.encoder.tokenizer import SimpleTokenizer as JSimpleTokenizer
from theoremsearch_tpu.train import contrastive as JC
from theoremsearch_tpu_torch.core.config import EncoderConfig, TrainConfig
from theoremsearch_tpu_torch.encoder.model import shard_params
from theoremsearch_tpu_torch.encoder.sharding import ShardedTensor, unshard_params
from theoremsearch_tpu_torch.entry import _train_item
from theoremsearch_tpu_torch.train import contrastive as PC
from theoremsearch_tpu_torch.train.checkpoint import restore_checkpoint, save_checkpoint
from theoremsearch_tpu_torch.train.contrastive import (
    TrainState,
    info_nce_loss,
    logical_grads,
    make_optimizer,
    piece_leaves,
    shard_train_state,
    train_state_from_jax,
    tree_leaves,
)
from theoremsearch_tpu_torch.train.lora import lora_from_jax

from test_torch_train import _cos, _template_task
from torch_helpers import cpu_mesh

torch.set_num_threads(2)

HD128 = dict(vocab_size=1024, hidden_size=256, intermediate_size=512, num_layers=2, num_heads=4,
             num_kv_heads=2, head_dim=128, max_seq_len=64, embedding_dim=256)
# EncoderConfig.tiny() runs in f32. In bf16 the reference's own mesh step
# and its single-device step part by 4.0e-3 at the second step on this
# batch (Adam's first update moves every weight by about lr whatever the
# size of its gradient, so the rounding of a gradient near 0 picks its
# direction), which leaves a 5e-3 gate no room; tests/test_torch_train.py
# compares the BERT trajectory in f32 for the same reason.
TINY_F32 = {**JEncoderConfig.tiny().__dict__, "dtype": "float32", "param_dtype": "float32"}
CONFIGS = {"hd128": HD128, "hd128_f32": {**HD128, "dtype": "float32", "param_dtype": "float32"},
           "tiny": TINY_F32}
B, S = 8, 32
TKW = dict(batch_size=B, seq_len=S, learning_rate=1e-3, temperature=1.0)


def _states(config, shard, seed=0):
    """The reference's sharded state on a (2, shard) mesh and the port's
    copy placed on cpu_mesh(shard, data=2); (jcfg, cfg, jmesh, mesh,
    jstate, state)."""
    jcfg, cfg = JEncoderConfig(**CONFIGS[config]), EncoderConfig(**CONFIGS[config])
    jmesh, mesh = j_make_mesh(JMeshConfig(data=2, shard=shard)), cpu_mesh(shard, data=2)
    jstate = JC.init_sharded_train_state(jcfg, JTrainConfig(**TKW), jmesh, jax.random.PRNGKey(seed))
    state = shard_train_state(train_state_from_jax(jax.device_get(jstate), device="cpu"), mesh, cfg)
    return jcfg, cfg, jmesh, mesh, jstate, state


@pytest.mark.parametrize("config,shard,fused", [
    ("hd128", 2, "off"), ("hd128", 2, "on"),   # head-local: 2/1 heads a shard
    ("hd128", 4, "on"),                        # gathered: 2 kv heads on 4 shards
    ("tiny", 4, "off"), ("tiny", 4, "on"),     # gathered; head_dim 32 never takes the kernel
])
def test_twenty_mesh_steps_match_jax(config, shard, fused):
    """20 dp + tp steps of both packages from the same sharded state:
    every loss within 5e-3 of JAX's; the pieces stay on their shards."""
    jcfg, cfg, jmesh, mesh, jstate, state = _states(config, shard)
    q_ids, p_ids, mask = _template_task(1, vocab=cfg.vocab_size)
    jstep = JC.make_train_step(jcfg, JTrainConfig(**TKW), mesh=jmesh)
    step = PC.make_train_step(cfg, TrainConfig(**TKW), mesh=mesh, fused=fused)
    jl, tl = [], []
    for _ in range(20):
        jstate, loss = jstep(jstate, q_ids[0], mask, p_ids[0], mask)
        jl.append(float(loss))
        state, loss = step(state, q_ids[0], mask, p_ids[0], mask)
        tl.append(float(loss))
    assert jl[-1] < jl[0] and state.step == 20 and state.opt_state.count == 20
    np.testing.assert_allclose(tl, jl, rtol=0, atol=5e-3)
    wq, mu = state.params["layers"][0]["wq"], state.opt_state.mu["layers"][0]["wq"]
    assert isinstance(wq, ShardedTensor) and isinstance(mu, ShardedTensor)
    assert wq.devices == mesh.shard_devices and len(wq.pieces) == shard


def _grads(params, ids, mask, cfg, fused, mesh=None):
    """(loss, gradients of `piece_leaves(params)`) of one InfoNCE batch."""
    pieces = piece_leaves(params)
    t = lambda x: torch.from_numpy(x)  # noqa: E731
    for p in pieces:
        p.requires_grad_(True)
    try:
        loss = info_nce_loss(params, t(ids[0]), t(mask), t(ids[1]), t(mask), cfg, 1.0, fused,
                             mesh=mesh)
        return loss.detach(), list(torch.autograd.grad(loss, pieces))
    finally:
        for p in pieces:
            p.requires_grad_(False)


def _one_batch(cfg):
    rng = np.random.default_rng(7)
    ids = rng.integers(3, cfg.vocab_size, (2, B, S)).astype(np.int32)
    mask = (np.arange(S)[None] < rng.integers(S // 2, S + 1, B)[:, None]).astype(np.int32)
    return ids, mask


@pytest.mark.parametrize("config,shard", [("hd128", 2), ("tiny", 4)])
def test_mesh_gradients_norm_and_first_loss(config, shard):
    """One batch: each logical leaf's gradient at cosine >= 0.999 against
    JAX's on its sharded params, the loss within 2e-3 of JAX's and of the
    port's unsharded loss; one mesh step's loss within 2e-3 of the port's
    unsharded step."""
    jcfg, cfg, jmesh, mesh, jstate, state = _states(config, shard, seed=4)
    ids, mask = _one_batch(cfg)
    jl, jg = jax.jit(jax.value_and_grad(JC.info_nce_loss), static_argnums=(5, 6))(
        jstate.params, ids[0], mask, ids[1], mask, jcfg, 1.0)
    full = train_state_from_jax(jax.device_get(jstate), device="cpu")
    for fused in ("off", "on"):
        loss, grads = _grads(state.params, ids, mask, cfg, fused, mesh)
        assert abs(float(loss) - float(jl)) <= 2e-3
        logical = logical_grads(state.params, grads)
        assert len(logical) == len(jax.tree.leaves(jg))
        for i, (a, b) in enumerate(zip(logical, jax.tree.leaves(jg))):
            assert tuple(a.shape) == b.shape
            assert _cos(a.float().numpy(), np.asarray(b, np.float32)) >= 0.999, (fused, i)
        loss1, _ = _grads(full.params, ids, mask, cfg, fused)
        assert abs(float(loss) - float(loss1)) <= 2e-3
    # one full step each: the same first loss
    _, l_mesh = PC.make_train_step(cfg, TrainConfig(**TKW), mesh=mesh)(state, ids[0], mask, ids[1], mask)
    _, l_one = PC.make_train_step(cfg, TrainConfig(**TKW))(full, ids[0], mask, ids[1], mask)
    assert abs(float(l_mesh) - float(l_one)) <= 2e-3


@pytest.mark.parametrize("config,shard", [("hd128_f32", 2), ("tiny", 4)])
def test_clip_reads_the_global_norm_over_all_pieces(config, shard):
    """The clip's norm over the mesh gradients' pieces (each piece's sum of
    squares added before the square root) within 1e-3 (relative) of the
    unsharded gradients' norm, and a per-shard norm (each shard's pieces
    alone, another optimizer) far from it. In f32: optax's rule rounds a
    bf16 leaf's sum of squares to bf16, and in bf16 the reference's own
    mesh and single-device norms of this batch part by 0.3% (4.7916 and
    4.7773 on the hd128 config)."""
    jcfg, cfg, jmesh, mesh, jstate, state = _states(config, shard, seed=4)
    ids, mask = _one_batch(cfg)
    full = train_state_from_jax(jax.device_get(jstate), device="cpu")
    opt = make_optimizer(TrainConfig(**TKW))
    _, grads = _grads(state.params, ids, mask, cfg, "on", mesh)
    _, grads1 = _grads(full.params, ids, mask, cfg, "on")
    n_mesh, n_one = float(opt.global_norm(grads)), float(opt.global_norm(grads1))
    assert abs(n_mesh - n_one) <= 1e-3 * n_one, (n_mesh, n_one)
    first = [g for g, leaf in zip(grads, _piece_owner(state.params)) if leaf in (None, 0)]
    assert float(opt.global_norm(first)) < 0.99 * n_one


def _piece_owner(params) -> list:
    """For each tensor of piece_leaves(params): its shard for a piece of a
    sharded leaf, None for a replicated leaf."""
    out = []
    for leaf in tree_leaves(params):
        out.extend(range(len(leaf.pieces)) if isinstance(leaf, ShardedTensor) else [None])
    return out


def test_mesh_step_with_explicit_negatives():
    """Explicit negatives are replicated (encoded once, by the first data
    row), as the reference's run leaves them: 3 steps within 5e-3."""
    jcfg, cfg, jmesh, mesh, jstate, state = _states("hd128", 2, seed=2)
    q_ids, p_ids, mask = _template_task(1, vocab=cfg.vocab_size, seed=3)
    neg = (p_ids[0][:3][:, ::-1].copy(), mask[:3])
    jstep = JC.make_train_step(jcfg, JTrainConfig(**TKW), mesh=jmesh)
    step = PC.make_train_step(cfg, TrainConfig(**TKW), mesh=mesh, fused="on")
    for _ in range(3):
        jstate, jl = jstep(jstate, q_ids[0], mask, p_ids[0], mask, jnp.asarray(neg[0]),
                           jnp.asarray(neg[1]))
        state, tl = step(state, q_ids[0], mask, p_ids[0], mask, *neg)
        assert abs(float(tl) - float(jl)) <= 5e-3


@pytest.mark.parametrize("base", ["sharded", "full"])
def test_lora_mesh_step_matches_jax_and_keeps_base(base):
    """The LoRA step over a mesh: adapters replicated, the base sharded (the
    delta split by the base matrix's rule in lora_merge) or full; 4 losses
    within 5e-3 of JAX's `make_lora_train_step(mesh=)`, the base bit-unchanged."""
    kw = dict(TKW, lora_rank=4, lora_alpha=8.0)
    jcfg, cfg, jmesh, mesh, jstate, state = _states("hd128", 2, seed=5)
    jbase = jstate.params if base == "sharded" else jax.device_get(jstate.params)
    tbase = state.params if base == "sharded" else unshard_params(state.params)
    before = [p.clone() for p in piece_leaves(tbase)]
    jl_state = JC.init_lora_train_state(jbase, JTrainConfig(**kw), jax.random.PRNGKey(6))
    lora = lora_from_jax(jax.device_get(jl_state.params), device="cpu")
    lstate = TrainState(lora, make_optimizer(TrainConfig(**kw)).init(lora), 0)
    jstep = JC.make_lora_train_step(jcfg, JTrainConfig(**kw), mesh=jmesh)
    step = PC.make_lora_train_step(cfg, TrainConfig(**kw), mesh=mesh, fused="on")
    q_ids, p_ids, mask = _template_task(4, vocab=cfg.vocab_size, seed=1)
    for i in range(4):
        jl_state, jl = jstep(jl_state, jbase, q_ids[i], mask, p_ids[i], mask)
        lstate, tl = step(lstate, tbase, q_ids[i], mask, p_ids[i], mask)
        assert abs(float(tl) - float(jl)) <= 5e-3, (i, float(tl), float(jl))
    for a, b in zip(piece_leaves(tbase), before):
        assert torch.equal(a, b)
    assert all(isinstance(a, torch.Tensor) and a.device == mesh.first_device
               for a in tree_leaves(lstate.params))          # replicated adapters


def test_sharded_checkpoint_moves_between_mesh_and_one_device(tmp_path):
    """A sharded state after two steps saves the file a single-device state
    writes; it restores into a single-device template bit-equal to its
    unsharded leaves, and back into a sharded template bit-equal piece for
    piece; the resumed mesh step gives the same loss."""
    jcfg, cfg, jmesh, mesh, jstate, state = _states("hd128", 2, seed=8)
    tcfg = TrainConfig(**TKW)
    step = PC.make_train_step(cfg, tcfg, mesh=mesh)
    q_ids, p_ids, mask = _template_task(3, vocab=cfg.vocab_size, seed=4)
    for i in range(2):
        state, _ = step(state, q_ids[i], mask, p_ids[i], mask)
    save_checkpoint(state, tmp_path / "mesh")
    one = PC.init_train_state(cfg, tcfg, generator=torch.Generator().manual_seed(1), device="cpu")
    restored = restore_checkpoint(tmp_path / "mesh", cfg, tcfg, template=one)
    assert restored.step == 2 and restored.opt_state.count == 2
    for tree, rtree in ((state.params, restored.params), (state.opt_state.mu, restored.opt_state.mu),
                        (state.opt_state.nu, restored.opt_state.nu)):
        for a, b in zip(tree_leaves(unshard_params(tree)), tree_leaves(rtree)):
            assert not isinstance(b, ShardedTensor) and a.dtype == b.dtype and torch.equal(a, b)
    save_checkpoint(restored, tmp_path / "one")
    a, b = np.load(tmp_path / "mesh" / "step_2.npz"), np.load(tmp_path / "one" / "step_2.npz")
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
        np.testing.assert_array_equal(a[k], b[k])
    template = PC.init_sharded_train_state(cfg, tcfg, mesh)
    back = restore_checkpoint(tmp_path / "one", cfg, tcfg, template=template)
    for x, y in zip(piece_leaves(back.params) + piece_leaves(back.opt_state.nu),
                    piece_leaves(state.params) + piece_leaves(state.opt_state.nu)):
        assert torch.equal(x, y)
    _, l1 = step(state, q_ids[2], mask, p_ids[2], mask)
    _, l2 = step(back, q_ids[2], mask, p_ids[2], mask)
    assert float(l1) == float(l2)


def test_dryrun_multichip_train_item_matches_the_reference():
    """`dryrun_multichip`'s train item (`entry._train_item`, what
    `dryrun_multichip(8, device="cpu")` runs on a (2, 4) mesh) from the
    reference's tiny weights (its init_sharded_train_state's draw, carried
    over and placed with `shard_train_state`): the loss within 5e-3 of the
    reference's item 1 on its (2, 4) mesh (`__graft_entry__.py:78-95`)."""
    jcfg, tcfg = JEncoderConfig.tiny(), JTrainConfig(batch_size=4, seq_len=16)
    jmesh = j_make_mesh(JMeshConfig(data=2, shard=4))
    jstate = JC.init_sharded_train_state(jcfg, tcfg, jmesh)
    carried = train_state_from_jax(jax.device_get(jstate), device="cpu")
    tok = JSimpleTokenizer(vocab_size=jcfg.vocab_size)
    q = tok([f"query {i}" for i in range(4)], pad_to=16)
    p = tok([f"positive {i}" for i in range(4)], pad_to=16)
    _, jl = JC.make_train_step(jcfg, tcfg, mesh=jmesh)(
        jstate, jnp.asarray(q.input_ids), jnp.asarray(q.attention_mask), jnp.asarray(p.input_ids),
        jnp.asarray(p.attention_mask))
    mesh = cpu_mesh(4, data=2)
    loss = _train_item(mesh, shard_train_state(carried, mesh, EncoderConfig.tiny()))
    assert np.isfinite(loss) and abs(loss - float(jl)) <= 5e-3, (loss, float(jl))
    # the JAX shard_params placement the step started from is the reference's own
    assert jstate.params["layers"][0]["wq"].sharding.spec == j_shard_params(
        jstate.params, jmesh)["layers"][0]["wq"].sharding.spec
