"""Port parity: contrastive training (InfoNCE, the train steps, LoRA, the
optimizer) against the JAX reference on the CPU. The JAX weights and
adapters are carried over; the token batches come from numpy seeds. The
encoder has head_dim 128, so "on" reaches the fused core (kernel B7's
plain version here; the reference's Pallas kernels in interpret mode)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from theoremsearch_tpu.core.config import EncoderConfig as JEncoderConfig
from theoremsearch_tpu.core.config import TrainConfig as JTrainConfig
from theoremsearch_tpu.encoder.model import init_params as j_init_params
from theoremsearch_tpu.train import contrastive as JC
from theoremsearch_tpu.train.lora import lora_merge as j_lora_merge
from theoremsearch_tpu_torch.core.config import EncoderConfig, TrainConfig
from theoremsearch_tpu_torch.encoder.batching import BatchedEncoder
from theoremsearch_tpu_torch.encoder.model import params_from_jax
from theoremsearch_tpu_torch.train import contrastive as PC
from theoremsearch_tpu_torch.train.contrastive import (
    AdamW,
    TrainState,
    info_nce_loss,
    make_lora_train_step,
    make_optimizer,
    make_train_step,
    train_state_from_jax,
    tree_leaves,
)
from theoremsearch_tpu_torch.train.lora import lora_from_jax, lora_merge

from torch_helpers import cpu_mesh

torch.set_num_threads(2)

CFG = dict(vocab_size=1024, hidden_size=256, intermediate_size=512, num_layers=2, num_heads=2,
           num_kv_heads=1, head_dim=128, max_seq_len=64, embedding_dim=256)
JFUSED = {"off": "off", "on": "interpret"}
B, S = 8, 32


def _params(seed=0):
    jp = j_init_params(JEncoderConfig(**CFG), jax.random.PRNGKey(seed))
    return jp, params_from_jax(jax.device_get(jp), device="cpu")


def _template_task(steps, vocab=1024, seed=0):
    """tools/train_bench.py's synthetic task: every row the same template,
    pair identity in a few tokens, full masks."""
    rng = np.random.default_rng(seed)
    template = rng.integers(3, vocab, S).astype(np.int32)
    ident = max(2, S // 16)
    q_ids = np.broadcast_to(template, (steps, B, S)).copy()
    p_ids = q_ids.copy()
    tok = rng.integers(3, vocab, (steps, B, ident))
    q_ids[:, :, 1 : 1 + ident] = tok
    p_ids[:, :, 2 : 2 + ident] = tok
    return q_ids, p_ids, np.ones((B, S), np.int32)


def _cos(a, b):
    a = np.asarray(a, np.float64).ravel()
    b = np.asarray(b, np.float64).ravel()
    return float(a @ b / max(np.linalg.norm(a) * np.linalg.norm(b), 1e-30))


@pytest.mark.parametrize("fused,negatives", [("off", False), ("off", True), ("on", True)])
def test_info_nce_loss_and_grads_match_jax(fused, negatives):
    jp, tp = _params()
    rng = np.random.default_rng(3)
    ids = rng.integers(3, 1024, (3, B, S)).astype(np.int32)
    lens = rng.integers(S // 2, S + 1, (3, B))
    masks = (np.arange(S)[None, None] < lens[..., None]).astype(np.int32)
    neg = (ids[2, :4], masks[2, :4]) if negatives else (None, None)
    jcfg, cfg = JEncoderConfig(**CFG), EncoderConfig(**CFG)
    jl, jg = jax.jit(jax.value_and_grad(JC.info_nce_loss), static_argnums=(5, 6, 7))(
        jp, ids[0], masks[0], ids[1], masks[1], jcfg, 1.0, JFUSED[fused],
        *(None if x is None else jnp.asarray(x) for x in neg))
    leaves = tree_leaves(tp)
    for t in leaves:
        t.requires_grad_(True)
    t_ = lambda x: None if x is None else torch.from_numpy(x)  # noqa: E731
    loss = info_nce_loss(tp, t_(ids[0]), t_(masks[0]), t_(ids[1]), t_(masks[1]), cfg, 1.0, fused,
                         *(t_(x) for x in neg))
    grads = torch.autograd.grad(loss, leaves)
    assert abs(float(loss) - float(jl)) <= 2e-3, (float(loss), float(jl))
    jleaves = jax.tree.leaves(jg)
    assert len(jleaves) == len(grads)
    for i, (a, b) in enumerate(zip(grads, jleaves)):
        assert a.dtype == leaves[i].dtype
        assert _cos(a.float().numpy(), np.asarray(b, np.float32)) >= 0.999, i


@pytest.mark.parametrize("fused", ["off", "on"])
def test_twenty_step_loss_trajectory_matches_jax(fused):
    """20 full steps (forward, backward, clip, adamw) from the same
    weights on one batch of the template task: every loss within 5e-3 of
    JAX's. (Fresh identity tokens each step make the loss jump from step
    to step, and any rounding difference then moves it by more.)"""
    steps = 20
    q_ids, p_ids, mask = _template_task(1)
    jtcfg = JTrainConfig(batch_size=B, seq_len=S, learning_rate=1e-3, temperature=1.0)
    tcfg = TrainConfig(batch_size=B, seq_len=S, learning_rate=1e-3, temperature=1.0)
    jp, tp = _params()
    jstate = JC.TrainState(jp, JC.make_optimizer(jtcfg).init(jp), jnp.zeros((), jnp.int32))
    jstep = JC.make_train_step(JEncoderConfig(**CFG), jtcfg, fused=JFUSED[fused])
    state = TrainState(tp, make_optimizer(tcfg).init(tp), 0)
    step = make_train_step(EncoderConfig(**CFG), tcfg, fused=fused)
    jl, tl = [], []
    for _ in range(steps):
        jstate, loss = jstep(jstate, q_ids[0], mask, p_ids[0], mask)
        jl.append(float(loss))
        state, loss = step(state, q_ids[0], mask, p_ids[0], mask)
        assert loss.dim() == 0
        tl.append(float(loss))
    assert state.step == steps and state.opt_state.count == steps
    assert jl[-1] < jl[0]
    np.testing.assert_allclose(tl, jl, rtol=0, atol=5e-3)


GEMMA = dict(vocab_size=1024, hidden_size=256, intermediate_size=384, num_layers=2, num_heads=2,
             num_kv_heads=1, head_dim=256, global_every=2, max_seq_len=64, head_hidden=256,
             embedding_dim=256, query_pre_attn_scalar=256.0)


@pytest.mark.parametrize("family,fused", [("gemma", "on"), ("gemma", "off"), ("bert", "off")])
def test_other_towers_loss_trajectory_matches_jax(family, fused):
    """10 full steps of the gemma tower (head_dim 256: "on" runs the fused
    core, B2's plain version forward and autograd through the reference
    composition backward; the reference's Pallas forward in interpret mode
    and jax.vjp of its composition) and of the tiny BERT tower, from the
    same weights on one batch of the template task: every loss within
    5e-3 of JAX's. BERT runs in f32: its f32 biases get their gradients
    through bf16 casts and bf16 sums over every token, some of them
    (bk, whose true gradient is 0) pure rounding noise, which AdamW
    scales to full lr-sized steps; in bf16 the two trajectories part by
    ~1e-2 within six steps."""
    from theoremsearch_tpu.core.config import BertEncoderConfig as JBertConfig
    from theoremsearch_tpu.core.config import GemmaEncoderConfig as JGemmaConfig
    from theoremsearch_tpu.encoder.families import family_module as j_family
    from theoremsearch_tpu_torch.core.config import BertEncoderConfig, GemmaEncoderConfig

    if family == "gemma":
        jcfg, cfg = JGemmaConfig(**GEMMA), GemmaEncoderConfig(**GEMMA)
    else:
        f32 = dict(dtype="float32", param_dtype="float32")
        jcfg = JBertConfig(**{**JBertConfig.tiny().__dict__, **f32})
        cfg = BertEncoderConfig(**{**BertEncoderConfig.tiny().__dict__, **f32})
    steps = 10
    q_ids, p_ids, mask = _template_task(1, vocab=cfg.vocab_size)
    jtcfg = JTrainConfig(batch_size=B, seq_len=S, learning_rate=1e-3, temperature=1.0)
    tcfg = TrainConfig(batch_size=B, seq_len=S, learning_rate=1e-3, temperature=1.0)
    jp = j_family(jcfg).init_params(jcfg, jax.random.PRNGKey(6))
    state = PC.train_state_from_jax(jax.device_get(
        JC.TrainState(jp, JC.make_optimizer(jtcfg).init(jp), jnp.zeros((), jnp.int32))), device="cpu")
    jstate = JC.TrainState(jp, JC.make_optimizer(jtcfg).init(jp), jnp.zeros((), jnp.int32))
    jstep = JC.make_train_step(jcfg, jtcfg, fused=JFUSED[fused])
    step = make_train_step(cfg, tcfg, fused=fused)
    jl, tl = [], []
    for _ in range(steps):
        jstate, loss = jstep(jstate, q_ids[0], mask, p_ids[0], mask)
        jl.append(float(loss))
        state, loss = step(state, q_ids[0], mask, p_ids[0], mask)
        tl.append(float(loss))
    assert jl[-1] < jl[0] and state.step == steps
    np.testing.assert_allclose(tl, jl, rtol=0, atol=5e-3)


def test_lora_step_matches_jax_and_keeps_base():
    steps = 4
    q_ids, p_ids, mask = _template_task(steps, seed=1)
    kw = dict(batch_size=B, seq_len=S, learning_rate=1e-3, temperature=1.0, lora_rank=4,
              lora_alpha=8.0)
    jtcfg, tcfg = JTrainConfig(**kw), TrainConfig(**kw)
    jp, tp = _params(seed=2)
    base = {k: v.clone() for k, v in tp["layers"][0].items()}
    jstate = JC.init_lora_train_state(jp, jtcfg, jax.random.PRNGKey(5))
    lora = lora_from_jax(jax.device_get(jstate.params), device="cpu")
    state = TrainState(lora, make_optimizer(tcfg).init(lora), 0)
    jstep = JC.make_lora_train_step(JEncoderConfig(**CFG), jtcfg)
    step = make_lora_train_step(EncoderConfig(**CFG), tcfg, fused="off")
    for i in range(steps):
        jstate, jl = jstep(jstate, jp, q_ids[i], mask, p_ids[i], mask)
        state, tl = step(state, tp, q_ids[i], mask, p_ids[i], mask)
        assert abs(float(tl) - float(jl)) <= 5e-3, (i, float(tl), float(jl))
    for k, v in tp["layers"][0].items():
        assert torch.equal(v, base[k]), k
    # lora_merge on JAX's trained adapters agrees with JAX's own merge
    jm = j_lora_merge(jp, jstate.params, jtcfg.lora_alpha)
    tm = lora_merge(tp, lora_from_jax(jax.device_get(jstate.params), device="cpu"), tcfg.lora_alpha)
    for name in ("wq", "wv"):
        a = tm["layers"][1][name].float().numpy()
        b = np.asarray(jm["layers"][1][name], np.float32)
        assert np.all(np.abs(a - b) <= np.abs(b) * 2.0 ** -7), name   # within one bf16 ulp


def test_train_state_from_jax_resumes_the_trajectory():
    """Two JAX steps, then the state carried over: the next three losses
    match JAX's."""
    q_ids, p_ids, mask = _template_task(5, seed=2)
    jtcfg = JTrainConfig(batch_size=B, seq_len=S, learning_rate=1e-3, temperature=1.0)
    tcfg = TrainConfig(batch_size=B, seq_len=S, learning_rate=1e-3, temperature=1.0)
    jcfg = JEncoderConfig(**CFG)
    jp, _ = _params(seed=3)
    jstate = JC.TrainState(jp, JC.make_optimizer(jtcfg).init(jp), jnp.zeros((), jnp.int32))
    jstep = JC.make_train_step(jcfg, jtcfg)
    for i in range(2):
        jstate, _ = jstep(jstate, q_ids[i], mask, p_ids[i], mask)
    state = train_state_from_jax(jax.device_get(jstate), device="cpu")
    assert state.step == 2 and state.opt_state.count == 2
    mu0 = tree_leaves(state.opt_state.mu)
    assert mu0[0].dtype == torch.bfloat16 and mu0[1].dtype == torch.float32
    step = make_train_step(EncoderConfig(**CFG), tcfg, fused="off")
    for i in range(2, 5):
        jstate, jl = jstep(jstate, q_ids[i], mask, p_ids[i], mask)
        state, tl = step(state, q_ids[i], mask, p_ids[i], mask)
        assert abs(float(tl) - float(jl)) <= 5e-3, (i, float(tl), float(jl))


def _ulps(a: np.ndarray, b: np.ndarray, dtype) -> float:
    """Largest difference in units of the last place of `dtype` at b."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    mant = 7 if dtype == "bfloat16" else 23
    e = np.floor(np.log2(np.maximum(np.abs(b), 1e-38)))
    return float(np.max(np.abs(a - b) / 2.0 ** (e - mant)))


@pytest.mark.parametrize("scale", [0.05, 20.0])
def test_optimizer_update_matches_optax(scale):
    """One update from a nonzero optimizer state, with the gradients'
    global norm below (0.05) and above (20) the clip's max_norm of 1: the
    params and both moments within one ulp of optax's, f32 and bf16.
    optax runs op by op here, each op rounding to its dtype as the port's
    do; under jit, XLA on the CPU fuses the chain (one rounding for a bf16
    chain, fused multiply-adds in f32), which moves a moment that nearly
    cancels by more than an ulp of its own small value."""
    rng = np.random.default_rng(int(scale * 100))

    def tree(fn):
        return {"embed": fn((64, 32), jnp.bfloat16), "final_norm": fn((32,), jnp.float32),
                "layers": [{"w": fn((32, 48), jnp.bfloat16), "n": fn((48,), jnp.float32)}]}

    def draw(shape, dtype, s=1.0):
        return jnp.asarray(rng.standard_normal(shape) * s, dtype)

    jp = tree(draw)
    g0 = tree(lambda sh, dt: draw(sh, dt, 0.3))
    g1 = tree(lambda sh, dt: draw(sh, dt, 1.0))
    norm = float(optax.global_norm(g1))
    g1 = jax.tree.map(lambda x: (x.astype(jnp.float32) * (scale / norm)).astype(x.dtype), g1)
    tcfg = JTrainConfig(learning_rate=1e-3, weight_decay=0.01)
    opt = JC.make_optimizer(tcfg)
    st = opt.init(jp)
    upd, st = jax.jit(opt.update)(g0, st, jp)             # a nonzero state to start from
    jp = optax.apply_updates(jp, upd)
    tstate = train_state_from_jax(
        jax.device_get(JC.TrainState(jp, st, jnp.ones((), jnp.int32))), device="cpu")
    upd, st2 = opt.update(g1, st, jp)
    jp2 = optax.apply_updates(jp, upd)
    popt = make_optimizer(TrainConfig(learning_rate=1e-3, weight_decay=0.01))
    assert isinstance(popt, AdamW)
    params = tree_leaves(tstate.params)
    grads = [t.clone() for t in tree_leaves(params_from_jax(jax.device_get(g1), device="cpu"))]
    new = popt.update(grads, tstate.opt_state, params)
    assert new.count == 2
    assert (float(popt.global_norm(grads)) >= 1.0) == (scale > 1)
    jadam = st2[1][0]
    for name, mine, ref in (("params", params, jax.tree.leaves(jp2)),
                            ("mu", tree_leaves(new.mu), jax.tree.leaves(jadam.mu)),
                            ("nu", tree_leaves(new.nu), jax.tree.leaves(jadam.nu))):
        for i, (a, b) in enumerate(zip(mine, ref)):
            dt = "bfloat16" if a.dtype == torch.bfloat16 else "float32"
            assert str(np.asarray(b).dtype) == dt
            assert _ulps(a.float().numpy(), np.asarray(b, np.float32), dt) <= 1.0, (name, i)


def test_multi_device_and_unported_towers_raise():
    """A mesh trains and encodes (the dp + tp step, tests/test_torch_tp_train.py);
    the int8 encoder refuses a tp mesh ("dp-only", as the reference) and the
    steps refuse an unknown fused mode."""
    from theoremsearch_tpu_torch.encoder.sharding import ShardedTensor

    cfg, tcfg = EncoderConfig(**CFG), TrainConfig(batch_size=4, seq_len=16)
    mesh = cpu_mesh(2, data=2)
    state = PC.init_sharded_train_state(cfg, tcfg, mesh)
    assert isinstance(state.params["layers"][0]["wq"], ShardedTensor)
    assert isinstance(tree_leaves(state.opt_state.mu)[0], ShardedTensor)
    ids = np.arange(3, 3 + 4 * 16, dtype=np.int32).reshape(4, 16)
    mask = np.ones((4, 16), np.int32)
    state, loss = make_train_step(cfg, tcfg, mesh=mesh)(state, ids, mask, ids[::-1].copy(), mask)
    assert np.isfinite(float(loss)) and state.step == 1
    assert callable(make_lora_train_step(cfg, tcfg, mesh=mesh))
    _, tp = _params()
    out = BatchedEncoder(tp, cfg, mesh=cpu_mesh(2)).encode(["a theorem", "a lemma"])
    assert out.shape == (2, cfg.embedding_dim)
    with pytest.raises(ValueError, match="dp-only"):
        BatchedEncoder(tp, cfg, mesh=cpu_mesh(2), quant="int8")
    for fn in (make_train_step, make_lora_train_step):
        with pytest.raises(ValueError, match="fused"):
            fn(cfg, tcfg, mesh=mesh, fused="interpret")
