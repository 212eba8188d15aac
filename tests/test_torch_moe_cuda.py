"""The grouped expert kernels (`csrc/moe.cu`) against their plain versions
at Moonlight-16B-A3B's widths, and the deepseek tower's forward on the card
without a read back to the host. Marked `cuda`: they skip without a card.
This file imports no jax, so it also runs on a machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_moe_cuda.py -q
"""

import numpy as np
import pytest
import torch

from theoremsearch_tpu_torch.kernels import moe

H, I, E, K = 2048, 1408, 64, 6


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


def _uneven_picks(t: int, seed: int, dev) -> torch.Tensor:
    """(T, K) distinct experts a token, drawn with Zipf-like weights: a few
    experts take most rows, expert 5 none, expert 0 one in two tokens."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    w = 1.0 / torch.arange(1, E + 1, dtype=torch.float64) ** 1.2
    w[5] = 0.0
    top = torch.multinomial(w.expand(t, E).contiguous(), K, replacement=False, generator=g)
    return top.to(dev)


def _case(dev, t: int, seed: int):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((t, H), generator=g, device=dev).to(torch.bfloat16)
    wg, wu = (torch.randn((E, I, H), generator=g, device=dev, dtype=torch.bfloat16) * 0.02
              for _ in range(2))
    wd = torch.randn((E, H, I), generator=g, device=dev, dtype=torch.bfloat16) * 0.02
    return x, wg, wu, wd, _uneven_picks(t, seed, dev)


def _close(got: torch.Tensor, want: torch.Tensor, what: str) -> None:
    """The kernel sums its products in another order than the plain
    version's f32 GEMM, so after the bf16 rounding a small share of the
    outputs differ, each by about an ulp of bf16: at most 2% of them, by
    at most 2% of the largest."""
    diff = (got.float() - want.float()).abs()
    scale = float(want.float().abs().max())
    share = float((diff > 0).float().mean())
    assert float(diff.max()) <= 2e-2 * scale, (what, float(diff.max()), scale)
    assert share <= 0.02, (what, share)


@pytest.mark.cuda
@pytest.mark.parametrize("t", [4096, 24_000], ids=["64-wide", "512-wide"])
def test_grouped_kernels_match_plain(cuda, t):
    x, wg, wu, wd, top = _case(cuda, t, seed=t)
    acc = torch.zeros(4, dtype=torch.int64, device=cuda)
    n_plan, n_comb = moe.plan_launches.n, moe.combine_launches.n
    rows, offsets, inv = moe.route_plan(top, E, acc)
    assert moe.plan_launches.n - n_plan == 1
    keys = torch.sort(top.reshape(-1).to(torch.int32), stable=True).values
    acc_plain = torch.zeros(4, dtype=torch.int64, device=cuda)
    assert torch.equal(offsets, moe.route_offsets_plain(keys, E, t, acc_plain))
    assert torch.equal(acc, acc_plain)
    cnt = (offsets[1:] - offsets[:-1]).tolist()
    assert cnt[5] == 0 and max(cnt) > 4 * t * K / E, cnt
    n0 = moe.grouped_launches.n
    h = moe.grouped_swiglu(x, rows, offsets, wg, wu)
    y = moe.grouped_down(h, offsets, wd)
    torch.cuda.synchronize()
    assert moe.grouped_launches.n - n0 == 2
    _close(h, moe.grouped_swiglu_plain(x, rows, offsets, wg, wu), "gate/up")
    _close(y, moe.grouped_down_plain(h, offsets, wd), "down")
    # repeats are bit-equal
    assert torch.equal(h, moe.grouped_swiglu(x, rows, offsets, wg, wu))
    assert torch.equal(y, moe.grouped_down(h, offsets, wd))
    # the combine: the plain version's bits
    g = torch.Generator(device=cuda).manual_seed(1)
    w = torch.rand((t, K), generator=g, device=cuda)
    shared = (torch.randn((t, H), generator=g, device=cuda) * 0.1).to(torch.bfloat16)
    tokens = torch.randperm(2 * t, generator=g, device=cuda)[:t].to(torch.int32)
    base = torch.randn((2 * t, H), generator=g, device=cuda).to(torch.bfloat16)
    xk, xp = base.clone(), base.clone()
    moe.combine_into(xk, tokens, y, inv, w, shared)
    moe.combine_into_plain(xp, tokens, y, inv, w, shared)
    assert torch.equal(xk, xp) and moe.combine_launches.n - n_comb == 1


@pytest.mark.cuda
def test_an_expert_holding_every_row(cuda):
    """All pairs on one expert of each token's k (expert 3 first), the
    other picks spread: the busiest expert's rows span many tiles."""
    x, wg, wu, wd, top = _case(cuda, 1000, seed=3)
    top = torch.where(top == 3, top[:, :1], top)
    top[:, 0] = 3
    rows, offsets, _ = moe.route_plan(top, E)
    h = moe.grouped_swiglu(x, rows, offsets, wg, wu)
    _close(h, moe.grouped_swiglu_plain(x, rows, offsets, wg, wu), "gate/up")
    _close(moe.grouped_down(h, offsets, wd), moe.grouped_down_plain(h, offsets, wd), "down")


def _tower(dev, layers=3):
    from theoremsearch_tpu_torch.encoder.deepseek import DeepseekEncoderConfig, init_params

    cfg = DeepseekEncoderConfig(num_layers=layers)
    return cfg, init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)


@pytest.mark.cuda
def test_tower_forward_reads_nothing_back(cuda):
    """The tower at Moonlight's widths (a dense layer and two expert
    layers) through `BatchedEncoder`'s forward at each width bucket under
    sync debug mode "error": no op of the forward waits for the card. Two
    grouped launches an expert layer a sub-batch."""
    from theoremsearch_tpu_torch.encoder.batching import BatchedEncoder

    cfg, params = _tower(cuda)
    be = BatchedEncoder(params, cfg, device=cuda)
    rng = np.random.default_rng(0)
    for w in be.buckets:
        ids = rng.integers(3, cfg.vocab_size, (64, w)).astype(np.int32)
        lengths = rng.integers(max(2, w // 2), w + 1, 64)
        mask = (np.arange(w)[None] < lengths[:, None]).astype(np.int32)
        ids_mask = np.stack([ids * mask, mask]).astype(np.int32)
        be._forward(ids_mask, 64, list(range(64)))     # warm: the library, the allocator
        torch.cuda.synchronize()
        n0 = moe.grouped_launches.n
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = be._forward(ids_mask, 64, list(range(64)))
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        assert moe.grouped_launches.n - n0 == 2 * cfg.n_moe_layers
        assert torch.isfinite(out).all()
    stats = be.stats()["moe"]
    assert sorted(stats) == list(be.buckets)
    assert all(s["launches"] == 2 * 2 * cfg.n_moe_layers for s in stats.values())


@pytest.mark.cuda
def test_tower_against_the_reference_under_its_routing(cuda):
    """The bf16 tower at Moonlight's widths against the float32 reference
    forced to the tower's own recorded routing: 1 - cos within the cell's
    limit (1e-3); the picks all within the cell's TAU of the reference's
    own 6th best."""
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    from portbench.reference import deepseek as reference
    from portbench.reference.tokenizer import HashTokenizer
    from theoremsearch_tpu_torch.encoder.batching import BatchedEncoder

    cfg, params = _tower(cuda)
    be = BatchedEncoder(params, cfg, device=cuda)
    texts = ["every compact group admits a fixed point " * r for r in (1, 3, 9, 27, 50)]
    be.start_routing_record()
    got = torch.from_numpy(be.encode(texts)).to(cuda)
    recs = be.stop_routing_record()
    route = {}
    for rec in recs:
        at = 0
        for i, n in zip(rec["rows"], rec["lengths"]):
            route[i] = rec["picks"][:, at : at + n].cpu()
            at += n
    model = {"hidden_size": cfg.hidden_size, "num_attention_heads": cfg.num_heads,
             "kv_lora_rank": cfg.kv_lora_rank, "qk_nope_head_dim": cfg.qk_nope_head_dim,
             "qk_rope_head_dim": cfg.qk_rope_head_dim, "v_head_dim": cfg.v_head_dim,
             "rms_norm_eps": cfg.rms_norm_eps, "rope_theta": cfg.rope_theta,
             "first_k_dense_replace": cfg.first_k_dense_replace,
             "num_hidden_layers": cfg.num_layers, "num_experts_per_tok": K,
             "n_routed_experts": E, "norm_topk_prob": True,
             "routed_scaling_factor": cfg.routed_scaling_factor}
    seqs = [HashTokenizer(cfg.vocab_size).ids(t, cfg.max_seq_len) for t in texts]
    assert [len(sq) for sq in seqs] == [route[i].shape[1] for i in range(len(texts))]
    diag = []
    ref = reference.embed(params, model, seqs, "f32", cuda, route=[route[i] for i in range(len(texts))],
                          diag=diag)
    assert float((1 - (got * ref).sum(1)).max()) < 1e-3
    for i, d in enumerate(diag):
        kth = d.topk(K, dim=-1).values[..., -1:]
        assert bool((d.gather(-1, route[i].long()) >= kth - 0.02).all())
