"""The port's deepseek tower (`encoder/deepseek.py`, the expert layer
`kernels/moe.py`) on the CPU, seeded, at tiny sizes: against the plain
reference of the benchmark (`portbench/reference/deepseek.py`, which
imports nothing of the port), its routing, padding, recorder and RoPE,
the expert layer's plain versions against a loop over pairs, the
checkpoint loader, and the dispatch through `BatchedEncoder`, the CLI and
the trainer. The kernels' card tests are in `tests/test_torch_moe_cuda.py`.
"""

import json
import sys
from argparse import Namespace
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from portbench import deepseek as bench  # noqa: E402
from portbench.reference import deepseek as reference  # noqa: E402
from portbench.reference.tokenizer import HashTokenizer  # noqa: E402
from theoremsearch_tpu_torch.encoder import deepseek as ds  # noqa: E402
from theoremsearch_tpu_torch.encoder.batching import BatchedEncoder  # noqa: E402
from theoremsearch_tpu_torch.kernels import moe  # noqa: E402

torch.set_num_threads(2)

# a dense layer and two expert layers, 8 experts, top 2, one shared expert
MODEL = dict(vocab_size=1000, hidden_size=64, num_hidden_layers=3, num_attention_heads=4,
             q_lora_rank=None, kv_lora_rank=32, qk_nope_head_dim=16, qk_rope_head_dim=8,
             v_head_dim=16, first_k_dense_replace=1, intermediate_size=128,
             moe_intermediate_size=64, n_routed_experts=8, num_experts_per_tok=2,
             n_shared_experts=1, routed_scaling_factor=2.446, norm_topk_prob=True,
             scoring_func="sigmoid", topk_method="noaux_tc", rope_theta=50000.0,
             rms_norm_eps=1e-5)
CFG = bench.program_config({**MODEL, "serving": {"max_seq_len": 64}})
TEXTS = ["every compact group admits a fixed point", "a",
         "the spectral gap of a regular graph is bounded by its degree and rank " * 3,
         "x_1 + \\alpha = 3.5, Lemma 2 holds for every prime p"]
# A pick more than this below the f32 reference's k-th biased score is a
# routing fault. The benchmark's check takes 0.1 after 27 full-width layers
# (loops/embed_slogans_routed.py); three tiny bf16 layers move the scores
# far less, so the test holds a tighter one.
TAU = 0.02


def _params(seed=7):
    return bench.make_params(MODEL, seed, "cpu")


def _f32(tree):
    if isinstance(tree, dict):
        return {k: _f32(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_f32(v) for v in tree]
    return tree.float()


def _batch(texts, width=64):
    seqs = [HashTokenizer(MODEL["vocab_size"]).ids(t, width) for t in texts]
    ids = torch.zeros((len(seqs), width), dtype=torch.long)
    mask = torch.zeros((len(seqs), width), dtype=torch.int32)
    for i, s in enumerate(seqs):
        ids[i, : len(s)] = torch.tensor(s)
        mask[i, : len(s)] = 1
    return seqs, ids, mask


def _split(picks, seqs):
    """The recorded (n_moe, T, k) picks as one (n_moe, len, k) a sequence."""
    out, at = [], 0
    for s in seqs:
        out.append(picks[:, at : at + len(s)])
        at += len(s)
    return out


def _cos_gap(a, b):
    a, b = a.double(), b.double()
    return float((1 - (a * b).sum(1) / (a.norm(dim=1) * b.norm(dim=1))).max())


# ---- the tower against the plain reference


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tower_matches_the_reference_under_forced_routing(dtype):
    """float32: the same equations, summed in other orders, so within 1e-5
    everywhere. bfloat16: the working type, against the float32 reference
    forced to the tower's own picks; three layers of bf16 activations keep
    1 - cos under 2e-4 (the tower reads ~2e-5 here; the benchmark cell's
    limit at full width is its own) and every element within 2e-2."""
    params = _params()
    seqs, ids, mask = _batch(TEXTS)
    rec = []
    with torch.no_grad():
        if dtype == "float32":
            got = ds.encode_pooled(_f32(params), ids, mask, CFG.replace(dtype="float32"), record=rec)
        else:
            got = ds.encode_pooled(params, ids, mask, CFG, record=rec)
    ref = reference.embed(params, MODEL, seqs, "f32", route=_split(rec[0], seqs))
    err = float((got - ref).abs().max())
    if dtype == "float32":
        assert err < 1e-5, err
    else:
        assert _cos_gap(got, ref) < 2e-4 and err < 2e-2, (_cos_gap(got, ref), err)


def test_own_routing_keeps_within_tau_of_the_reference():
    """Under its own routing every pick of the bf16 tower is the
    reference's, or within TAU of the reference's k-th biased score (bf16
    hidden states move near-ties only)."""
    params = _params(3)
    seqs, ids, mask = _batch(TEXTS)
    rec = []
    with torch.no_grad():
        ds.encode_pooled(params, ids, mask, CFG, record=rec)
    route = _split(rec[0], seqs)
    diag = []
    reference.embed(params, MODEL, seqs, "f32", route=route, diag=diag)
    k = MODEL["num_experts_per_tok"]
    for r, d in zip(route, diag):
        kth = d.topk(k, dim=-1).values[..., -1:]
        assert bool((d.gather(-1, r.long()) >= kth - TAU).all())


def test_lower_precisions_depart_from_float32():
    """The reference's bf16 and int8 modes (the control) under one routing
    differ from its float32 mode, the int8 one the most."""
    params = _params()
    seqs, ids, mask = _batch(TEXTS)
    rec = []
    with torch.no_grad():
        ds.encode_pooled(params, ids, mask, CFG, record=rec)
    route = _split(rec[0], seqs)
    f32 = reference.embed(params, MODEL, seqs, "f32", route=route)
    gaps = {m: _cos_gap(reference.embed(params, MODEL, seqs, m, route=route), f32)
            for m in ("bf16", "int8")}
    assert 0 < gaps["bf16"] < gaps["int8"] < 1e-2, gaps


def test_the_cells_check_sees_a_router_without_its_bias():
    """The benchmark cell end to end at tiny widths (`portbench.harness`,
    the routed loop, the reference), with its control: the sound run is
    correct; the program's router without e_score_correction_bias keeps
    every pick within TAU of the reference's k-th best, so only
    `route_miss_share` sees it, past the cell's limit and 3x the sound
    reading."""
    from portbench import harness

    cell = "moonlight-16b-a3b.embed-slogans"
    over = {"config": {"model": MODEL, "serving": {"max_seq_len": 64, "quant": "none"}},
            "params": {"slogans": 1024, "per_paper": 16, "chunk": 64, "sample": 16,
                       "slogan_words": {"median": 12, "p5": 4, "p95": 40, "min": 2, "max": 60}}}
    out = harness.run(cell, 7_000_000_123, 1.0, False, device="cpu", overrides=over,
                      control="reference")
    assert out["correct"], out["checks"]
    control = out["notes"]["control"]
    sound = out["checks"]["route_miss_share"]
    assert control["route_far_picks_unbiased"] == 0
    assert control["route_miss_share_unbiased"] > max(sound["limit"], 3 * sound["value"]), control


def test_padded_batch_rows_equal_each_sequence_alone():
    """Right padding changes no real row: the pads route nowhere (the
    routed tokens are the real ones) and each row, encoded with the others
    in a 64-wide batch, agrees with the sequence encoded alone at its own
    length, with the same picks."""
    params = _params()
    seqs, ids, mask = _batch(TEXTS)
    rec, counters = [], ds.MoECounters("cpu")
    with torch.no_grad():
        batch = ds.encode_pooled(params, ids, mask, CFG, record=rec, counters=counters)
        for i, s in enumerate(seqs):
            one_rec = []
            one = ds.encode_pooled(params, ids[i : i + 1, : len(s)], mask[i : i + 1, : len(s)],
                                   CFG, record=one_rec)
            assert _cos_gap(one, batch[i : i + 1]) < 2e-4
            assert torch.equal(one_rec[0], _split(rec[0], seqs)[i])
    n_real = sum(len(s) for s in seqs)
    got = counters.read()
    assert got["real_tokens"] == 2 * n_real
    assert got["pairs"] == 2 * n_real * MODEL["num_experts_per_tok"]


def test_recorder_changes_no_output_bit():
    params = _params()
    be = BatchedEncoder(params, CFG, device="cpu")
    plain = be.encode(TEXTS)
    be.start_routing_record()
    recorded = be.encode(TEXTS)
    recs = be.stop_routing_record()
    assert np.array_equal(plain, recorded)
    assert len(recs) == 1 and sorted(recs[0]["rows"]) == [0, 1, 2, 3]
    assert recs[0]["picks"].shape == (2, sum(recs[0]["lengths"]), 2)
    assert be.stop_routing_record() == []


def test_rope_rotates_adjacent_pairs():
    """Pair (2j, 2j + 1) turns by pos theta^(-2j/d), in HF's output order
    (the pairs' first elements, then their second)."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn((1, 5, 2, 8), generator=g)
    cos, sin = ds.rope_tables(5, 8, 50000.0, "cpu")
    got = ds.rope_adjacent(x, cos, sin)
    for pos in range(5):
        for j in range(4):
            ang = pos * 50000.0 ** (-2 * j / 8)
            a, b = x[0, pos, :, 2 * j].double(), x[0, pos, :, 2 * j + 1].double()
            want_a = a * np.cos(ang) - b * np.sin(ang)
            want_b = b * np.cos(ang) + a * np.sin(ang)
            assert torch.allclose(got[0, pos, :, j].double(), want_a, atol=1e-5)
            assert torch.allclose(got[0, pos, :, 4 + j].double(), want_b, atol=1e-5)
    # the qwen tower's pairs (i, i + d/2) are another rotation
    assert not torch.allclose(got[0, 3, :, 0], x[0, 3, :, 0] * cos[3, 0] - x[0, 3, :, 4] * sin[3, 0])


# ---- the expert layer's plain versions against a loop over the pairs


def _picks(load, t, e, k, g):
    if load == "spread":
        return torch.rand((t, e), generator=g).topk(k, dim=-1).indices
    top = torch.rand((t, e), generator=g).topk(k, dim=-1).indices
    if load == "one expert empty":
        return torch.where(top == 2, (top + 1) % e, top).clamp(max=e - 1)
    top[:, 0] = 5           # every token's first pick: expert 5 holds a row of every token
    top[:, 1:] = torch.where(top[:, 1:] == 5, 6, top[:, 1:])
    return top


@pytest.mark.parametrize("load", ["spread", "one expert empty", "one expert every row"])
def test_expert_layer_plain_matches_a_loop_over_pairs(load):
    g = torch.Generator().manual_seed(1)
    t, h, i, e, k = 37, 64, 64, 8, 2
    x = torch.randn((t, h), generator=g).bfloat16()
    wg, wu = torch.randn((e, i, h), generator=g).bfloat16() * 0.1, torch.randn((e, i, h), generator=g).bfloat16() * 0.1
    wd = torch.randn((e, h, i), generator=g).bfloat16() * 0.1
    top = _picks(load, t, e, k, g)
    w = torch.rand((t, k), generator=g)
    acc = torch.zeros(4, dtype=torch.int64)
    rows, offsets, inv = moe.route_plan(top, e, acc)
    cnt = (offsets[1:] - offsets[:-1]).tolist()
    assert sum(cnt) == t * k
    if load == "one expert empty":
        assert cnt[2] == 0
    if load == "one expert every row":
        assert cnt[5] == t
    assert acc.tolist() == [t * k, t, sum(c > 0 for c in cnt), max(cnt)]
    hh = moe.grouped_swiglu(x, rows, offsets, wg, wu)
    y = moe.grouped_down(hh, offsets, wd)
    shared = torch.randn((t, h), generator=g).bfloat16()
    base = torch.randn((t + 3, h), generator=g).bfloat16()
    tokens = torch.arange(3, t + 3, dtype=torch.int32)
    out = base.clone()
    moe.combine_into(out, tokens, y, inv, w, shared)
    for tt in range(t):
        acc_t = None
        for j in range(k):
            ex = int(top[tt, j])
            xf = x[tt].float()
            gate = (xf @ wg[ex].float().T).bfloat16()
            up = (xf @ wu[ex].float().T).bfloat16()
            hv = (F.silu(gate.float()).bfloat16().float() * up.float()).bfloat16()
            yv = (hv.float() @ wd[ex].float().T).bfloat16()
            assert torch.allclose(hh[inv[tt * k + j]].float(), hv.float(), atol=1e-2, rtol=1e-2)
            prod = yv.float() * w[tt, j]
            acc_t = prod if acc_t is None else acc_t + prod
        r = (acc_t.bfloat16().float() + shared[tt].float()).bfloat16()
        want = (base[tt + 3].float() + r.float()).bfloat16()
        assert torch.allclose(out[tt + 3].float(), want.float(), atol=2e-2, rtol=2e-2)
    assert torch.equal(out[:3], base[:3])


# ---- a checkpoint through --model-dir, and the dispatch


def _hf_checkpoint(path: Path, params) -> None:
    st = pytest.importorskip("safetensors.numpy")

    def a(t, transpose=False):
        t = t.float().T if transpose else t.float()
        return np.ascontiguousarray(t.numpy())

    tensors = {"model.embed_tokens.weight": a(params["embed"]),
               "model.norm.weight": a(params["final_norm"])}
    for li, layer in enumerate(params["layers"]):
        p = f"model.layers.{li}."
        tensors |= {p + "input_layernorm.weight": a(layer["attn_norm"]),
                    p + "post_attention_layernorm.weight": a(layer["mlp_norm"]),
                    p + "self_attn.q_proj.weight": a(layer["wq"], True),
                    p + "self_attn.kv_a_proj_with_mqa.weight": a(layer["wkv_a"], True),
                    p + "self_attn.kv_a_layernorm.weight": a(layer["kv_norm"]),
                    p + "self_attn.kv_b_proj.weight": a(layer["wkv_b"], True),
                    p + "self_attn.o_proj.weight": a(layer["wo"], True)}
        if "router" not in layer:
            tensors |= {p + f"mlp.{n}_proj.weight": a(layer[f"w_{n}"], True)
                        for n in ("gate", "up", "down")}
            continue
        tensors |= {p + "mlp.gate.weight": a(layer["router"]),
                    p + "mlp.gate.e_score_correction_bias": a(layer["router_bias"])}
        tensors |= {p + f"mlp.shared_experts.{n}_proj.weight": a(layer["shared"][f"w_{n}"], True)
                    for n in ("gate", "up", "down")}
        for e in range(MODEL["n_routed_experts"]):
            tensors |= {p + f"mlp.experts.{e}.{n}_proj.weight": a(layer[f"experts_{n}"][e])
                        for n in ("gate", "up", "down")}
    st.save_file(tensors, str(path / "model.safetensors"))
    hf = {k: v for k, v in MODEL.items()} | {
        "model_type": "deepseek_v3", "n_group": 1, "topk_group": 1, "rope_scaling": None,
        "moe_layer_freq": 1, "architectures": ["DeepseekV3ForCausalLM"]}
    (path / "config.json").write_text(json.dumps(hf))


def test_checkpoint_through_model_dir(tmp_path):
    """A synthetic deepseek_v3 safetensors checkpoint, detected and loaded
    through the CLI's `--model-dir` path: the same embeddings as the tower
    on the params it was written from."""
    from theoremsearch_tpu_torch.cli import _batched_encoder
    from theoremsearch_tpu_torch.encoder.loader import detect_family

    params = _params(5)
    _hf_checkpoint(tmp_path, params)
    assert detect_family(tmp_path) == "deepseek"
    be = _batched_encoder(Namespace(model_dir=str(tmp_path), device="cpu"))
    assert be.cfg.replace(max_seq_len=64) == CFG
    want = BatchedEncoder(params, CFG, device="cpu").encode(TEXTS)
    assert np.array_equal(be.encode(TEXTS), want)


def test_cli_embed_runs_the_hermetic_tower(tmp_path):
    """`embed --embedder deepseek` spools the catalog's slogans through the
    tiny tower, as for the other towers."""
    from theoremsearch_tpu_torch.cli import run
    from theoremsearch_tpu_torch.index.builder import IndexBuilder
    from theoremsearch_tpu_torch.ingest.catalog import Catalog

    cat = Catalog(str(tmp_path / "cat.db"))
    cat.conn.execute("INSERT INTO paper (paper_id, title, authors, link, primary_category, "
                     "citations) VALUES ('p0', 'P', '[]', 'l', 'math.AG', 0)")
    cat.conn.executemany("INSERT INTO theorem (theorem_id, paper_id, name, body, label, "
                         "parsing_method) VALUES (?, 'p0', ?, '', '', 'scanner')",
                         [(i + 1, f"Theorem {i}") for i in range(len(TEXTS))])
    cat.conn.executemany("INSERT INTO theorem_slogan (slogan_id, theorem_id, model, prompt_id, "
                         "slogan) VALUES (?, ?, 'stub', 'body-only-v1', ?)",
                         [(i + 1, i + 1, t) for i, t in enumerate(TEXTS)])
    cat.conn.commit()
    cat.close()
    spool = str(tmp_path / "spool")
    n = run(["--catalog", str(tmp_path / "cat.db"), "embed", "--embedder", "deepseek",
             "--device", "cpu", "--spool", spool])
    assert n == len(TEXTS)
    ids, emb = map(np.concatenate, zip(*IndexBuilder(spool).batches()))
    assert sorted(ids.tolist()) == [1, 2, 3, 4]
    assert emb.shape == (4, ds.DeepseekEncoderConfig.tiny().embedding_dim)
    assert np.allclose(np.linalg.norm(emb, axis=1), 1.0, atol=1e-5)


def test_dispatch_and_what_the_tower_refuses():
    from theoremsearch_tpu_torch.core.config import EncoderConfig, TrainConfig
    from theoremsearch_tpu_torch.encoder import model
    from theoremsearch_tpu_torch.encoder.towers import routes_real_tokens, tower_module
    from theoremsearch_tpu_torch.train.contrastive import init_train_state

    tiny = ds.DeepseekEncoderConfig.tiny()
    assert tower_module(tiny) is ds and routes_real_tokens(tiny)
    assert tower_module(EncoderConfig.tiny()) is model and not routes_real_tokens(EncoderConfig())
    params = ds.init_params(tiny, torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(ValueError, match="int8"):
        BatchedEncoder(params, tiny, quant="int8", device="cpu")
    seqs, ids, mask = _batch(TEXTS[:1])
    with pytest.raises(ValueError, match="inference only"):
        ds.encode_pooled(params, ids, mask, tiny)
    with pytest.raises(ValueError, match="inference only"):
        init_train_state(tiny, TrainConfig(), device="cpu")
    with pytest.raises(ValueError, match="q_lora_rank"):
        ds.DeepseekEncoderConfig(q_lora_rank=1536)
