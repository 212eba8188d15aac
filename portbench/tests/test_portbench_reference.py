"""The plain reference against the port's own float32 path at tiny sizes
(the test may import the port; the reference may not), and the exact
top-k against a brute-force one. Card cases decide inside the test."""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from portbench import weights  # noqa: E402
from portbench.reference import search, towers  # noqa: E402
from portbench.reference.tokenizer import HashTokenizer  # noqa: E402

QWEN = dict(hidden_size=64, intermediate_size=96, num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, head_dim=16, vocab_size=1000, rms_norm_eps=1e-6,
            rope_theta=1e6)
BERT = dict(hidden_size=48, intermediate_size=96, num_hidden_layers=2, num_attention_heads=4,
            vocab_size=1000, type_vocab_size=2, layer_norm_eps=1e-12, hidden_act="gelu")
TEXTS = ["every compact group admits a fixed point", "a", "the spectral gap of a regular graph "
         "is bounded by its degree and rank " * 3]


def _f32(params):
    out = {k: v.float() for k, v in params.items() if k != "layers"}
    out["layers"] = [{k: v.float() for k, v in layer.items()} for layer in params["layers"]]
    return out


def _batch(seqs, width):
    ids = torch.zeros((len(seqs), width), dtype=torch.long)
    mask = torch.zeros((len(seqs), width), dtype=torch.int32)
    for i, s in enumerate(seqs):
        ids[i, : len(s)] = torch.tensor(s)
        mask[i, : len(s)] = 1
    return ids, mask


def _port(family, model, device):
    from theoremsearch_tpu_torch.core.config import BertEncoderConfig, EncoderConfig

    if family == "qwen":
        from theoremsearch_tpu_torch.encoder import model as mod

        cfg = EncoderConfig(vocab_size=1000, hidden_size=64, intermediate_size=96, num_layers=2,
                            num_heads=4, num_kv_heads=2, head_dim=16, max_seq_len=64,
                            embedding_dim=64, dtype="float32", param_dtype="float32")
    else:
        from theoremsearch_tpu_torch.encoder import bert as mod

        cfg = BertEncoderConfig(vocab_size=1000, hidden_size=48, intermediate_size=96,
                                num_layers=2, num_heads=4, max_seq_len=64, embedding_dim=48,
                                dtype="float32", param_dtype="float32")
    return mod, cfg


@pytest.mark.parametrize("family", ["qwen", "bert"])
def test_reference_tower_matches_port_float32(family):
    model = QWEN if family == "qwen" else BERT
    params = weights.make_params(model, family, 64, 7, "cpu")
    tok = HashTokenizer(1000)
    seqs = [tok.ids(t, 64) for t in TEXTS]
    ref = towers.embed(params, model, family, seqs, "f32")
    mod, cfg = _port(family, model, "cpu")
    ids, mask = _batch(seqs, 64)
    kw = {"fused": "off"} if family == "qwen" else {}
    port = mod.encode_pooled(_f32(params), ids, mask, cfg, **kw)
    assert torch.allclose(port, ref, atol=2e-6), (port - ref).abs().max()


@pytest.mark.parametrize("family", ["qwen", "bert"])
def test_lower_precisions_depart_from_float32(family):
    model = QWEN if family == "qwen" else BERT
    params = weights.make_params(model, family, 64, 7, "cpu")
    seqs = [HashTokenizer(1000).ids(t, 64) for t in TEXTS]
    ref = towers.embed(params, model, family, seqs, "f32")
    for mode in ("bf16", "int8"):
        low = towers.embed(params, model, family, seqs, mode)
        gap = float((1 - (low * ref).sum(1)).max())
        assert 0 < gap < 1e-2, (mode, gap)


def test_padding_in_blocks_changes_nothing():
    params = weights.make_params(QWEN, "qwen", 64, 3, "cpu")
    seqs = [HashTokenizer(1000).ids(t, 64) for t in TEXTS]
    whole = towers.embed(params, QWEN, "qwen", seqs, "f32")
    one_by_one = torch.cat([towers.embed(params, QWEN, "qwen", [s], "f32") for s in seqs])
    assert torch.allclose(whole, one_by_one, atol=1e-6)


def test_tokenizer_copy_matches_port():
    from theoremsearch_tpu_torch.encoder.tokenizer import SimpleTokenizer

    port = SimpleTokenizer(vocab_size=151_669)
    ours = HashTokenizer(151_669)
    for t in TEXTS + ["x_1 + \\alpha = 3.5, Lemma 2"]:
        enc = port([t], max_length=512)
        n = int(enc.attention_mask.sum())
        assert ours.ids(t, 512) == enc.input_ids[0, :n].tolist()


def test_exact_topk_in_blocks_matches_brute_force():
    g = torch.Generator().manual_seed(0)
    x = torch.randn((5000, 32), generator=g)
    q = torch.randn((7, 32), generator=g)

    def blocks():
        for lo in range(0, 5000, 1024):
            yield lo, x[lo : lo + 1024]

    s, i = search.exact_topk(q, blocks, 10)
    bs, bi = torch.topk(q @ x.T, 10, dim=1)
    assert torch.equal(i, bi) and torch.allclose(s, bs)
    qb, scale = search.int8_blocks(blocks)
    y = torch.cat([b for _, b in qb()])
    assert scale == pytest.approx(float(x.abs().max()) / 127.0)
    assert float((y - x).abs().max()) <= scale / 2 + 1e-6


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["qwen", "bert"])
def test_reference_on_card_matches_cpu(family):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    model = QWEN if family == "qwen" else BERT
    params = weights.make_params(model, family, 64, 7, "cpu")
    seqs = [HashTokenizer(1000).ids(t, 64) for t in TEXTS]
    cpu = towers.embed(params, model, family, seqs, "f32")
    dev = {k: (v.cuda() if k != "layers" else [{a: b.cuda() for a, b in l.items()} for l in v])
           for k, v in params.items()}
    card = towers.embed(dev, model, family, seqs, "f32")
    assert np.allclose(card.cpu().numpy(), cpu.numpy(), atol=1e-5)
