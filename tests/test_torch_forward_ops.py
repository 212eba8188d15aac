"""The dense towers' one-device forward launches a fixed number of ops.

The embed cells on the card are paced by the host's launch rate, so an op
added to a layer of the one-device forward shows up as lost tokens a
second. Each case counts the aten ops one `forward` dispatches (fused="on",
no gradient) at shapes where the attention core runs (B2's S <= 128 form,
its long form, its gemma form, BERT's kernel; their plain versions on the
CPU) and holds the count to a constant, so that an op the shared layer
loop adds for its tensor-parallel form shows here. The constants are for
the aten ops as this torch dispatches them."""

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from theoremsearch_tpu_torch.core.config import BertEncoderConfig, EncoderConfig, GemmaEncoderConfig
from theoremsearch_tpu_torch.encoder import bert, gemma, model

torch.set_num_threads(1)

QWEN = EncoderConfig(vocab_size=1024, hidden_size=256, intermediate_size=512, num_layers=2,
                     num_heads=4, num_kv_heads=2, head_dim=128, max_seq_len=512, embedding_dim=256)
GEMMA = GemmaEncoderConfig(vocab_size=1024, hidden_size=256, intermediate_size=384, num_layers=2,
                           num_heads=2, num_kv_heads=1, head_dim=256, global_every=2,
                           max_seq_len=64, head_hidden=256, embedding_dim=256,
                           query_pre_attn_scalar=256.0)
BERT = BertEncoderConfig(vocab_size=1024, hidden_size=128, intermediate_size=256, num_layers=2,
                         num_heads=2, max_seq_len=512, embedding_dim=128)

# (tower module, config, width, the ops of one forward of 8 rows)
CASES = {
    "qwen_64": (model, QWEN, 64, 318),
    "qwen_256_long": (model, QWEN, 256, 736),
    "gemma_32": (gemma, GEMMA, 32, 399),
    "bert_64": (bert, BERT, 64, 257),
}


class _Ops(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("case", sorted(CASES))
def test_one_device_forward_op_count(case):
    mod, cfg, s, want = CASES[case]
    g = torch.Generator().manual_seed(0)
    params = mod.init_params(cfg, g, device="cpu")
    mask = (torch.arange(s)[None] < torch.randint(4, s + 1, (8,), generator=g)[:, None]).to(torch.int32)
    ids = torch.randint(3, cfg.vocab_size, (8, s), generator=g) * mask
    with torch.no_grad():
        ops = _Ops()
        with ops:
            mod.forward(params, ids, mask, cfg, fused="on")
    assert ops.n == want, (case, ops.n)
