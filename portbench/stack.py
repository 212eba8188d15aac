"""The system under test, built from a configuration file and the seed:
the port's tower (`encoder/batching.py:BatchedEncoder`, as the CLI builds
it) and the 1M-row serving index (`search/engine.py:SearchEngine` on an
int8 global-scale `FlatIndex` with its bf16 rescore copy, the speed
route). The port is imported here and in the loops only."""

from __future__ import annotations

import numpy as np
import torch

from . import meta, textgen, weights
from .reference import towers
from .reference.tokenizer import HashTokenizer


def family(cfg: dict) -> str:
    return cfg["family"]


def program_config(cfg: dict):
    """The port's config dataclass for a configuration file."""
    from theoremsearch_tpu_torch.core.config import BertEncoderConfig, EncoderConfig

    m, s = cfg["model"], cfg["serving"]
    if cfg["family"] == "qwen":
        return EncoderConfig(
            vocab_size=m["vocab_size"], hidden_size=m["hidden_size"],
            intermediate_size=m["intermediate_size"], num_layers=m["num_hidden_layers"],
            num_heads=m["num_attention_heads"], num_kv_heads=m["num_key_value_heads"],
            head_dim=m["head_dim"], rope_theta=float(m["rope_theta"]),
            rms_norm_eps=m["rms_norm_eps"], max_seq_len=s["max_seq_len"],
            embedding_dim=m["hidden_size"], pooling="last_token", normalize=True)
    return BertEncoderConfig(
        vocab_size=m["vocab_size"], hidden_size=m["hidden_size"],
        intermediate_size=m["intermediate_size"], num_layers=m["num_hidden_layers"],
        num_heads=m["num_attention_heads"], type_vocab_size=m["type_vocab_size"],
        hidden_act=m["hidden_act"], layer_norm_eps=m["layer_norm_eps"],
        max_seq_len=s["max_seq_len"], embedding_dim=m["hidden_size"], normalize=True)


def make_weights(cfg: dict, seed: int, device) -> dict:
    return weights.make_params(cfg["model"], cfg["family"], cfg["serving"]["max_seq_len"],
                               textgen.torch_seed(seed, "weights"), device)


def batched_encoder(cfg: dict, params: dict, device, quant: str):
    """The encoder the CLI's serve and embed commands build (the hermetic
    hash tokenizer, no role prompts)."""
    from theoremsearch_tpu_torch.encoder.batching import BatchedEncoder
    from theoremsearch_tpu_torch.encoder.tokenizer import SimpleTokenizer

    pcfg = program_config(cfg)
    return BatchedEncoder(params, pcfg, tokenizer=SimpleTokenizer(vocab_size=pcfg.vocab_size),
                          prompts={}, quant=quant, device=device)


class Corpus:
    """The corpus rows, remade from the seed block by block: unit-normal
    random rows, with the slogan rows at seeded positions, rounded to
    bf16, the type the index serves them in (its rescore copy holds
    exactly these values; its int8 codes are quantized from them)."""

    def __init__(self, n: int, dim: int, seed: int, device, slogan_rows: torch.Tensor,
                 positions: np.ndarray, block: int = 131_072):
        self.n, self.dim, self.seed, self.device = n, dim, seed, device
        self.block = min(block, n)
        self.slogan_rows = slogan_rows
        self.positions = np.asarray(positions, np.int64)
        order = np.argsort(self.positions)
        self._pos_sorted = self.positions[order]
        self._order = order

    def block_at(self, lo: int) -> torch.Tensor:
        hi = min(self.n, lo + self.block)
        gen = torch.Generator(device=self.device).manual_seed(
            textgen.torch_seed(self.seed, f"corpus{lo}"))
        x = torch.randn((hi - lo, self.dim), generator=gen, device=self.device)
        x /= x.norm(dim=1, keepdim=True)
        a, b = np.searchsorted(self._pos_sorted, [lo, hi])
        if b > a:
            rows = torch.as_tensor(self._pos_sorted[a:b] - lo, device=self.device)
            x[rows] = self.slogan_rows[torch.as_tensor(self._order[a:b], device=self.device)]
        return x.bfloat16().float()

    def blocks(self):
        for lo in range(0, self.n, self.block):
            yield lo, self.block_at(lo)

    def full(self) -> torch.Tensor:
        return torch.cat([x for _, x in self.blocks()])

    def rows(self, idx: torch.Tensor) -> torch.Tensor:
        """Corpus rows at the given indices (remade block by block)."""
        idx = idx.to(self.device).long()
        out = torch.empty((idx.numel(), self.dim), device=self.device)
        for lo in range(0, self.n, self.block):
            sel = ((idx >= lo) & (idx < lo + self.block)).nonzero().flatten()
            if sel.numel():
                out[sel] = self.block_at(lo)[idx[sel] - lo]
        return out


def reference_embed(cfg: dict, params: dict, texts: list[str], mode: str, device) -> torch.Tensor:
    tok = HashTokenizer(cfg["model"]["vocab_size"])
    seqs = [tok.ids(t, cfg["serving"]["max_seq_len"]) for t in texts]
    return towers.embed(params, cfg["model"], cfg["family"], seqs, mode, device)


def slogan_texts(p: dict, seed: int) -> tuple[list[str], np.ndarray]:
    """The corpus's slogans and their word counts, from the seed; every
    block of `length_block` slogans has the same lengths
    (`textgen.blocked_lengths`)."""
    vocab = textgen.vocabulary()
    lengths = textgen.blocked_lengths(p["slogans"], p["length_block"], p["slogan_words"],
                                      textgen.seed_rng(seed, "slen"))
    return textgen.slogans(p["slogans"], lengths, textgen.seed_rng(seed, "slogans"), vocab), lengths


def queries(p: dict, seed: int, texts: list[str], n: int, tag: str):
    """n queries, each a paraphrase of a seeded slogan: (texts, words)."""
    vocab = textgen.vocabulary()
    rng = textgen.seed_rng(seed, tag)
    lengths = textgen.lognormal_lengths(n, p["query_words"], textgen.seed_rng(seed, tag + "len"))
    of = rng.integers(0, len(texts), n)
    out = [textgen.paraphrase(texts[j], int(ln), rng, vocab) for j, ln in zip(of, lengths)]
    return out, lengths


def serving_index(cfg: dict, p: dict, seed: int, params: dict, device):
    """(engine, corpus, slogan texts, row of each slogan): the 1M-row
    index with the slogans' own bf16 embeddings at seeded rows and its
    metadata (`meta.columns`), on the speed route."""
    from theoremsearch_tpu_torch.core.config import IndexConfig
    from theoremsearch_tpu_torch.index.flat import FlatIndex
    from theoremsearch_tpu_torch.index.quant import quantize_global_int8
    from theoremsearch_tpu_torch.search.engine import SearchEngine
    from theoremsearch_tpu_torch.search.metadata import CorpusMetadata

    n, dim = p["corpus_rows"], cfg["model"]["hidden_size"]
    texts, _ = slogan_texts(p, seed)
    rows = reference_embed(cfg, params, texts, "bf16", device)
    pos = textgen.seed_rng(seed, "positions").choice(n, len(texts), replace=False)
    corpus = Corpus(n, dim, seed, device, rows, pos)
    x = corpus.full()
    codes, gscale = quantize_global_int8(x)
    rescore = x.to(torch.bfloat16)
    del x
    index = FlatIndex(vectors=codes, ids=torch.arange(n, dtype=torch.int64),
                      scales=torch.full((n,), np.float32(gscale), device=device), num_rows=n,
                      config=IndexConfig(dim=dim, dtype="int8", int8_scale="global"),
                      global_scale=gscale)
    md = CorpusMetadata(**meta.columns(n, pos, texts))
    engine = SearchEngine(index, meta=md, rescore_vectors=rescore, device=device,
                          device_init={"rescore": rescore})
    return engine, corpus, texts, pos
