"""Port parity: BatchedEncoder.encode_long (blockwise encode + mean-pool)
against the JAX encoder with the same weights (carried across by
params_from_jax); twins of tests/test_encoder.py's encode_long cases.
The chunks each package encodes are recorded and must be equal."""

import jax
import numpy as np
import pytest
import torch

from theoremsearch_tpu.core import EncoderConfig as JEncoderConfig
from theoremsearch_tpu.encoder import BatchedEncoder as JBatchedEncoder
from theoremsearch_tpu.encoder import QwenEncoder
from theoremsearch_tpu_torch.core.config import EncoderConfig
from theoremsearch_tpu_torch.encoder.batching import BatchedEncoder
from theoremsearch_tpu_torch.encoder.model import params_from_jax

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def encoders():
    enc = QwenEncoder(JEncoderConfig.tiny(), seed=0)
    jbe = JBatchedEncoder(enc.params, enc.cfg, batch_size=4, buckets=(16, 32),
                          prompts={"document": "doc: "})
    pbe = BatchedEncoder(params_from_jax(jax.device_get(enc.params), device="cpu"),
                         EncoderConfig.tiny(), batch_size=4, buckets=(16, 32),
                         prompts={"document": "doc: "}, device="cpu")
    return jbe, pbe


def _recorded(be):
    """Wrap the instance's encode so the chunk texts it is handed are kept."""
    seen: list = []
    plain = be.encode

    def encode(texts, role=None):
        seen.append(list(texts))
        return plain(texts, role=role)

    be.encode = encode
    return seen


def _twin(encoders, texts, **kw):
    jbe, pbe = encoders
    jseen, pseen = _recorded(jbe), _recorded(pbe)
    try:
        want = jbe.encode_long(texts, **kw)
        got = pbe.encode_long(texts, **kw)
    finally:
        del jbe.encode, pbe.encode
    assert pseen == jseen, "the two packages chunked differently"
    assert got.shape == want.shape == (len(texts), 128)
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, rtol=1e-4)
    assert float(np.min(np.sum(got.astype(np.float64) * want, axis=1))) > 0.9999
    return got, pseen[0]


def test_encode_long_chunk_and_pool(encoders):
    _, pbe = encoders
    short = "a theorem about primes"
    long = " ".join(f"word{i}" for i in range(400))   # far beyond the 32-token bucket
    out, pieces = _twin(encoders, [short, long])
    assert pieces[0] == short and len(pieces) > 2
    assert float(out[0] @ pbe.encode([short])[0]) > 0.999
    chunk = " ".join(f"tok{i}" for i in range(10))
    rep, _ = _twin(encoders, [" ".join([chunk] * 8)], chunk_tokens=20)
    assert float(rep[0] @ pbe.encode([chunk])[0]) > 0.9


def test_encode_long_token_dense_words_never_overflow(encoders):
    _, pbe = encoders
    word = r"\frac{a+b}{c-d}"
    assert len(pbe.tokenizer.tokenize(word)) >= 4
    out, pieces = _twin(encoders, [" ".join([word] * 40)], chunk_tokens=20)
    assert len(pieces) > 1
    assert all(len(pbe.tokenizer.tokenize(p)) <= 20 for p in pieces)
    assert float(out[0] @ pbe.encode([word])[0]) > 0.9


def test_encode_long_prompts_once_before_chunking(encoders):
    long = " ".join(f"lemma{i}" for i in range(120))
    _, pieces = _twin(encoders, [long, "short text"], role="document")
    assert pieces[0].startswith("doc: lemma0")
    assert sum(p.startswith("doc: ") for p in pieces) == 2   # first chunk + the short text
