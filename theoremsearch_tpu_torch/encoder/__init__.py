"""Port of theoremsearch_tpu.encoder (see the package docstring)."""

from .batching import BatchedEncoder
from .bert import BertEncoder
from .gemma import GemmaEncoder
from .model import QwenEncoder, encode_pooled, forward, init_params
from .tokenizer import SimpleTokenizer, get_tokenizer

__all__ = [
    "QwenEncoder",
    "GemmaEncoder",
    "BertEncoder",
    "init_params",
    "forward",
    "encode_pooled",
    "SimpleTokenizer",
    "get_tokenizer",
    "BatchedEncoder",
]
