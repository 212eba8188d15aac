"""A frozen copy of the hash tokenizer the served traffic goes through
(the port's `SimpleTokenizer`: regex words and symbols, lowercased, each
hashed by blake2s into the vocabulary past three specials; BOS 1, EOS 2,
PAD 0), so the reference reads the same token ids without importing the
port."""

from __future__ import annotations

import hashlib
import re

_TOKEN_RE = re.compile(r"[A-Za-z]+|[0-9]+|\\[A-Za-z]+|[^\sA-Za-z0-9]")
BOS, EOS, N_SPECIAL = 1, 2, 3


class HashTokenizer:
    def __init__(self, vocab_size: int):
        self.vocab_size = vocab_size
        self._cache: dict[str, int] = {}

    def _id(self, tok: str) -> int:
        v = self._cache.get(tok)
        if v is None:
            h = hashlib.blake2s(tok.encode("utf-8"), digest_size=8).digest()
            v = N_SPECIAL + int.from_bytes(h, "little") % (self.vocab_size - N_SPECIAL)
            self._cache[tok] = v
        return v

    def ids(self, text: str, max_len: int) -> list[int]:
        """BOS, the text's ids cut to max_len - 2, EOS."""
        toks = [self._id(t) for t in _TOKEN_RE.findall(text.lower())]
        return [BOS] + toks[: max_len - 2] + [EOS]
