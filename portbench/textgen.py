"""Seeded text traffic: slogans, the queries that paraphrase them, and the
open loop's arrival offsets.

Every word is lowercase letters only, so each is one token for the
program's hash tokenizer (and for the reference's copy of it). Lengths
are the quantiles of a lognormal through the configured median and
5%/95% points, and arrival gaps the quantiles of an exponential: every
seed gets the same multiset of sizes and gaps, in its own order, so the
seed changes which texts and which order, never how much work."""

from __future__ import annotations

import math
from statistics import NormalDist

import numpy as np

_ONSETS = ["b", "c", "d", "f", "g", "h", "k", "l", "m", "n", "p", "r", "s", "t", "v",
           "z", "br", "cr", "dr", "gr", "pr", "tr", "st", "sp", "ch", "th", "ph", "qu"]
_VOWELS = ["a", "e", "i", "o", "u", "ae", "io", "ou", "ea", "y"]
_CODAS = ["", "n", "r", "s", "l", "m", "x", "nt", "rk", "st"]
MATH_WORDS = (
    "every compact connected finite normal regular smooth separable abelian noetherian "
    "projective reduced flat proper simple solvable bounded group ring module scheme space "
    "manifold graph field sheaf operator measure lattice category variety algebra polytope "
    "admits embeds into is dominated by acts on covers splits over dense maps onto unique "
    "fixed point resolution dual basis invariant universal cover spectral gap canonical form "
    "theorem lemma prove show that if then there exists for all the of a an and with whose "
    "rank index bound inequality sequence converges uniformly homotopy equivalence"
).split()


def seed_rng(seed: int, tag: str) -> np.random.Generator:
    """An independent stream per (seed, purpose)."""
    return np.random.default_rng([int(seed) % (1 << 64), sum(map(ord, tag)) * 1_000_003 + len(tag)])


def torch_seed(seed: int, tag: str) -> int:
    return int(seed_rng(seed, tag).integers(0, 2**62))


def vocabulary(n: int = 8192) -> np.ndarray:
    """A fixed vocabulary: the math words, then pronounceable pseudo-words."""
    words = list(dict.fromkeys(MATH_WORDS))
    seen = set(words)
    rng = np.random.default_rng(12345)
    while len(words) < n:
        k = int(rng.integers(2, 4))
        w = "".join(_ONSETS[rng.integers(len(_ONSETS))] + _VOWELS[rng.integers(len(_VOWELS))]
                    for _ in range(k)) + _CODAS[rng.integers(len(_CODAS))]
        if w not in seen:
            seen.add(w)
            words.append(w)
    return np.array(words[:n], dtype=object)


def lognormal_lengths(n: int, spec: dict, rng: np.random.Generator) -> np.ndarray:
    """n lengths: the lognormal's quantiles at (i + 1/2)/n through spec's
    median, p5 and p95, clipped to [min, max], in the rng's order."""
    sigma = math.log(spec["p95"] / spec["p5"]) / (2 * 1.6448536269514722)
    nd = NormalDist()
    z = np.array([nd.inv_cdf((i + 0.5) / n) for i in range(n)])
    out = np.clip(np.rint(spec["median"] * np.exp(sigma * z)), spec["min"], spec["max"]).astype(np.int64)
    return out[rng.permutation(n)]


def blocked_lengths(n: int, block: int, spec: dict, rng: np.random.Generator) -> np.ndarray:
    """n lengths in blocks of `block`: every block holds the same multiset
    (`lognormal_lengths` of one block, whose tail reaches the catalog's
    long slogans), each in its own seeded order. A page of a block then
    holds what a random draw would, its longest slogan varying from page
    to page, while any run of whole blocks does the same work whatever
    the seed."""
    block = min(block, n)
    blocks = -(-n // block)
    return np.concatenate([lognormal_lengths(block, spec, rng) for _ in range(blocks)])[:n]


def exponential_offsets(n: int, rate: float, rng: np.random.Generator) -> np.ndarray:
    """Send times (s) of n Poisson arrivals at `rate`: the exponential's
    quantiles as gaps, in the rng's order, summed."""
    q = (np.arange(n) + 0.5) / n
    gaps = -np.log1p(-q) / rate
    return np.cumsum(gaps[rng.permutation(n)])


def slogans(n: int, lengths: np.ndarray, rng: np.random.Generator, vocab: np.ndarray) -> list[str]:
    """n slogans of the given word counts, words drawn from the vocabulary."""
    ids = rng.integers(0, len(vocab), int(lengths.sum()))
    out, at = [], 0
    for ln in lengths.tolist():
        out.append(" ".join(vocab[ids[at : at + ln]]))
        at += ln
    return out


def paraphrase(slogan: str, length: int, rng: np.random.Generator, vocab: np.ndarray) -> str:
    """A query of `length` words about a slogan: its words kept in order
    where it has enough of them, padded with query words where not."""
    words = slogan.split()
    if length <= len(words):
        keep = np.sort(rng.choice(len(words), length, replace=False))
        return " ".join(words[i] for i in keep)
    extra = rng.choice(vocab[:len(MATH_WORDS)], length - len(words))
    return " ".join(list(extra[: (length - len(words)) // 2]) + words
                    + list(extra[(length - len(words)) // 2 :]))
