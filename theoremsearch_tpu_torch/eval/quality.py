# Verbatim copy of theoremsearch_tpu/eval/quality.py (jax-free). The port imports nothing of the
# reference package, so it carries its own copy; keep the two in sync.
"""Quality/ops probes — statistical estimators and LLM-judge raters.

Capability-parity with the reference's ec2/tests/ CLIs (SURVEY.md
component 21):

- source-mismatch estimator (arxiv_s3_v_diff/__main__.py:66-127): sample
  N papers, compare the bundle bytes against the live-API source tree,
  report p-hat with a 95% normal-approximation CI. The pairwise
  comparator is injected so the statistic is testable offline.
- slogan-quality judge (slogan_quality/__main__.py:15-100): random-sample
  slogans, have an expert LLM grade each 1-5 against context, parse a
  strict-JSON rating, report the mean and flag low ratings.
"""

from __future__ import annotations

import filecmp
import json
import math
import re
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Sequence

from ..ingest.catalog import Catalog
from ..slogans.client import LLMClient, OfflineStubClient


# ---------------------------------------------------------------------------
# source mismatch estimator
# ---------------------------------------------------------------------------


@dataclass
class MismatchEstimate:
    n: int
    mismatches: int

    @property
    def p_hat(self) -> float:
        return self.mismatches / self.n if self.n else 0.0

    @property
    def ci95(self) -> tuple[float, float]:
        if not self.n:
            return (0.0, 0.0)
        p = self.p_hat
        half = 1.96 * math.sqrt(max(p * (1 - p), 1e-12) / self.n)
        return (max(0.0, p - half), min(1.0, p + half))

    def summary(self) -> str:
        lo, hi = self.ci95
        return f"mismatch p̂={self.p_hat:.3f} (95% CI [{lo:.3f}, {hi:.3f}], n={self.n})"


def trees_equal(dir_a: str | Path, dir_b: str | Path) -> bool:
    """Recursive directory equality (shallow=False content compare).

    ignore=[]: dircmp's default ignore list silently skips entries named
    'tags', '.git', '__pycache__', ... — real names in arXiv source
    trees, whose differences must count as mismatches."""
    cmp = filecmp.dircmp(str(dir_a), str(dir_b), ignore=[])

    def walk(c: filecmp.dircmp) -> bool:
        if c.left_only or c.right_only or c.diff_files or c.funny_files:
            return False
        _, mismatch, errors = filecmp.cmpfiles(c.left, c.right, c.common_files, shallow=False)
        if mismatch or errors:
            return False
        return all(walk(sub) for sub in c.subdirs.values())

    return walk(cmp)


def estimate_source_mismatch(
    paper_ids: Sequence[str],
    compare_fn: Callable[[str], bool],
    sample_size: int | None = None,
    seed: int = 0,
) -> MismatchEstimate:
    """compare_fn(paper_id) -> True when the two sources match."""
    import random

    rng = random.Random(seed)
    ids = list(paper_ids)
    if sample_size is not None and len(ids) > sample_size:
        ids = rng.sample(ids, sample_size)
    mism = sum(0 if compare_fn(pid) else 1 for pid in ids)
    return MismatchEstimate(n=len(ids), mismatches=mism)


# ---------------------------------------------------------------------------
# slogan quality judge
# ---------------------------------------------------------------------------

JUDGE_INSTRUCTIONS = [
    "You are an expert mathematician rating the quality of a one-paragraph",
    "'slogan' summary of a theorem against the theorem's statement.",
    "Rate accuracy and usefulness for retrieval on an integer scale 1-5.",
    'Respond with STRICT JSON only: {"rating": <1-5>, "reason": "<short>"}.',
]

_RATING_RE = re.compile(r'"rating"\s*:\s*([1-5])')


def parse_rating(text: str | None) -> int | None:
    """Strict-JSON first, regex fallback (judge models drift)."""
    if not text:
        return None
    try:
        val = json.loads(text).get("rating")
        if isinstance(val, int) and 1 <= val <= 5:
            return val
    except (json.JSONDecodeError, AttributeError):
        pass
    m = _RATING_RE.search(text)
    return int(m.group(1)) if m else None


@dataclass
class SloganQualityReport:
    ratings: list[int]
    flagged: list[tuple[int, int]]   # (slogan_id, rating < 4)

    @property
    def mean(self) -> float:
        return sum(self.ratings) / len(self.ratings) if self.ratings else 0.0


def rate_slogans_quality(
    catalog: Catalog,
    judge: LLMClient | None = None,
    sample_size: int = 20,
    flag_below: int = 4,
) -> SloganQualityReport:
    """Random-sample slogans (ORDER BY RANDOM LIMIT — the reference's
    sampling, slogan_quality/__main__.py:79-89), judge each against its
    theorem body, report mean + flagged ids."""
    judge = judge or OfflineStubClient()
    q = (
        "SELECT s.slogan_id, s.slogan, t.body FROM theorem_slogan s "
        "JOIN theorem t ON t.theorem_id = s.theorem_id "
        f"ORDER BY RANDOM() LIMIT {int(sample_size)}"
    )
    ratings: list[int] = []
    flagged: list[tuple[int, int]] = []
    for slogan_id, slogan, body in catalog.conn.execute(q).fetchall():
        c = judge.complete(
            JUDGE_INSTRUCTIONS,
            {"theorem_body": body, "slogan": slogan},
            temperature=0.0,
        )
        r = parse_rating(c.text)
        if r is None:
            continue
        ratings.append(r)
        if r < flag_below:
            flagged.append((slogan_id, r))
    return SloganQualityReport(ratings=ratings, flagged=flagged)
