# Verbatim copy of theoremsearch_tpu/ingest/methods/flatten.py (jax-free). The port imports nothing of the
# reference package, so it carries its own copy; keep the two in sync.
"""Flatten-then-scan parse method.

The reference's regex_method shells out to `latexdiff --flatten`
(ec2/parse_arxiv_papers/regex_method/flatten.py:8-21) and left its
streaming parser unfinished (comments.py/verbatim.py/macros.py stubs).
This is the working equivalent: a python-native recursive \\input /
\\include / \\subfile inliner (no external binary), feeding the scanner
extractor. Flattening matters when theorem declarations live in a
separate macros file that the main file inputs.
"""

from __future__ import annotations

import re
from pathlib import Path

from ..latex.extract import Theorem, extract_theorems

_INCLUDE_RE = re.compile(r"\\(?:input|include|subfile)\s*\{([^}]+)\}")
MAX_DEPTH = 12


def inline_inputs(main_tex: str | Path, max_depth: int = MAX_DEPTH) -> str:
    """Recursively inline included files (cycle-safe, depth-capped)."""
    main_tex = Path(main_tex)
    seen: set[Path] = set()

    def resolve(base: Path, target: str) -> Path | None:
        target = target.strip()
        cands = [base / target]
        if not Path(target).suffix:
            cands.append(base / f"{target}.tex")
        for c in cands:
            if c.exists():
                return c.resolve()
        return None

    def load(path: Path, depth: int) -> str:
        if depth > max_depth or path in seen:
            return ""
        seen.add(path)
        try:
            text = path.read_text(encoding="utf-8", errors="replace")
        except OSError:
            return ""

        def sub(m: re.Match) -> str:
            r = resolve(path.parent, m.group(1))
            return load(r, depth + 1) if r is not None else ""

        return _INCLUDE_RE.sub(sub, text)

    return load(main_tex.resolve(), 0)


def parse_by_flatten(main_tex: str | Path) -> list[Theorem]:
    return extract_theorems(inline_inputs(main_tex))
