# Verbatim copy of theoremsearch_tpu/ingest/main_tex.py (jax-free). The port imports nothing of the
# reference package, so it carries its own copy; keep the two in sync.
"""Main-TeX-file selection for multi-file paper sources.

Capability-parity with the reference's scored finder
(ec2/parse_arxiv_papers/main_tex.py:59-179): build the \\input/\\include/
\\subfile inclusion graph over candidate TeX files, keep roots (files with
\\documentclass that nothing else includes), and rank them by a content
heuristic — document structure and math density up, slide decks / draft
scraps / referee replies down.
"""

from __future__ import annotations

import re
from pathlib import Path

TEX_SUFFIXES = (".tex", ".ltx", ".latex")

_INCLUDE_RE = re.compile(r"\\(?:input|include|subfile)\s*\{([^}]+)\}")
_DOCCLASS_RE = re.compile(r"\\documentclass")


def _read(path: Path) -> str:
    try:
        return path.read_text(encoding="utf-8", errors="replace")
    except OSError:
        return ""


def _resolve_include(base: Path, target: str) -> Path | None:
    target = target.strip()
    cands = [base / target]
    if not Path(target).suffix:
        cands += [base / f"{target}{s}" for s in TEX_SUFFIXES]
    for c in cands:
        if c.exists():
            return c.resolve()
    return None


def score_tex_candidate(text: str) -> float:
    """Content heuristic for 'is this the paper's main file'."""
    score = 0.0
    if _DOCCLASS_RE.search(text):
        score += 10
    if re.search(r"\\begin\{document\}", text):
        score += 25
    if re.search(r"\\end\{document\}", text):
        score += 10
    for cmd, pts in (("title", 12), ("author", 8), ("abstract", 10), ("maketitle", 8)):
        if re.search(rf"\\{cmd}\b", text):
            score += pts
    score += 2.0 * min(len(re.findall(r"\\section\b", text)), 15)
    score += 1.5 * min(len(re.findall(r"\\begin\{(?:theorem|lemma|proposition|corollary)", text)), 20)
    score += 0.5 * min(len(re.findall(r"\\cite", text)), 40)
    score += min(len(text) / 20_000.0, 5.0)
    # negatives: slides, drafts, correspondence
    if re.search(r"\\documentclass(\[[^\]]*\])?\{beamer\}", text):
        score -= 60
    if re.search(r"\\usepackage\{[^}]*beamer", text):
        score -= 30
    lowered = text[:4000].lower()
    for marker, pts in (
        ("response to referee", 40),
        ("reply to the referee", 40),
        ("cover letter", 30),
        ("todo", 2),
        ("draft", 2),
    ):
        if marker in lowered:
            score -= pts
    return score


def find_main_tex(src_dir: str | Path) -> Path | None:
    """Best main-file candidate in an extracted source tree, or None."""
    src_dir = Path(src_dir)
    tex_files = [p for p in src_dir.rglob("*") if p.suffix.lower() in TEX_SUFFIXES]
    if not tex_files:
        return None
    if len(tex_files) == 1:
        return tex_files[0]

    texts = {p.resolve(): _read(p) for p in tex_files}
    included: set[Path] = set()
    for p, text in texts.items():
        for m in _INCLUDE_RE.finditer(text):
            r = _resolve_include(p.parent, m.group(1))
            if r is not None:
                included.add(r)

    roots = [p for p, t in texts.items() if _DOCCLASS_RE.search(t) and p not in included]
    candidates = roots or [p for p in texts if p not in included] or list(texts)
    return max(candidates, key=lambda p: score_tex_candidate(texts[p]))
