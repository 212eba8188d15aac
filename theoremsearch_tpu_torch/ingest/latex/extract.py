# Verbatim copy of theoremsearch_tpu/ingest/latex/extract.py (jax-free). The port imports nothing of the
# reference package, so it carries its own copy; keep the two in sync.
"""Theorem extraction driver.

Pipeline (capability-parity with the reference's v1 extractor,
ec2/parse_papers/latex_parse.py:395-417 `extract`, with the amsthm
numbering simulation of theorem_forms.py):

1. strip comments / verbatim blocks;
2. expand user macros (\\def/\\newcommand/\\DeclareMathOperator/\\let);
3. collect theorem-env declarations (declarations.py) incl.
   \\newenvironment aliases and \\newaliascnt counter rewiring;
4. find every \\begin{env}...\\end{env} span for declared + default envs
   (balanced matching — handles nested environments);
5. replay the document's event stream (sections, \\appendix, theorem
   begins) through the CounterTree to render "Caption N.M." headings,
   with alpha section numbering after the appendix;
6. emit (name, body, label) rows; labels deduped (first wins), body
   whitespace-normalized with the label command removed.

Default env list matches the reference (latex_parse.py:10).
"""

from __future__ import annotations

import re
from dataclasses import dataclass

from .declarations import Declaration, collect_declarations, newenvironment_regions
from .macros import expand_macros
from .numbering import CounterTree
from .scanner import find_env_spans, read_group, skip_ws, strip_comments

DEFAULT_THEOREM_ENVS = [
    "theorem",
    "lemma",
    "proposition",
    "corollary",
    "claim",
    "definition",
    "remark",
    "example",
]

_SECTION_LEVELS = ("section", "subsection", "subsubsection")
_LABEL_RE = re.compile(r"\\label\s*\{([^{}]*)\}")
_ALIASCNT_RE = re.compile(r"\\newaliascnt\s*\{([^{}]+)\}\s*\{([^{}]+)\}")
_NUMBERWITHIN_RE = re.compile(r"\\numberwithin\s*\{\\?([A-Za-z@]+)\}\s*\{\\?([A-Za-z@]+)\}")


@dataclass
class Theorem:
    name: str               # rendered heading, e.g. "Theorem 2.1. (Main)"
    body: str               # LaTeX body, label stripped, whitespace-normalized
    label: str | None       # first \label in the body, deduped document-wide
    env: str                # source environment name
    start: int              # source offset (for debugging/goldens)


def _resolve_aliases(decls: list[Declaration], src: str) -> None:
    """\\newaliascnt{child}{parent}: theorems sharing the alias counter
    really share the parent counter (reference alias_handling,
    latex_parse.py:48-80)."""
    alias = {m.group(1): m.group(2) for m in _ALIASCNT_RE.finditer(src)}
    if not alias:
        return
    for d in decls:
        while d.shared in alias:
            d.shared = alias[d.shared]


def _structural_events(src: str):
    """(pos, kind) for sections and appendix toggles, after \\begin{document}."""
    m_doc = re.search(r"\\begin\s*\{document\}", src)
    doc_start = m_doc.start() if m_doc else 0
    events = []
    for level in _SECTION_LEVELS:
        for m in re.finditer(rf"\\{level}(\*)?\s*(?=[\{{\[])", src):
            if m.group(1) or m.start() < doc_start:
                continue
            events.append((m.start(), level))
    m_app = re.search(r"\\appendix(?![A-Za-z@])|\\begin\s*\{appendix\}", src)
    if m_app and m_app.start() >= doc_start:
        events.append((m_app.start(), "appendix"))
    if re.search(r"\\swapnumbers(?![A-Za-z@])", src):
        events.append((0, "swapnumbers"))
    return events


def extract_theorems(src: str, expand: bool = True) -> list[Theorem]:
    src = strip_comments(src)
    if expand:
        src = expand_macros(src)

    decls = collect_declarations(src)
    _resolve_aliases(decls, src)

    tree = CounterTree()
    for d in decls:
        tree.define_env(
            d.env, d.caption, starred=d.starred, shared=d.shared, within=d.within
        )
    for m in _NUMBERWITHIN_RE.finditer(src):
        tree.number_within(m.group(1), m.group(2))

    envs = list(dict.fromkeys([d.env for d in decls] + DEFAULT_THEOREM_ENVS))

    # blank \newenvironment definition bodies: their literal \begin{env}
    # code is a definition, not an occurrence
    scan_src = src
    regions = newenvironment_regions(src)
    if regions:
        chars = list(src)
        for a, b in regions:
            chars[a:b] = " " * (b - a)
        scan_src = "".join(chars)

    # gather every span; starred \begin{env*} handled by find_env_spans
    spans = []
    for env in envs:
        for start, end, body, note in find_env_spans(scan_src, env):
            spans.append((start, end, env, body, note, False))

    # thm-restate wrapper (parity-plus: common in real arXiv sources and
    # missed by the reference's extractor, which only knows the four
    # declaration commands of extract_from_tex.py:20-48):
    #   \begin{restatable}[note]{thmenv}{\command} body \end{restatable}
    # numbers on thmenv's counter; restatable* is unnumbered. The
    # \command re-statement sites are macro uses, so the theorem is
    # extracted exactly once.
    for start, end, body, note in find_env_spans(scan_src, "restatable"):
        starred = bool(re.match(r"\\begin\s*\{restatable\*", scan_src[start:]))
        j = skip_ws(body, 0)
        g = read_group(body, j)
        if g is None:
            continue
        thm_env, j = g
        g = read_group(body, skip_ws(body, j))
        if g is None:
            continue
        _cmd, j = g
        thm_env = thm_env.strip().lstrip("\\")
        if thm_env:
            spans.append((start, end, thm_env, body[j:], note, starred))

    spans.sort()
    # drop spans nested inside another theorem span (e.g. a remark quoted
    # inside a proof environment that itself sits in a theorem)
    filtered = []
    last_end = -1
    for s in spans:
        if s[0] >= last_end:
            filtered.append(s)
            last_end = s[1]
    spans = filtered

    events = _structural_events(src)
    stream = sorted(
        [(pos, 0, kind, None) for pos, kind in events]
        + [(s[0], 1, "thm", s) for s in spans]
    )

    seen_labels: set[str] = set()
    out: list[Theorem] = []
    for pos, _, kind, payload in stream:
        if kind == "swapnumbers":
            tree.swap_numbers = True
        elif kind == "appendix":
            tree.enter_appendix()
        elif kind in _SECTION_LEVELS:
            tree.step_structural(kind)
        else:
            start, end, env, body, note, unnumbered = payload
            if unnumbered:
                # restatable*: caption only, no counter step
                if env not in tree.envs:
                    tree.define_env(env)
                name = tree.envs[env].caption + (f" ({note})" if note else "")
            else:
                name = tree.begin_env(env, note)
            label = None
            m = _LABEL_RE.search(body)
            if m:
                lbl = m.group(1)
                body = body.replace(m.group(0), "", 1)
                if lbl and lbl not in seen_labels:
                    seen_labels.add(lbl)
                    label = lbl
            body = re.sub(r"\s+", " ", body).strip()
            if body:
                out.append(Theorem(name=name, body=body, label=label, env=env, start=start))
    return out


def extract_file(path: str, expand: bool = True) -> list[Theorem]:
    with open(path, "r", encoding="utf-8", errors="replace") as f:
        return extract_theorems(f.read(), expand=expand)
