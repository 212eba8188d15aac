# Verbatim copy of theoremsearch_tpu/ingest/latex/scanner.py (jax-free). The port imports nothing of the
# reference package, so it carries its own copy; keep the two in sync.
"""Low-level LaTeX source scanning utilities.

Where the reference encodes LaTeX lexical structure in recursive
`regex`-module patterns (ec2/parse_papers/patterns.py), this module uses
an explicit cursor walker over the source: comment stripping that honors
escaped percent signs and verbatim blocks, balanced-group reading, and
command-argument parsing. Cursor walking is O(n), never catastrophically
backtracks, and handles nesting depth beyond what a recursive regex will.
"""

from __future__ import annotations

import re
from dataclasses import dataclass

_VERBATIM_ENVS = ("verbatim", "Verbatim", "lstlisting", "minted", "comment", "filecontents")


def strip_comments(src: str) -> str:
    """Remove %-comments (keeping \\%) and comment/verbatim-style blocks.

    Matches the reference's preprocessing (latex_parse.py:399-400) but
    also protects \\% inside the line scan and removes all of the
    verbatim-family environments rather than only `comment`.

    %-comments strip FIRST: a commented-out `% \\begin{comment}` must not
    open an environment-removal span that would swallow live document
    text (theorems included) up to the next real \\end{comment}."""
    out = []
    i, n = 0, len(src)
    while i < n:
        c = src[i]
        if c == "\\" and i + 1 < n:
            out.append(src[i : i + 2])
            i += 2
            continue
        if c == "%":
            # skip to end of line (keep the newline)
            j = src.find("\n", i)
            i = n if j < 0 else j
            continue
        out.append(c)
        i += 1
    src = "".join(out)
    for env in _VERBATIM_ENVS:
        src = re.sub(
            rf"\\begin\{{{env}\*?\}}.*?\\end\{{{env}\*?\}}", "", src, flags=re.DOTALL
        )
    return src


def read_group(src: str, i: int) -> tuple[str, int] | None:
    """Read a balanced {...} group starting at index i (src[i] must be '{').
    Returns (contents, index_after_closing_brace) or None if unbalanced."""
    if i >= len(src) or src[i] != "{":
        return None
    depth = 0
    j = i
    n = len(src)
    while j < n:
        c = src[j]
        if c == "\\":
            j += 2
            continue
        if c == "{":
            depth += 1
        elif c == "}":
            depth -= 1
            if depth == 0:
                return src[i + 1 : j], j + 1
        j += 1
    return None


def read_optional(src: str, i: int) -> tuple[str, int] | None:
    """Read a [...] optional argument starting at whitespace before '['."""
    j = skip_ws(src, i)
    if j >= len(src) or src[j] != "[":
        return None
    depth = 0
    k = j
    n = len(src)
    while k < n:
        c = src[k]
        if c == "\\":
            k += 2
            continue
        if c == "[":
            depth += 1
        elif c == "]":
            depth -= 1
            if depth == 0:
                return src[j + 1 : k], k + 1
        elif c == "\n" and src[k : k + 2] == "\n\n":
            return None  # paragraph break: not an optional arg
        k += 1
    return None


def skip_ws(src: str, i: int) -> int:
    n = len(src)
    while i < n and src[i] in " \t\r\n":
        i += 1
    return i


@dataclass
class Command:
    """One occurrence of \\name with parsed arguments."""

    name: str
    start: int              # index of the backslash
    end: int                # index just past the last argument
    star: bool
    opts: list[str]         # optional [..] args in order encountered
    args: list[str]         # mandatory {..} args in order


def iter_commands(src: str, name: str, n_args: int, max_opts: int = 2):
    """Yield Command for each occurrence of \\name taking n_args groups,
    with up to max_opts optional args interleaved before/between them."""
    pat = re.compile(rf"\\{re.escape(name)}(\*)?(?![A-Za-z@])")
    for m in pat.finditer(src):
        i = m.end()
        opts: list[str] = []
        args: list[str] = []
        ok = True
        # leading optionals
        while len(opts) < max_opts:
            r = read_optional(src, i)
            if r is None:
                break
            opts.append(r[0])
            i = r[1]
        for _ in range(n_args):
            j = skip_ws(src, i)
            r = read_group(src, j)
            if r is None:
                ok = False
                break
            args.append(r[0])
            i = r[1]
            # optionals may also follow a mandatory arg (e.g. \newtheorem{x}{T}[sec])
            while len(opts) < max_opts:
                ro = read_optional(src, i)
                if ro is None:
                    break
                opts.append(ro[0])
                i = ro[1]
        if ok:
            yield Command(name=name, start=m.start(), end=i, star=bool(m.group(1)), opts=opts, args=args)


def find_env_spans(src: str, env: str):
    """Yield (start_of_begin, end_of_end, body, note) for each
    \\begin{env}[note]...\\end{env} span, tolerating the starred variant
    and nested same-name environments."""
    begin_pat = re.compile(rf"\\begin\s*\{{{re.escape(env)}(\*)?\}}")
    end_pat = re.compile(rf"\\(begin|end)\s*\{{{re.escape(env)}(\*)?\}}")
    pos = 0
    n = len(src)
    while pos < n:
        mb = begin_pat.search(src, pos)
        if not mb:
            return
        body_start = mb.end()
        note = None
        r = read_optional(src, body_start)
        if r is not None:
            note, body_start = r
        depth = 1
        scan = body_start
        m_end = None
        while depth:
            m2 = end_pat.search(src, scan)
            if not m2:
                break
            depth += 1 if m2.group(1) == "begin" else -1
            scan = m2.end()
            m_end = m2
        if depth or m_end is None:
            pos = mb.end()
            continue
        yield mb.start(), m_end.end(), src[body_start : m_end.start()], note
        pos = m_end.end()


def control_sequences(src: str) -> set[str]:
    return set(re.findall(r"\\([A-Za-z@]+)", src))
