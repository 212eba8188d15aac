# Verbatim copy of theoremsearch_tpu/ingest/latex/macros.py (jax-free). The port imports nothing of the
# reference package, so it carries its own copy; keep the two in sync.
"""User-macro expansion.

Capability-parity with the reference's def/macro/operator handling
(ec2/parse_papers/latex_parse.py:19-126 and the nested-macro fixpoint of
ec2/parse_arxiv_papers/tex_method/expand_latex_macros.py:170-211), built
on the cursor scanner instead of recursive regexes:

- collects \\def / \\edef / \\gdef / \\xdef, \\newcommand /
  \\renewcommand / \\providecommand / \\DeclareRobustCommand,
  \\DeclareMathOperator (-> \\operatorname{...} text form), and \\let;
- expands call sites with positional {#1..#9} args and one leading
  optional-default arg, to a bounded fixpoint so nested macros resolve.
"""

from __future__ import annotations

import re
from dataclasses import dataclass

from .scanner import read_group, read_optional, skip_ws

MAX_PASSES = 8
MAX_GROWTH = 20  # abort expansion if the document grows this many times


@dataclass
class Macro:
    n_args: int
    body: str
    default: str | None = None   # default for #1 when defined with [default]


_DEF_RE = re.compile(r"\\[exg]?def\s*(\\[A-Za-z@]+)((?:#\d)*)\s*(?=\{)")
_NEWCMD_RE = re.compile(
    r"\\(?:newcommand|renewcommand|providecommand|DeclareRobustCommand)\s*\*?\s*"
    r"(?:\{\s*(\\[A-Za-z@]+)\s*\}|(\\[A-Za-z@]+))"
)
_MATHOP_RE = re.compile(r"\\DeclareMathOperator\s*(\*)?\s*\{\s*(\\[A-Za-z@]+)\s*\}\s*(?=\{)")
_LET_RE = re.compile(r"\\let\s*(\\[A-Za-z@]+)\s*=?\s*(\\[A-Za-z@]+)")


def collect_macros(src: str) -> dict[str, Macro]:
    """Build the macro table. Later definitions win (renewcommand)."""
    table: dict[str, Macro] = {}

    for m in _DEF_RE.finditer(src):
        name = m.group(1)
        n_args = len(m.group(2)) // 2
        r = read_group(src, skip_ws(src, m.end()))
        if r is not None:
            table[name] = Macro(n_args=n_args, body=r[0])

    for m in _NEWCMD_RE.finditer(src):
        name = m.group(1) or m.group(2)
        i = m.end()
        n_args = 0
        default = None
        r = read_optional(src, i)
        if r is not None:
            try:
                n_args = int(r[0].strip() or 0)
            except ValueError:
                n_args = 0
            i = r[1]
            r2 = read_optional(src, i)
            if r2 is not None:
                default = r2[0]
                i = r2[1]
        rb = read_group(src, skip_ws(src, i))
        if rb is not None:
            table[name] = Macro(n_args=n_args, body=rb[0], default=default)

    for m in _MATHOP_RE.finditer(src):
        name = m.group(2)
        rb = read_group(src, skip_ws(src, m.end()))
        if rb is not None:
            # reference renders operators as \text{...} (latex_parse.py:124)
            table[name] = Macro(n_args=0, body=rf"\operatorname{{{rb[0]}}}")

    # \let aliases: resolve one step against what we already know
    for m in _LET_RE.finditer(src):
        new, old = m.group(1), m.group(2)
        if old in table and new not in table:
            table[new] = table[old]

    return table


def _expand_once(src: str, table: dict[str, Macro]) -> tuple[str, bool]:
    """One left-to-right expansion pass. Returns (new_src, changed)."""
    out = []
    i, n = 0, len(src)
    changed = False
    while i < n:
        c = src[i]
        if c != "\\":
            out.append(c)
            i += 1
            continue
        m = re.match(r"\\[A-Za-z@]+", src[i:])
        if not m:
            out.append(src[i : i + 2])
            i += 2
            continue
        name = m.group(0)
        spec = table.get(name)
        # don't expand if part of a longer control word (regex ensures not)
        if spec is None:
            out.append(name)
            i += len(name)
            continue
        j = i + len(name)
        # consume a '*' variant marker
        j2 = skip_ws(src, j)
        if j2 < n and src[j2] == "*":
            j = j2 + 1
        args: list[str] = []
        ok = True
        remaining = spec.n_args
        if remaining and spec.default is not None:
            r = read_optional(src, j)
            if r is not None:
                args.append(r[0])
                j = r[1]
            else:
                args.append(spec.default)
            remaining -= 1
        for _ in range(remaining):
            k = skip_ws(src, j)
            r = read_group(src, k)
            if r is None:
                # bare single-token argument (e.g. \frac12 style): take one char
                if k < n and src[k] not in "\\{}%":
                    args.append(src[k])
                    j = k + 1
                    continue
                ok = False
                break
            args.append(r[0])
            j = r[1]
        if not ok:
            out.append(name)
            i += len(name)
            continue
        body = spec.body
        for idx, a in enumerate(args, start=1):
            body = body.replace(f"#{idx}", a)
        out.append(body)
        i = j
        changed = True
    return "".join(out), changed


def expand_macros(src: str, table: dict[str, Macro] | None = None) -> str:
    """Expand to fixpoint (bounded passes, growth-capped)."""
    if table is None:
        table = collect_macros(src)
    if not table:
        return src
    # never expand a macro into its own definition site: drop self-recursive
    table = {k: v for k, v in table.items() if k not in _self_recursive(k, v, table)}
    limit = max(len(src) * MAX_GROWTH, 1 << 16)
    for _ in range(MAX_PASSES):
        src, changed = _expand_once(src, table)
        if not changed or len(src) > limit:
            break
    return src


def _self_recursive(name: str, macro: Macro, table: dict[str, Macro]) -> set[str]:
    """Detect direct or 1-step mutual recursion to avoid blowup."""
    bad: set[str] = set()
    if re.search(re.escape(name) + r"(?![A-Za-z@])", macro.body):
        bad.add(name)
        return bad
    for other in re.findall(r"\\[A-Za-z@]+", macro.body):
        o = table.get(other)
        if o and re.search(re.escape(name) + r"(?![A-Za-z@])", o.body):
            bad.add(name)
            return bad
    return bad
