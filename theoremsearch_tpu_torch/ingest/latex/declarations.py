# Verbatim copy of theoremsearch_tpu/ingest/latex/declarations.py (jax-free). The port imports nothing of the
# reference package, so it carries its own copy; keep the two in sync.
"""Theorem-environment declaration parsing.

Collects every way papers declare theorem-like environments (parity with
the reference's extractors: ec2/parse_arxiv_papers/tex_method/
extract_from_tex.py:20-48 handles \\newtheorem, \\declaretheorem,
\\spnewtheorem, \\newmdtheoremenv; ec2/parse_papers/latex_parse.py:128
wraps \\newenvironment around declared envs):

    \\newtheorem{env}[shared]{Caption}[within]
    \\newtheorem*{env}{Caption}
    \\declaretheorem[name=..., sibling=..., numberwithin=..., ...]{env}
    \\spnewtheorem{env}[shared]{Caption}{font}{font} (+ starred)
    \\newmdtheoremenv[mdopts]{env}[shared]{Caption}[within]
    \\newenvironment{alias}{...\\begin{env}...}{...}  -> alias of env

Position-aware: [shared] appears between {env} and {Caption}; [within]
after {Caption}. Returns Declaration records in source order.
"""

from __future__ import annotations

import re
from dataclasses import dataclass

from .scanner import read_group, read_optional, skip_ws


@dataclass
class Declaration:
    env: str
    caption: str
    starred: bool = False
    shared: str | None = None
    within: str | None = None
    pos: int = 0


def _parse_newtheorem_like(src: str, command: str, extra_groups: int = 0):
    """Shared shape: \\cmd(*){env}[shared]{Caption}[within] {extra}..."""
    out = []
    pat = re.compile(rf"\\{command}(\*)?(?![A-Za-z@])")
    for m in pat.finditer(src):
        i = skip_ws(src, m.end())
        # \newmdtheoremenv takes a leading [mdframed options]
        lead = read_optional(src, i)
        if lead is not None and command == "newmdtheoremenv":
            i = lead[1]
        r_env = read_group(src, skip_ws(src, i))
        if r_env is None:
            continue
        env, i = r_env
        shared = None
        r_sh = read_optional(src, i)
        if r_sh is not None:
            shared, i = r_sh
        r_cap = read_group(src, skip_ws(src, i))
        if r_cap is None:
            continue
        caption, i = r_cap
        for _ in range(extra_groups):
            r_x = read_group(src, skip_ws(src, i))
            if r_x is None:
                break
            i = r_x[1]
        within = None
        r_w = read_optional(src, i)
        if r_w is not None:
            within, i = r_w
        starred = bool(m.group(1))
        if starred:
            shared = within = None
        out.append(
            Declaration(
                env=env.strip(),
                caption=caption.strip() or env.strip().capitalize(),
                starred=starred,
                shared=(shared or "").strip() or None,
                within=(within or "").strip() or None,
                pos=m.start(),
            )
        )
    return out


_KEYVAL_RE = re.compile(r"([A-Za-z-]+)\s*=\s*(\{[^{}]*\}|[^,]*)")


def _parse_declaretheorem(src: str):
    out = []
    pat = re.compile(r"\\declaretheorem(?![A-Za-z@])")
    for m in pat.finditer(src):
        i = m.end()
        opts = {}
        r_opt = read_optional(src, i)
        if r_opt is not None:
            body, i = r_opt
            for k, v in _KEYVAL_RE.findall(body):
                opts[k.lower()] = v.strip().strip("{}")
        r_env = read_group(src, skip_ws(src, i))
        if r_env is None:
            continue
        env = r_env[0].strip()
        starred = opts.get("numbered", "").lower() == "no" or "unnumbered" in opts
        out.append(
            Declaration(
                env=env,
                caption=opts.get("name") or opts.get("title") or env.capitalize(),
                starred=starred,
                shared=opts.get("sibling") or opts.get("sharenumber"),
                within=opts.get("numberwithin") or opts.get("parent") or opts.get("within"),
                pos=m.start(),
            )
        )
    return out


def _parse_env_aliases(src: str, known: dict[str, Declaration]):
    """\\newenvironment{alias}{..\\begin{thmenv}..}{..}: alias inherits
    thmenv's numbering (reference latex_parse.py:128-157)."""
    out = []
    pat = re.compile(r"\\newenvironment\*?(?![A-Za-z@])")
    for m in pat.finditer(src):
        i = skip_ws(src, m.end())
        r_name = read_group(src, i)
        if r_name is None:
            continue
        alias, i = r_name
        # skip the [num][default] args
        for _ in range(2):
            r_o = read_optional(src, i)
            if r_o is None:
                break
            i = r_o[1]
        r_begin = read_group(src, skip_ws(src, i))
        if r_begin is None:
            continue
        begin_code, i = r_begin
        for env, decl in known.items():
            if re.search(rf"\\begin\s*\{{{re.escape(env)}\}}|\\{re.escape(env)}(?![A-Za-z@])", begin_code):
                out.append(
                    Declaration(
                        env=alias.strip(),
                        caption=decl.caption,
                        starred=decl.starred,
                        shared=decl.shared or (None if decl.starred else env),
                        within=decl.within,
                        pos=m.start(),
                    )
                )
                break
    return out


def newenvironment_regions(src: str) -> list[tuple[int, int]]:
    """(start, end) source ranges of \\newenvironment definitions, so the
    span scanner can blank them — their begin/end code contains literal
    \\begin{env} text that is a definition, not a document occurrence."""
    out = []
    pat = re.compile(r"\\(?:new|renew)environment\*?(?![A-Za-z@])")
    for m in pat.finditer(src):
        i = skip_ws(src, m.end())
        r_name = read_group(src, i)
        if r_name is None:
            continue
        i = r_name[1]
        for _ in range(2):
            r_o = read_optional(src, i)
            if r_o is None:
                break
            i = r_o[1]
        ok = True
        for _ in range(2):  # {begin}{end}
            r_g = read_group(src, skip_ws(src, i))
            if r_g is None:
                ok = False
                break
            i = r_g[1]
        if ok:
            out.append((m.start(), i))
    return out


def collect_declarations(src: str) -> list[Declaration]:
    decls: list[Declaration] = []
    decls += _parse_newtheorem_like(src, "newtheorem")
    decls += _parse_newtheorem_like(src, "newmdtheoremenv")
    decls += _parse_newtheorem_like(src, "spnewtheorem", extra_groups=2)
    decls += _parse_declaretheorem(src)
    known = {}
    for d in sorted(decls, key=lambda d: d.pos):
        known.setdefault(d.env, d)
    decls += _parse_env_aliases(src, known)
    decls.sort(key=lambda d: d.pos)
    return decls
