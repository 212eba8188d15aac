# Verbatim copy of theoremsearch_tpu/serve/latex_display.py (jax-free). The reference package's
# __init__ imports jax, so the port carries its own copy; keep the two in sync.
"""LaTeX -> display-markdown cleanup.

Capability-parity with the reference display cleaner (latex_clean.py:39-159):
repair truncated bodies (unclosed \\end{env, unbalanced $ / \\[ / {),
strip definition and reference noise (newcommand/label/cite/footnote),
normalize display math (align family -> $$\\begin{aligned}$$, \\[..\\] ->
$$..$$, \\(..\\) -> $..$), itemize/enumerate -> markdown bullets, and
isolate $$ blocks with blank-line padding so markdown renderers treat
them as display math.

Independent implementation: a small segment-based pass over the text
(math segments are split out once and transformed in place).
"""

from __future__ import annotations

import re

_ALIGN_FAMILY = ("align", "gather", "multline", "flalign", "eqnarray")


def _repair_truncation(text: str) -> str:
    text = text.replace("\r\n", "\n").replace("\r", "\n")
    # "\end{align" (missing brace) -> "\end{align}"
    text = re.sub(r"(\\end\{[A-Za-z]+\*?)(?=\s|$)", r"\1}", text)
    if text.count("$") % 2:
        text = text.rstrip() + "$"
    # unbalanced braces / brackets / parens appended at the end
    if text.count("{") > text.count("}"):
        text = text.rstrip() + "\\}"
    if text.count("[") > text.count("]"):
        text = text.rstrip() + "]"
    if text.count("(") > text.count(")"):
        text = text.rstrip() + ")"
    return text


_NOISE_DEF_RE = re.compile(
    r"\\(?:DeclareMathOperator|newcommand|renewcommand)\*?\s*\{[^{}]+\}"
    r"(?:\s*\[\d+\])?(?:\s*\[[^\]]*\])?\s*\{(?:[^{}]|\{[^{}]*\})*\}",
    re.DOTALL,
)
_NOISE_REF_RE = re.compile(r"\\(?:label|ref|eqref|cite|footnote|footnotetext|alert)\{[^}]*\}")


def _normalize_align_family(text: str) -> str:
    for env in _ALIGN_FAMILY:
        pat = re.compile(
            rf"\\begin\{{{env}(\*)?\}}(.*?)(?:\\end\{{{env}\1?\}}|\\end\{{{env}\*?\}}|\Z)",
            re.DOTALL,
        )

        def sub(m: re.Match) -> str:
            body = m.group(2)
            body = re.sub(r"\\tag\{[^}]*\}", "", body)
            body = re.sub(r"\\(?:nonumber|notag)\b", "", body)
            body = re.sub(r"\\label\{[^}]*\}", "", body)
            body = body.strip()
            if body.endswith("\\\\"):
                body = body[:-2].rstrip()
            return f"$$\n\\begin{{aligned}}\n{body}\n\\end{{aligned}}\n$$"

        text = pat.sub(sub, text)
    return text


def clean_latex_for_display(text: str) -> str:
    if not text:
        return text
    text = _repair_truncation(text)
    text = _NOISE_DEF_RE.sub("", text)
    text = _NOISE_REF_RE.sub("", text)
    text = _normalize_align_family(text)
    # display/inline math delimiters
    text = re.sub(r"\\\[\s*(.*?)\s*\\\]", r"$$\n\1\n$$", text, flags=re.DOTALL)
    text = re.sub(r"\\\(\s*(.*?)\s*\\\)", r"$\1$", text, flags=re.DOTALL)
    # lists -> bullets
    text = re.sub(r"\\(?:begin|end)\{(?:enumerate|itemize)\}", "", text)
    text = re.sub(r"^[ \t]*\\item[ \t]*", "- ", text, flags=re.MULTILINE)

    # wrap stray &-aligned lines (outside $$ blocks) as aligned math
    parts = re.split(r"(\$\$[\s\S]*?\$\$)", text)
    for i in range(0, len(parts), 2):
        lines = parts[i].split("\n")
        for j, ln in enumerate(lines):
            if "&" in ln and not ln.strip().startswith(("-", "$")):
                lines[j] = f"$$\n\\begin{{aligned}}\n{ln}\n\\end{{aligned}}\n$$"
        parts[i] = "\n".join(lines)
    text = "".join(parts)

    # isolate $$ blocks with blank-line padding
    parts = re.split(r"(\$\$[\s\S]*?\$\$)", text)
    for i in range(1, len(parts), 2):
        block = parts[i]
        inner = block[2:-2].strip()
        parts[i] = f"$$\n{inner}\n$$"
        if i - 1 >= 0:
            parts[i - 1] = parts[i - 1].rstrip() + "\n\n"
        if i + 1 < len(parts):
            parts[i + 1] = "\n\n" + parts[i + 1].lstrip()
    text = "".join(parts)

    return re.sub(r"\n{3,}", "\n\n", text).strip()
