# Verbatim copy of theoremsearch_tpu/ingest/methods/plastex_method.py (jax-free). The port imports nothing of the
# reference package, so it carries its own copy; keep the two in sync.
"""plasTeX DOM parse method (gated on the plasTeX package).

Capability-parity with the reference's default method
(ec2/parse_arxiv_papers/plastex_method/parse.py:135): parse the main tex
with plasTeX under a hard wall-clock alarm, walk the DOM for each theorem
environment, rebuild bodies from child source, and reject truncated
no-math fragments. Numbering comes from the DOM's own refs when present,
else from CounterTree replay.
"""

from __future__ import annotations

import re
import signal
from contextlib import contextmanager
from pathlib import Path

from ..latex.declarations import collect_declarations
from ..latex.extract import DEFAULT_THEOREM_ENVS, Theorem
from ..latex.numbering import CounterTree
from ..latex.scanner import strip_comments
from ..main_tex import find_main_tex


class PlasTexUnavailable(RuntimeError):
    pass


@contextmanager
def _alarm(seconds: int):
    """SIGALRM hard timeout (reference parse.py:67-81)."""
    def handler(signum, frame):
        raise TimeoutError(f"plasTeX parse exceeded {seconds}s")

    old = signal.signal(signal.SIGALRM, handler)
    signal.alarm(seconds)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)


def _flag_truncated(body: str) -> bool:
    """Short bodies with no math are usually plasTeX truncation artifacts
    (reference _flag_for_truncation heuristic)."""
    return len(body) < 40 and "$" not in body and "\\(" not in body


def collect_env_nodes_in_order(doc, envs) -> list:
    """All theorem-env nodes in DOCUMENT order via one explicit-stack DOM
    walk. Grouping per env (getElementsByTagName env-by-env) numbers all
    Theorems before any Lemma — interleaved envs sharing a counter then
    contradict the rendered paper. Counter replay requires source order."""
    env_set = set(envs)
    found = []
    stack = [doc]
    while stack:
        node = stack.pop()
        name = getattr(node, "nodeName", None)
        if name in env_set:
            found.append((name, node))
        children = list(getattr(node, "childNodes", []) or [])
        stack.extend(reversed(children))   # preserve document order (DFS)
    return found


def parse_by_plastex(src_dir: str | Path, timeout_s: int = 60) -> list[Theorem]:
    try:
        from plasTeX.TeX import TeX  # gated import
    except ImportError as e:
        raise PlasTexUnavailable("plasTeX is not installed") from e

    src_dir = Path(src_dir)
    main = find_main_tex(src_dir)
    if main is None:
        return []
    src_text = main.read_text(encoding="utf-8", errors="replace")
    decls = collect_declarations(strip_comments(src_text))
    envs = list(dict.fromkeys([d.env for d in decls] + DEFAULT_THEOREM_ENVS))

    tree = CounterTree()
    for d in decls:
        tree.define_env(d.env, d.caption, starred=d.starred, shared=d.shared, within=d.within)

    import os

    old_texinputs = os.environ.get("TEXINPUTS")
    os.environ["TEXINPUTS"] = f"{src_dir}:" + (old_texinputs or "")
    try:
        with _alarm(timeout_s):
            tex = TeX(file=str(main))
            doc = tex.parse()
    finally:
        if old_texinputs is None:
            os.environ.pop("TEXINPUTS", None)
        else:
            os.environ["TEXINPUTS"] = old_texinputs

    out: list[Theorem] = []
    seen_labels: set[str] = set()
    nodes = collect_env_nodes_in_order(doc, envs)
    for env, node in nodes:
        body = "".join(
            getattr(child, "source", "") for child in getattr(node, "childNodes", []) or []
        ).strip()
        if not body or _flag_truncated(body):
            continue
        note = None
        title_attr = getattr(node, "title", None)
        if title_attr is not None:
            note = str(getattr(title_attr, "textContent", title_attr)) or None
        name = tree.begin_env(env, note)
        label = None
        m = re.search(r"\\label\s*\{([^{}]*)\}", body)
        if m:
            body = body.replace(m.group(0), "", 1)
            if m.group(1) and m.group(1) not in seen_labels:
                seen_labels.add(m.group(1))
                label = m.group(1)
        out.append(
            Theorem(name=name, body=re.sub(r"\s+", " ", body).strip(), label=label, env=env, start=0)
        )
    return out
