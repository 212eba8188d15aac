# Verbatim copy of theoremsearch_tpu/ingest/methods/tex_capture.py (jax-free). The port imports nothing of the
# reference package, so it carries its own copy; keep the two in sync.
"""Instrumented-compile parse method.

Capability-parity with the reference's tex_method (ec2/parse_arxiv_papers/
tex_method/: thmenvcapture.py generates a capture package, pdflatex.py
compiles with -draftmode and stubs missing packages until the compile
sticks, parse.py reads the capture log). Having TeX itself expand macros
gives the highest-fidelity bodies of any method.

This implementation:
- generates a capture package that RenewEnviron-wraps each declared
  theorem env and writes BEGIN/env/note/body/END records to
  \\jobname.thmcap (numbering is NOT done in TeX — the captured sequence
  is replayed through our CounterTree, which already implements amsthm
  semantics);
- injects \\usepackage{thmcapture} before \\begin{document};
- runs pdflatex -draftmode -interaction=nonstopmode with a
  missing-package stub loop (any missing .sty becomes an empty stub and
  the compile retries, bounded);
- the compiler invocation is injectable, so the whole method is testable
  without a TeX installation; at runtime it is gated on `pdflatex` being
  on PATH.
"""

from __future__ import annotations

import re
import shutil
import subprocess
from pathlib import Path
from typing import Callable, Sequence

from ..latex.declarations import collect_declarations
from ..latex.extract import DEFAULT_THEOREM_ENVS, Theorem, _LABEL_RE
from ..latex.numbering import CounterTree
from ..latex.scanner import strip_comments
from ..main_tex import find_main_tex

PACKAGE_NAME = "thmcapture"
BEGIN_MARK = "@@THMCAP-BEGIN@@"
END_MARK = "@@THMCAP-END@@"
SECTION_MARK = "@@THMCAP-SEC@@"
MAX_STUB_RETRIES = 12


def generate_capture_package(envs: Sequence[str]) -> str:
    """LaTeX package text wrapping each env to log its body verbatim."""
    lines = [
        f"\\ProvidesPackage{{{PACKAGE_NAME}}}",
        "\\RequirePackage{environ}",
        "\\newwrite\\thmcapout",
        "\\immediate\\openout\\thmcapout=\\jobname.thmcap",
        # log section boundaries so numbering replay can step counters
        "\\let\\thmcapOldSection\\section",
        "\\renewcommand{\\section}{\\immediate\\write\\thmcapout{" + SECTION_MARK + "|section}\\thmcapOldSection}",
        "\\let\\thmcapOldAppendix\\appendix",
        "\\renewcommand{\\appendix}{\\immediate\\write\\thmcapout{" + SECTION_MARK + "|appendix}\\thmcapOldAppendix}",
    ]
    for env in envs:
        safe = env.replace("*", "")
        lines += [
            f"\\ifcsname {safe}\\endcsname",
            f"\\RenewEnviron{{{safe}}}[1][]{{%",
            f"  \\immediate\\write\\thmcapout{{{BEGIN_MARK}|{safe}|#1}}%",
            "  \\immediate\\write\\thmcapout{\\unexpanded\\expandafter{\\BODY}}%",
            f"  \\immediate\\write\\thmcapout{{{END_MARK}}}%",
            "}%",
            "\\fi",
        ]
    lines.append("\\endinput")
    return "\n".join(lines) + "\n"


def inject_package(main_tex_text: str) -> str:
    """\\usepackage{thmcapture} immediately before \\begin{document}."""
    m = re.search(r"\\begin\s*\{document\}", main_tex_text)
    inj = f"\\usepackage{{{PACKAGE_NAME}}}\n"
    if not m:
        return inj + main_tex_text
    return main_tex_text[: m.start()] + inj + main_tex_text[m.start():]


_MISSING_STY_RE = re.compile(r"! LaTeX Error: File `([^']+\.(?:sty|cls))' not found")


def run_pdflatex_with_stubs(
    main_tex: Path,
    runner: Callable[[list[str], Path], "subprocess.CompletedProcess | object"] | None = None,
    timeout_s: float = 60.0,
) -> bool:
    """Compile, stubbing any missing package and retrying (reference
    pdflatex.py:50-98 behavior). Returns True when a compile completes
    without a missing-file error. `runner(cmd, cwd)` is injectable."""

    def default_runner(cmd, cwd):
        return subprocess.run(
            cmd, cwd=cwd, capture_output=True, text=True, timeout=timeout_s
        )

    runner = runner or default_runner
    cwd = main_tex.parent
    # -no-shell-escape: arXiv sources are untrusted; restricted \write18
    # is on by default and is an avoidable execution surface
    cmd = [
        "pdflatex", "-draftmode", "-interaction=nonstopmode",
        "-halt-on-error", "-no-shell-escape", main_tex.name,
    ]
    for _ in range(MAX_STUB_RETRIES):
        proc = runner(cmd, cwd)
        out = (getattr(proc, "stdout", "") or "") + (getattr(proc, "stderr", "") or "")
        missing = _MISSING_STY_RE.search(out)
        if missing:
            stub = cwd / missing.group(1)
            if not stub.exists():
                stub.write_text(f"\\ProvidesPackage{{{stub.stem}}}\n\\endinput\n")
                continue
            return False  # stubbed but still reported missing: give up
        return getattr(proc, "returncode", 1) == 0 or (cwd / _capname(main_tex)).exists()
    return False


def _capname(main_tex: Path) -> str:
    return main_tex.stem + ".thmcap"


def parse_capture_log(log_text: str, declarations_src: str) -> list[Theorem]:
    """Replay capture records through the CounterTree to render names."""
    tree = CounterTree()
    for d in collect_declarations(strip_comments(declarations_src)):
        tree.define_env(d.env, d.caption, starred=d.starred, shared=d.shared, within=d.within)

    out: list[Theorem] = []
    seen_labels: set[str] = set()
    lines = log_text.splitlines()
    i = 0
    while i < len(lines):
        line = lines[i]
        if line.startswith(SECTION_MARK):
            kind = line.split("|", 1)[1] if "|" in line else "section"
            if kind == "appendix":
                tree.enter_appendix()
            else:
                tree.step_structural("section")
            i += 1
            continue
        if line.startswith(BEGIN_MARK):
            _, env, note = (line.split("|", 2) + ["", ""])[:3]
            body_lines = []
            i += 1
            while i < len(lines) and not lines[i].startswith(END_MARK):
                body_lines.append(lines[i])
                i += 1
            body = " ".join(body_lines)
            name = tree.begin_env(env, note or None)
            label = None
            m = _LABEL_RE.search(body)
            if m:
                body = body.replace(m.group(0), "", 1)
                if m.group(1) and m.group(1) not in seen_labels:
                    seen_labels.add(m.group(1))
                    label = m.group(1)
            body = re.sub(r"\s+", " ", body).strip()
            if body:
                out.append(Theorem(name=name, body=body, label=label, env=env, start=i))
        i += 1
    return out


def parse_by_tex(
    src_dir: str | Path,
    runner=None,
) -> list[Theorem]:
    """Full instrumented-compile method over an extracted source tree.
    Requires pdflatex on PATH unless a runner is injected."""
    if runner is None and shutil.which("pdflatex") is None:
        raise RuntimeError("pdflatex not available; use parsing method 'scanner'")
    src_dir = Path(src_dir)
    main = find_main_tex(src_dir)
    if main is None:
        return []
    src_text = main.read_text(encoding="utf-8", errors="replace")
    decls = collect_declarations(strip_comments(src_text))
    envs = list(dict.fromkeys([d.env for d in decls] + DEFAULT_THEOREM_ENVS))

    (main.parent / f"{PACKAGE_NAME}.sty").write_text(generate_capture_package(envs))
    patched = main.parent / f"__thmcap_{main.name}"
    patched.write_text(inject_package(src_text))

    if not run_pdflatex_with_stubs(patched, runner=runner):
        return []
    cap = patched.parent / _capname(patched)
    if not cap.exists():
        return []
    return parse_capture_log(cap.read_text(encoding="utf-8", errors="replace"), src_text)
