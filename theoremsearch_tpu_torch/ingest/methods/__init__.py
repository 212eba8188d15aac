# Verbatim copy of theoremsearch_tpu/ingest/methods/__init__.py (jax-free). The port imports nothing of the
# reference package, so it carries its own copy; keep the two in sync.
"""Alternative parse methods (parity with the reference's three methods,
ec2/parse_arxiv_papers/__main__.py --parsing-method {tex,regex,plastex}):

- scanner (default): the pure-Python cursor extractor (latex/extract.py);
- tex_capture: instrumented-compile method — inject a capture package and
  run the document through pdflatex (gated on the binary);
- flatten: python-native \\input inliner + scanner (the working version
  of the reference's latexdiff-flatten streaming method, whose comment/
  verbatim/macro handling was left as stubs);
- plastex: DOM walk via plasTeX (gated on the package).
"""

from .flatten import inline_inputs, parse_by_flatten
from .tex_capture import (
    generate_capture_package,
    inject_package,
    parse_capture_log,
    parse_by_tex,
)

__all__ = [
    "inline_inputs",
    "parse_by_flatten",
    "generate_capture_package",
    "inject_package",
    "parse_capture_log",
    "parse_by_tex",
]
