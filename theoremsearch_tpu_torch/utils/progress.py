# Verbatim copy of theoremsearch_tpu/utils/progress.py (jax-free). The port imports nothing of the
# reference package, so it carries its own copy; keep the two in sync.
"""Progress reporting: tqdm with live postfix when available (the
reference's UX — parse-rate / cost postfixes, e.g.
ec2/parse_arxiv_papers/__main__.py:267), plain-iterator fallback."""

from __future__ import annotations


def progress(iterable=None, total=None, desc: str = ""):
    try:
        from tqdm import tqdm

        return tqdm(iterable, total=total, desc=desc)
    except ImportError:
        class _Plain:
            # enough of tqdm's surface to be a drop-in where the
            # package idioms are used: iteration, context manager,
            # update/postfix/description no-ops
            def __init__(self, it):
                self.it = it

            def __iter__(self):
                return iter(self.it if self.it is not None else range(total or 0))

            def __enter__(self):
                return self

            def __exit__(self, *exc):
                return False

            def set_postfix(self, *a, **k):
                pass

            def set_description(self, *a, **k):
                pass

            def update(self, n=1):
                pass

            def close(self):
                pass

        return _Plain(iterable)
