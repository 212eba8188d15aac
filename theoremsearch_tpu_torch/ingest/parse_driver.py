# Verbatim copy of theoremsearch_tpu/ingest/parse_driver.py (jax-free). The port imports nothing of the
# reference package, so it carries its own copy; keep the two in sync.
"""Parse driver: fan papers out to isolated worker processes with hard
timeouts, replace-then-upsert per paper, resumable work selection.

Capability-parity with the reference driver (ec2/parse_arxiv_papers/
__main__.py:128-288):
- work queue = papers with no theorems yet (catalog.unparsed_papers);
- each paper parsed in a FRESH child process with a hard timeout
  (join -> terminate -> kill) so pathological TeX can't wedge a worker
  (reference _parse_with_hard_timeout :54-103);
- per-paper delete-then-insert of theorems tagged with parsing_method;
- per-page commit = checkpoint; a crashed driver resumes from the queue;
- debugging mode keeps work dirs and re-raises.
"""

from __future__ import annotations

import multiprocessing as mp
import queue as queue_mod
import shutil
import sys
import tempfile
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Callable

from .catalog import Catalog
from .latex.extract import extract_file
from .main_tex import find_main_tex
from .sources import extract_source_tree, fetch_paper_source


@dataclass
class ParseStats:
    parsed: int = 0
    failed: int = 0
    timeouts: int = 0
    theorems: int = 0

    @property
    def parse_rate(self) -> float:
        total = self.parsed + self.failed + self.timeouts
        return self.parsed / total if total else 0.0


def parse_source_tree(src_dir: str | Path, method: str = "scanner") -> list[dict]:
    """Extract theorems from a paper source tree with the chosen method
    (scanner | flatten | tex | plastex — the reference's --parsing-method
    choices, ec2/parse_arxiv_papers/__main__.py:290-321)."""
    main = find_main_tex(src_dir)
    if main is None:
        return []
    if method == "scanner":
        thms = extract_file(str(main))
    elif method == "flatten":
        from .methods.flatten import parse_by_flatten

        thms = parse_by_flatten(main)
    elif method == "tex":
        from .methods.tex_capture import parse_by_tex

        thms = parse_by_tex(src_dir)
    elif method == "plastex":
        from .methods.plastex_method import parse_by_plastex

        thms = parse_by_plastex(src_dir)
    else:
        raise ValueError(f"unknown parsing method {method!r}")
    return [{"name": t.name, "body": t.body, "label": t.label} for t in thms]


def _worker_entry(src_dir: str, method: str, queue: mp.Queue) -> None:
    try:
        queue.put(("ok", parse_source_tree(src_dir, method)))
    except Exception as e:  # noqa: BLE001
        queue.put(("err", repr(e)[:300]))


def parse_with_hard_timeout(src_dir: str | Path, timeout_s: float = 30.0, method: str = "scanner"):
    """Run extraction in a fresh kill-able child process.
    Returns (status, rows) with status in {ok, err, timeout}."""
    ctx = mp.get_context("fork" if sys.platform != "win32" else "spawn")
    queue: mp.Queue = ctx.Queue()
    proc = ctx.Process(target=_worker_entry, args=(str(src_dir), method, queue))
    proc.start()
    # Drain the queue BEFORE joining: when the serialized payload exceeds
    # the OS pipe buffer (~64KB — common for theorem-dense papers), the
    # child's queue feeder thread blocks until a reader drains it, so a
    # join-first driver misclassifies the paper as a timeout and silently
    # drops all its theorems.
    deadline = time.monotonic() + timeout_s
    result = None
    while result is None:
        remaining = deadline - time.monotonic()
        try:
            result = queue.get(timeout=max(0.02, min(0.25, remaining)))
        except queue_mod.Empty:
            if remaining <= 0:
                break
            if not proc.is_alive():
                # child exited between polls; one final non-blocking read
                try:
                    result = queue.get_nowait()
                except queue_mod.Empty:
                    pass
                break
    if result is None:
        timed_out = proc.is_alive()
        proc.terminate()
        proc.join(2.0)
        if proc.is_alive():
            proc.kill()
            proc.join()
        return ("timeout" if timed_out else "err"), []
    proc.join(5.0)
    if proc.is_alive():
        proc.terminate()
        proc.join()
    status, payload = result
    return (status, payload if status == "ok" else [])


def parse_papers(
    catalog: Catalog,
    source_fetcher: Callable[[str], bytes] | None = None,
    timeout_s: float = 30.0,
    page_size: int = 32,
    limit: int | None = None,
    parsing_method: str = "scanner",   # scanner | flatten | tex | plastex
    debug: bool = False,
    verbose: bool = False,
) -> ParseStats:
    """Drain the unparsed-paper queue.

    source_fetcher(paper_id) -> raw (gzipped) source bytes; defaults to
    the S3-ranged/arxiv.org fetcher using catalog byte ranges."""
    stats = ParseStats()

    def default_fetcher(paper_id: str) -> bytes:
        row = catalog.conn.execute(
            "SELECT bundle_tar, offset_start, offset_end FROM paper_arxiv_s3_location"
            " WHERE paper_id = ?",
            (paper_id,),
        ).fetchone()
        loc = (row[0], row[1], row[2]) if row else None
        return fetch_paper_source(paper_id, loc)

    fetcher = source_fetcher or default_fetcher
    done = 0
    for page in catalog.unparsed_papers(page_size):
        for row in page:
            if limit is not None and done >= limit:
                return stats
            paper_id = row["paper_id"]
            done += 1
            work = Path(tempfile.mkdtemp(prefix=f"parse_{paper_id.replace('/', '_')}_"))
            try:
                data = fetcher(paper_id)
                src = extract_source_tree(data, work / "src")
                status, thms = parse_with_hard_timeout(src, timeout_s, parsing_method)
                if status == "ok":
                    catalog.replace_theorems(paper_id, thms, parsing_method)
                    stats.parsed += 1
                    stats.theorems += len(thms)
                elif status == "timeout":
                    stats.timeouts += 1
                    catalog.record_parse_failure(paper_id, "timeout")
                    if verbose:
                        print(f"[TIMEOUT] {paper_id}")
                else:
                    stats.failed += 1
                    catalog.record_parse_failure(paper_id, "err")
                    if verbose:
                        print(f"[PARSE ERROR] {paper_id}")
            except Exception as e:  # noqa: BLE001
                stats.failed += 1
                if verbose:
                    print(f"[FETCH ERROR] {paper_id}: {repr(e)[:200]}")
                if debug:
                    raise
            finally:
                if not debug:
                    shutil.rmtree(work, ignore_errors=True)
    return stats
