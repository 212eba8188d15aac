# Verbatim copy of theoremsearch_tpu/utils/tracing.py (jax-free). The port imports nothing of the
# reference package, so it carries its own copy; keep the two in sync.
"""Structured tracing.

The reference optionally traces slogan generation through Langfuse
(span + generation observations with token usage, cost, latency —
ec2/generate_slogans/slogans.py:36-67,90-102). Here tracing is a small
local-first interface: spans with attributes flushed as JSONL, a null
tracer by default, and a Langfuse adapter when that package is installed
and configured. Kernel-level profiling uses jax.profiler (utils/profiling).
"""

from __future__ import annotations

import json
import time
import threading
from contextlib import contextmanager
from pathlib import Path
from typing import Any


class NullTracer:
    @contextmanager
    def span(self, name: str, **attrs):
        yield self

    def event(self, name: str, **attrs) -> None:
        pass

    def flush(self) -> None:
        pass


class JsonlTracer:
    """Appends one JSON object per span/event; thread-safe."""

    def __init__(self, path: str | Path):
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._lock = threading.Lock()
        self._buf: list[dict] = []

    @contextmanager
    def span(self, name: str, **attrs):
        t0 = time.time()
        record: dict[str, Any] = {"type": "span", "name": name, "start": t0, **attrs}
        try:
            yield record
        except Exception as e:
            record["error"] = str(e)
            raise
        finally:
            record["latency_s"] = time.time() - t0
            with self._lock:
                self._buf.append(record)

    def event(self, name: str, **attrs) -> None:
        with self._lock:
            self._buf.append({"type": "event", "name": name, "time": time.time(), **attrs})

    def flush(self) -> None:
        with self._lock:
            buf, self._buf = self._buf, []
        if buf:
            with open(self.path, "a", encoding="utf-8") as f:
                for r in buf:
                    f.write(json.dumps(r, default=str) + "\n")


class LangfuseTracer:
    """Adapter to Langfuse when available (parity with the reference's
    -lf flag, generate_slogans/__main__.py:282-288)."""

    def __init__(self):
        from langfuse import Langfuse  # gated import

        self.lf = Langfuse()

    @contextmanager
    def span(self, name: str, **attrs):
        with self.lf.start_as_current_observation(as_type="span", name=name, metadata=attrs) as s:
            yield s

    def event(self, name: str, **attrs) -> None:
        pass

    def flush(self) -> None:
        self.lf.flush()


Tracer = NullTracer | JsonlTracer | LangfuseTracer


def get_tracer(kind: str | None = None, path: str | Path = "traces.jsonl"):
    if kind == "jsonl":
        return JsonlTracer(path)
    if kind == "langfuse":
        try:
            return LangfuseTracer()
        except Exception:
            return NullTracer()
    return NullTracer()
