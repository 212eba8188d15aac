"""Profiling: torch.profiler traces, the program's spans and a
steady-state kernel timer (port of theoremsearch_tpu/utils/profiling.py,
whose `trace` wraps `jax.profiler`).

- `trace(log_dir, device=None)`: a context manager around
  `torch.profiler.profile`, CPU activity and, on the card, CUDA activity;
  on exit the device is synchronized and a Chrome trace
  (`trace-<pid>-<n>.json`, viewable in chrome://tracing or Perfetto) is
  written under `log_dir`. It yields the profiler, whose
  `key_averages()` sums the time by op and kernel.
- `span(name)`: a context manager that marks a stage of the host's work
  in the profiler's trace. While a torch profiler records on this thread
  it is `torch.profiler.record_function(name)`, so the span lands in the
  same Chrome trace as the kernels, on the same clock; otherwise it is one
  check of the profiler's flag and a shared no-op context. Spans live
  only in the profiler's trace: nothing is kept or written unless a
  profiler is recording. Names are `ts.<layer>.<stage>` (`ts.pipeline.page`,
  `ts.encoder.forward`, `ts.engine.scan`, ...); a span's parent is the span
  that encloses it on the thread, and the spans of a path are leaves or
  shallow, so that together they tile the host's time on it.
- `KernelTimer(iters=20)`: the reference's `measure(name, fn, *args)` /
  `report()` surface. On the card: one warm call, then `iters` calls
  between two CUDA events (device time of the queued launches); on the
  CPU: one warm call, then `time.perf_counter` around `iters` calls.

Both default to the card and raise without CUDA, like every entry point
of the port; pass device="cpu" for a CPU run.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import tempfile
import time
from contextlib import contextmanager
from dataclasses import dataclass, field

import torch

from .device import resolve_device

_trace_seq = itertools.count()

# the C++ flag that record_function itself obeys: true only while a
# profiler records on the calling thread
_profiler_on = torch._C._autograd._profiler_enabled
_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """`record_function(name)` while a profiler records on this thread, else
    the shared no-op context (an unguarded record_function costs a
    dispatcher call even with no profiler)."""
    if _profiler_on():
        return torch.profiler.record_function(name)
    return _NO_SPAN


@contextmanager
def trace(log_dir: str | None = None, device=None):
    """Profile the block; write its Chrome trace under `log_dir` (default:
    `torch-trace` in the temporary directory). Yields the profiler; its
    `trace_path` attribute names the file once the block has ended."""
    dev = resolve_device(device)
    log_dir = log_dir or os.path.join(tempfile.gettempdir(), "torch-trace")
    acts = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    os.makedirs(log_dir, exist_ok=True)
    prof.trace_path = os.path.join(log_dir, f"trace-{os.getpid()}-{next(_trace_seq)}.json")
    prof.export_chrome_trace(prof.trace_path)


@dataclass
class KernelTimer:
    """Steady-state seconds a call of a function, by name."""

    iters: int = 20
    device: object = None
    records: dict = field(default_factory=dict)

    def __post_init__(self) -> None:
        self.device = resolve_device(self.device)

    def measure(self, name: str, fn, *args) -> float:
        """Seconds a call of fn(*args), over `iters` calls after a warm one."""
        fn(*args)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            for _ in range(self.iters):
                fn(*args)
            end.record()
            end.synchronize()
            dt = start.elapsed_time(end) / 1e3 / self.iters
        else:
            t0 = time.perf_counter()
            for _ in range(self.iters):
                fn(*args)
            dt = (time.perf_counter() - t0) / self.iters
        self.records[name] = dt
        return dt

    def report(self) -> str:
        return "\n".join(f"{k}: {v*1e3:.3f} ms" for k, v in sorted(self.records.items()))
