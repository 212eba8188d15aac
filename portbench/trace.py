"""The traced sub-window: torch.profiler over CPU and CUDA activity,
started and stopped by the loop, reduced from its Chrome trace to what
the per-layer readers and the result's `breakdown` need.

Device time is the union of the intervals of kernels, copies and sets on
the card, clipped to the window that the `portbench.window` annotation
spans. An idle gap is labelled by the host event (op, runtime call or
benchmark span, any thread) that overlaps it most."""

from __future__ import annotations

import json
import os
import tempfile
import threading

_DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset"}
_HOST_CATS = {"cpu_op", "cuda_runtime", "cuda_driver", "user_annotation"}
WINDOW = "portbench.window"


class Tracer:
    """profile() between start() and stop(), both on one thread."""

    def __init__(self, cuda: bool = True):
        import torch

        self._torch = torch
        self.cuda = cuda
        self.prof = None
        self._ann = None
        self.summary = None
        self.lock = threading.Lock()

    def warm(self) -> None:
        """Start and stop the profiler once, outside the window: its first
        start initializes the tracing library, which takes seconds."""
        acts = [self._torch.profiler.ProfilerActivity.CPU]
        if self.cuda:
            acts.append(self._torch.profiler.ProfilerActivity.CUDA)
        with self._torch.profiler.profile(activities=acts):
            self._torch.zeros(1).add_(1)

    def start(self) -> None:
        t = self._torch
        acts = [t.profiler.ProfilerActivity.CPU]
        if self.cuda:
            acts.append(t.profiler.ProfilerActivity.CUDA)
        self.prof = t.profiler.profile(activities=acts)
        self.prof.start()
        self._ann = t.profiler.record_function(WINDOW)
        self._ann.__enter__()

    def stop(self) -> None:
        if self.cuda:
            self._torch.cuda.synchronize()
        self._ann.__exit__(None, None, None)
        self.prof.stop()
        fd, path = tempfile.mkstemp(prefix="portbench-trace-", suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)
        finally:
            os.unlink(path)
        self.prof = None
        self.summary = summarize(events.get("traceEvents", events))


def _merge(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def summarize(events: list) -> dict:
    """{window_s, busy_s, device: [(cat, name, ts, dur, args)], device_ops,
    idle_gaps} of one trace, times in seconds, device events clipped to
    the window (µs in the trace)."""
    win = [e for e in events if e.get("ph") == "X" and e.get("name") == WINDOW
           and e.get("cat") == "user_annotation"]
    if not win:
        raise RuntimeError("the trace holds no window annotation")
    w0 = float(win[0]["ts"])
    w1 = w0 + float(win[0]["dur"])
    dev, host = [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat = e.get("cat", "")
        a = float(e["ts"])
        b = a + float(e["dur"])
        if cat in _DEVICE_CATS:
            a, b = max(a, w0), min(b, w1)
            if b > a:
                dev.append((cat, e.get("name", ""), a, b - a, e.get("args", {})))
        elif cat in _HOST_CATS and e.get("name") != WINDOW and b > w0 and a < w1:
            host.append((a, b, e.get("name", "")))
    busy = _merge([(a, a + d) for _, _, a, d, _ in dev])
    busy_us = sum(b - a for a, b in busy)
    by_name: dict[str, float] = {}
    for _, name, _, d, _ in dev:
        by_name[name] = by_name.get(name, 0.0) + d
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    gaps = []
    edge = w0
    for a, b in busy + [[w1, w1]]:
        if a > edge:
            gaps.append((edge, a))
        edge = max(edge, b)
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:10]
    labelled = []
    for g0, g1 in gaps:
        best, label = 0.0, "no host event recorded"
        for a, b, name in host:
            ov = min(b, g1) - max(a, g0)
            if ov > best:
                best, label = ov, name
        labelled.append([label[:120], (g1 - g0) / 1e6])
    return {"window_s": (w1 - w0) / 1e6, "busy_s": busy_us / 1e6, "device": dev,
            "device_ops": [[n[:120], d / 1e6] for n, d in ops], "idle_gaps": labelled}


def kernels(summary: dict, needle: str) -> list:
    """The window's kernels whose name holds `needle`: (name, dur_s, args)."""
    return [(name, d / 1e6, args) for cat, name, _, d, args in summary["device"]
            if cat == "kernel" and needle in name]
