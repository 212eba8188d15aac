"""The port's spans in a traced window: which layer the host was in while
the card idled, and which layer launched the card's work.

The port marks its host stages with `ts.<layer>.<stage>` annotations
(`theoremsearch_tpu_torch/utils/profiling.py:span`), which land in the
profiler's Chrome trace beside the kernels. `attribute(events)` reduces a
trace over the window that the `portbench.window` annotation spans:

- `spans`: each `ts.*` name with the spans that start in the window
  (`count`) and their host seconds inside it (`host_s`);
- `idle_by_span`: each idle second of the card (outside the union of
  kernels, copies and sets) charged to the innermost `ts.*` span that
  covers it on any thread (the one that started last), else to
  `"outside"`; the entries sum to the window's idle time;
- `device_by_span`: each kernel's, copy's and set's seconds in the window
  charged to the innermost `ts.*` span, on the launching thread, that
  holds the runtime call with the same `correlation` id, else to
  `"outside"`.

`readings` turns that, with `BatchedEncoder.stats()` at the window's start
and end, into the quantities that the per-layer metrics `pipeline_idle`,
`encoder_host_idle`, `encoder_pad_share`, `engine_host_idle` and
`rescore_span_ms` are to report (PERF.md §7: the benchmark's summary
keeps no host events yet, so they are readings, not metrics).

Run one cell once, traced, with the reduction (on the card; `--device cpu`
for a rehearsal):

    python3 portbench/spans.py --workload qwen3-emb-0.6b.embed-slogans --seed 7 \\
        --seconds 30 [--trace-offset 24] [--trace-seconds 4] [--out spans.json]

It prints one JSON line: the cell's result line (`line`), the reduction
(`spans`), the encoder's counters over the window (`encoder`), the
readings (`readings`) and the host's seconds (`host`)."""

from __future__ import annotations

import argparse
import json
import sys
import time
from collections import defaultdict
from pathlib import Path

if __package__ in (None, ""):
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from portbench.trace import _DEVICE_CATS, WINDOW, _merge  # noqa: E402

PREFIX = "ts."
OUTSIDE = "outside"
PIPELINE_HOST = ("ts.pipeline.page", "ts.pipeline.spool", "ts.pipeline.manifest")


def attribute(events: list) -> dict:
    """{window_s, idle_s, spans, idle_by_span, device_by_span} of one trace
    (seconds; µs in the trace)."""
    win = [e for e in events if e.get("ph") == "X" and e.get("name") == WINDOW
           and e.get("cat") == "user_annotation"]
    if not win:
        raise RuntimeError("the trace holds no window annotation")
    w0 = float(win[0]["ts"])
    w1 = w0 + float(win[0]["dur"])
    spans, dev, launches = [], [], {}
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat, name = e.get("cat", ""), e.get("name", "")
        a = float(e["ts"])
        b = a + float(e["dur"])
        if cat in _DEVICE_CATS:
            a, b = max(a, w0), min(b, w1)
            if b > a:
                dev.append((a, b, e.get("args", {}).get("correlation")))
        elif cat == "user_annotation" and name.startswith(PREFIX):
            spans.append((a, b, name, e.get("tid")))
        elif cat == "cuda_runtime" and "correlation" in e.get("args", {}):
            launches[e["args"]["correlation"]] = (a, e.get("tid"))

    table: dict[str, dict] = {}
    for a, b, name, _ in spans:
        t = table.setdefault(name, {"count": 0, "host_s": 0.0})
        t["count"] += w0 <= a < w1
        t["host_s"] += max(0.0, min(b, w1) - max(a, w0)) / 1e6

    busy = _merge([(a, b) for a, b, _ in dev])
    gaps, edge = [], w0
    for a, b in busy + [[w1, w1]]:
        if a > edge:
            gaps.append((edge, a))
        edge = max(edge, b)
    idle = _idle_by_span(spans, gaps)
    device = _device_by_span(spans, dev, launches)
    return {"window_s": (w1 - w0) / 1e6, "idle_s": sum(b - a for a, b in gaps) / 1e6,
            "spans": table, "idle_by_span": _sorted_s(idle), "device_by_span": _sorted_s(device)}


def _sorted_s(d: dict) -> dict:
    return {k: v / 1e6 for k, v in sorted(d.items(), key=lambda kv: -kv[1])}


def _idle_by_span(spans: list, gaps: list) -> dict:
    """A sweep over span and gap edges: each stretch inside a gap goes to
    the latest-started span open over it (the shorter on a tie)."""
    marks = [(a, 1, i) for i, (a, _, _, _) in enumerate(spans)]
    marks += [(b, -1, i) for i, (_, b, _, _) in enumerate(spans)]
    marks += [(g0, 2, -1) for g0, _ in gaps] + [(g1, -2, -1) for _, g1 in gaps]
    marks.sort(key=lambda m: m[0])
    out: dict[str, float] = defaultdict(float)
    open_spans: set[int] = set()
    in_gap = 0
    last = None
    for t, kind, i in marks:
        if in_gap and last is not None and t > last:
            if open_spans:
                j = max(open_spans, key=lambda j: (spans[j][0], spans[j][0] - spans[j][1]))
                out[spans[j][2]] += t - last
            else:
                out[OUTSIDE] += t - last
        last = t
        if kind == 1:
            open_spans.add(i)
        elif kind == -1:
            open_spans.discard(i)
        else:
            in_gap += kind // 2
    return out


def _device_by_span(spans: list, dev: list, launches: dict) -> dict:
    """Each device event's seconds to the span on top of its launching
    thread's stack of `ts.*` spans at the launch."""
    out: dict[str, float] = defaultdict(float)
    by_tid: dict = defaultdict(list)
    for a, b, corr in dev:
        at = launches.get(corr)
        if at is None:
            out[OUTSIDE] += b - a
        else:
            by_tid[at[1]].append((at[0], b - a))
    for tid, calls in by_tid.items():
        # opens (outer first), launches, closes (inner first) at one time
        marks = [(a, 0, a - b, name) for a, b, name, t in spans if t == tid]
        marks += [(b, 2, b - a, name) for a, b, name, t in spans if t == tid]
        marks += [(t, 1, 0.0, d) for t, d in calls]
        marks.sort(key=lambda m: m[:3])
        stack: list[str] = []
        for _, kind, _, x in marks:
            if kind == 0:
                stack.append(x)
            elif kind == 2:
                del stack[len(stack) - 1 - stack[::-1].index(x)]
            else:
                out[stack[-1] if stack else OUTSIDE] += x
    return out


def stats_delta(start: dict, end: dict) -> dict:
    """The encoder's counters over the window (`BatchedEncoder.stats()` at
    its start and end), with by_shape keyed "BxW"."""
    out = {k: end[k] - start[k] for k in end if k != "by_shape"}
    shapes = {s: n - start["by_shape"].get(s, 0) for s, n in end["by_shape"].items()}
    out["by_shape"] = {f"{b}x{w}": n for (b, w), n in sorted(shapes.items()) if n}
    return out


def readings(att: dict | None, encoder: dict | None = None) -> dict:
    """The per-layer quantities of the reduction (shares in % of the traced
    window) and of the encoder's counters over the window; a trace with no
    device work gives none of the trace's."""
    out = {}
    if encoder and encoder.get("token_slots"):
        out["encoder_pad_share"] = 100.0 * (1.0 - encoder["real_tokens"] / encoder["token_slots"])
    if att is None or att["window_s"] <= 0 or not att["device_by_span"]:
        return out
    idle, w = att["idle_by_span"], att["window_s"]

    def share(names) -> float:
        return 100.0 * sum(v for k, v in idle.items() if k in names) / w

    layers = {k.split(".")[1] for k in att["spans"]}
    if "pipeline" in layers or "encoder" in layers:
        out["pipeline_idle"] = share(PIPELINE_HOST)
        out["encoder_host_idle"] = share([k for k in idle if k.startswith("ts.encoder.")])
    if "engine" in layers:
        out["engine_host_idle"] = share([k for k in idle if k.startswith("ts.engine.")])
        n = att["spans"].get("ts.engine.rescore", {}).get("count", 0)
        if n:
            out["rescore_span_ms"] = 1e3 * att["device_by_span"].get("ts.engine.rescore", 0.0) / n
    out["device_idle"] = 100.0 * att["idle_s"] / w
    out["idle_covered"] = 100.0 * (1.0 - idle.get(OUTSIDE, 0.0) / att["idle_s"]) \
        if att["idle_s"] > 0 else 100.0
    return out


def run_cell(cell: str, seed: int, seconds: float, device: str = "cuda",
             overrides: dict | None = None) -> dict:
    """One traced run of `cell` through `harness.run`, with the trace's
    reduction kept and the encoder's counters read at the window's start
    and end: {line, spans, encoder, encode_calls, readings, host}. `host`
    holds the loop's window and encoder seconds where it reads them, and
    the seconds of the tracer's stop (the trace's export, parse and
    reductions, on the host inside the window) and of `attribute` in it."""
    from portbench import harness, stack, trace

    kept: dict = {"encoders": [], "host": {}}
    summarize, batched_encoder, stop = trace.summarize, stack.batched_encoder, trace.Tracer.stop
    begin_window, finish_trace = harness.Context.begin_window, harness.Context.finish_trace

    def summarize_with_spans(events):
        t0 = time.perf_counter()
        kept["spans"] = attribute(events)
        kept["host"]["attribute_s"] = time.perf_counter() - t0
        return summarize(events)

    def timed_stop(tracer):
        t0 = time.perf_counter()
        stop(tracer)
        kept["host"]["tracer_stop_s"] = time.perf_counter() - t0

    def keep_encoder(*a, **kw):
        be = batched_encoder(*a, **kw)
        kept["encoders"].append(be)
        return be

    def begin(ctx):
        kept["start"] = [be.stats() for be in kept["encoders"]]
        return begin_window(ctx)

    def finish(ctx):
        kept["end"] = [be.stats() for be in kept["encoders"]]
        kept["encode_calls"] = list(ctx.readings.get("encode_calls", ()))
        kept["host"].update({k: ctx.readings[k] for k in ("window_s", "encode_s")
                             if k in ctx.readings})
        return finish_trace(ctx)

    trace.summarize, stack.batched_encoder, trace.Tracer.stop = (
        summarize_with_spans, keep_encoder, timed_stop)
    harness.Context.begin_window, harness.Context.finish_trace = begin, finish
    try:
        line = harness.run(cell, seed, seconds, True, device=device, overrides=overrides)
    finally:
        trace.summarize, stack.batched_encoder, trace.Tracer.stop = (
            summarize, batched_encoder, stop)
        harness.Context.begin_window, harness.Context.finish_trace = begin_window, finish_trace
    enc = None
    if kept["encoders"] and "start" in kept:
        enc = stats_delta(kept["start"][0], kept["end"][0])
    att = kept.get("spans")
    return {"line": line, "spans": att, "encoder": enc,
            "encode_calls": kept.get("encode_calls", []), "readings": readings(att, enc),
            "host": kept["host"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace-offset", type=float, default=None,
                    help="seconds into the window that the traced sub-window starts")
    ap.add_argument("--trace-seconds", type=float, default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None, help="also write the JSON of the run here")
    args = ap.parse_args(argv)
    params = {k: v for k, v in (("trace_offset_s", args.trace_offset),
                                ("trace_seconds", args.trace_seconds)) if v is not None}
    if args.device == "cuda":
        import torch

        if not torch.cuda.is_available():
            print("portbench: no CUDA device", file=sys.stderr)
            return 2
        import theoremsearch_tpu_torch.kernels._build as build

        build.load()
    r = run_cell(args.workload, args.seed, args.seconds, args.device,
                 overrides={"params": params} if params else None)
    r.pop("encode_calls")
    r["cell"], r["seed"], r["params"] = args.workload, args.seed, params
    text = json.dumps(r)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text + "\n")
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
