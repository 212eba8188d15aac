"""The reduction of the port's `ts.*` spans (`portbench/spans.py`) on
synthetic Chrome traces, and the encoder's counters against the
benchmark's own count of a tiny embed run on the CPU."""

import copy

from portbench import spans, trace
from portbench.tests import tiny

W0, W1 = 1000.0, 2000.0


def _x(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid, "args": args}


def _kernel(name, ts, dur, corr):
    return _x("kernel", name, ts, dur, tid=7, correlation=corr)


def _launch(ts, corr, tid=1):
    return _x("cuda_runtime", "cudaLaunchKernel", ts, 2.0, tid=tid, correlation=corr)


def _base() -> list:
    """A window of 1000 µs on the card: kernels 1100-1300 (launched at
    1050 in ts.engine.scan), 1500-1600 (launched at 1420 in
    ts.engine.rescore, nested in ts.engine.search) and 1700-1750 (launched
    outside any span); host ops beside them."""
    return [
        _x("user_annotation", trace.WINDOW, W0, W1 - W0),
        _x("cpu_op", "aten::mm", 1040.0, 20.0),
        _launch(1050.0, 11), _kernel("scan_kernel", 1100.0, 200.0, 11),
        _launch(1420.0, 12), _kernel("gemv_kernel", 1500.0, 100.0, 12),
        _launch(1690.0, 13), _kernel("where_kernel", 1700.0, 50.0, 13),
    ]


def _spans() -> list:
    return [
        _x("user_annotation", "ts.engine.scan", 1000.0, 90.0),
        _x("user_annotation", "ts.engine.search", 1350.0, 300.0),
        _x("user_annotation", "ts.engine.rescore", 1400.0, 40.0),
        # another thread's span over the last stretch: idle there is its
        _x("user_annotation", "ts.pipeline.page", 1800.0, 150.0, tid=2),
    ]


def test_idle_goes_to_the_innermost_span_and_work_to_its_launcher():
    a = spans.attribute(_base() + _spans())
    assert a["window_s"] == 1e-3
    # idle: 1000-1100, 1300-1500, 1600-1700, 1750-2000 = 650 µs
    assert abs(a["idle_s"] - 650e-6) < 1e-12
    want = {"ts.engine.scan": 90.0, "outside": 10.0 + 50.0 + 50.0 + 50.0 + 50.0,
            "ts.engine.search": 50.0 + 60.0 + 50.0, "ts.engine.rescore": 40.0,
            "ts.pipeline.page": 150.0}
    got = {k: v * 1e6 for k, v in a["idle_by_span"].items()}
    assert got.keys() == want.keys()
    assert all(abs(got[k] - want[k]) < 1e-6 for k in want), got
    assert abs(sum(a["idle_by_span"].values()) - a["idle_s"]) < 1e-12
    dev = {k: v * 1e6 for k, v in a["device_by_span"].items()}
    assert dev == {"ts.engine.scan": 200.0, "ts.engine.rescore": 100.0, "outside": 50.0}
    assert a["spans"]["ts.engine.rescore"] == {"count": 1, "host_s": 40e-6}
    r = spans.readings(a)
    assert abs(r["engine_host_idle"] - 100.0 * 290e-6 / 1e-3) < 1e-9
    assert abs(r["rescore_span_ms"] - 0.1) < 1e-12
    assert abs(r["device_idle"] - 65.0) < 1e-9
    assert abs(r["idle_covered"] - 100.0 * (1 - 210.0 / 650.0)) < 1e-9


def test_a_launch_charges_the_span_open_on_its_own_thread():
    ev = _base() + _spans() + [_x("user_annotation", "ts.encoder.forward", 1400.0, 100.0, tid=3)]
    a = spans.attribute(ev)
    # the gemv's launch is on thread 1 inside ts.engine.rescore, whatever
    # thread 3 was doing; of the idle 1400-1500, 1400-1440 stays with the
    # shorter of the two spans that start at 1400, and 1440-1500 goes to
    # thread 3's span, started after ts.engine.search
    assert a["device_by_span"]["ts.engine.rescore"] * 1e6 == 100.0
    assert abs(a["idle_by_span"]["ts.engine.rescore"] * 1e6 - 40.0) < 1e-6
    assert abs(a["idle_by_span"]["ts.encoder.forward"] * 1e6 - 60.0) < 1e-6


def test_spans_leave_the_summary_of_the_trace_as_it_was():
    plain = trace.summarize(copy.deepcopy(_base()))
    spanned = trace.summarize(copy.deepcopy(_base() + _spans()))
    for key in ("window_s", "busy_s", "device", "device_ops"):
        assert plain[key] == spanned[key], key


def test_no_spans_leave_all_idle_outside():
    a = spans.attribute(_base())
    assert list(a["idle_by_span"]) == ["outside"] and a["spans"] == {}
    assert spans.readings(a) == {"device_idle": 65.0, "idle_covered": 0.0}
    # no device work at all (a CPU trace): no reading of the trace
    cpu = spans.attribute([_x("user_annotation", trace.WINDOW, W0, 1000.0)] + _spans())
    assert cpu["device_by_span"] == {} and spans.readings(cpu) == {}


def test_encoder_counts_the_benchmarks_tokens_on_a_tiny_embed_run():
    cell = "qwen3-emb-0.6b.embed-slogans"
    o = tiny.overrides(cell)
    o["params"].update(trace_offset_s=0.2, trace_seconds=0.5)
    r = spans.run_cell(cell, 2**31 + 17, 2.0, device="cpu", overrides=o)
    assert r["line"]["correct"]
    calls = r["encode_calls"]
    assert calls and r["encoder"]["calls"] == len(calls)
    # the benchmark counts min(words + 2, max_seq_len) a slogan; the
    # encoder counts its mask over the real rows: the same tokens, since
    # the embed loop's encoder has no role prompt
    assert r["encoder"]["real_tokens"] == sum(sum(ls) for _, ls in calls)
    assert r["encoder"]["texts"] == sum(len(ls) for _, ls in calls)
    assert r["encoder"]["token_slots"] > r["encoder"]["real_tokens"]
    assert 0.0 < r["readings"]["encoder_pad_share"] < 100.0
    seen = set(r["spans"]["spans"])
    assert {"ts.pipeline.page", "ts.pipeline.encode", "ts.encoder.forward"} <= seen
    # no device events on the CPU: the readings of the trace are absent
    assert set(r["readings"]) == {"encoder_pad_share"}
