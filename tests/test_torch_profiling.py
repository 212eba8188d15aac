"""The port's profiling helpers (`utils/profiling.py`, the counterpart of
theoremsearch_tpu/utils/profiling.py): a torch.profiler trace written as
a Chrome trace, and the steady-state KernelTimer, on the CPU. This file
imports no jax."""

import json
import os

import pytest
import torch

from theoremsearch_tpu_torch.utils.profiling import KernelTimer, trace


def test_trace_writes_a_chrome_trace_naming_the_profiled_op(tmp_path):
    a = torch.randn((64, 64))
    with trace(str(tmp_path), device="cpu") as prof:
        (a @ a).sum()
    assert os.path.dirname(prof.trace_path) == str(tmp_path)
    events = json.loads(open(prof.trace_path).read())["traceEvents"]
    names = {e.get("name") for e in events}
    assert "aten::mm" in names
    assert any(e.key == "aten::mm" for e in prof.key_averages())
    # a second trace does not overwrite the first
    with trace(str(tmp_path), device="cpu") as prof2:
        a.sum()
    assert prof2.trace_path != prof.trace_path and len(os.listdir(tmp_path)) == 2


def test_kernel_timer_records_and_reports_on_the_cpu():
    calls = []

    def fn(x):
        calls.append(1)
        return x * 2

    timer = KernelTimer(iters=5, device="cpu")
    dt = timer.measure("double", fn, torch.ones(8))
    assert dt > 0 and len(calls) == 6          # one warm call, then iters
    timer.measure("again", fn, torch.ones(8))
    assert set(timer.records) == {"double", "again"}
    lines = timer.report().splitlines()
    assert lines[0].startswith("again: ") and lines[1].startswith("double: ")
    assert all(ln.endswith(" ms") for ln in lines)


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA device is required"):
        KernelTimer()
    with pytest.raises(RuntimeError, match="CUDA device is required"):
        with trace():
            pass
