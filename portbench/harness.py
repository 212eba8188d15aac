"""One run of one cell: set-up from the seed, the measured window, the
check against the plain reference, and the result's line.

A loop (`loops/<name>.py`) has four functions of a Context:
`setup` builds the system under test and warms the cell's shapes,
`window` runs the measured window (starting and stopping the traced
sub-window through `ctx.tick`), `release` stops and frees the system,
and `check` compares what the window produced with the reference and
returns each compared number. End-to-end metrics are those the loop
put in `ctx.e2e` that BENCHMARK.json gives the cell; per-layer metrics
are read by `metrics/<name>.py` from `ctx.readings` and the trace."""

from __future__ import annotations

import gc
import time

import torch

from . import spec as specmod
from .trace import Tracer


class Context:
    def __init__(self, cell_spec: dict, seed: int, seconds: float, trace: bool, device,
                 t_start: float, control: str | None = None):
        self.spec = cell_spec
        self.p = cell_spec["params"]
        self.cfg = cell_spec["config"]
        self.seed = int(seed)
        self.seconds = float(seconds)
        self.trace = bool(trace)
        self.device = torch.device(device)
        self.t_start = t_start
        # calibration only: "int8" runs the program's own int8 path where
        # it has one (the control of step 2); never set by run.py
        self.control = control
        self.state: dict = {}
        self.e2e: dict = {}
        self.readings: dict = {}
        self.attempted = 0
        self.failed = 0
        self.notes: dict = {}
        self.tracer = Tracer(cuda=self.device.type == "cuda") if trace else None
        self._t0 = None
        self._traced = "off" if self.tracer is None else "armed"

    def begin_window(self) -> float:
        self._t0 = time.perf_counter()
        self.e2e["setup_s"] = self._t0 - self.t_start
        return self._t0

    def tick(self) -> None:
        """Start or stop the traced sub-window when the window's clock says so."""
        if self._traced == "off" or self._t0 is None:
            return
        el = time.perf_counter() - self._t0
        on = self.p.get("trace_offset_s", 1.0)
        if self._traced == "armed" and el >= on:
            self.tracer.start()
            self.readings["trace_t0"] = time.perf_counter()
            self._traced = "on"
        elif (self._traced == "on"
              and time.perf_counter() - self.readings["trace_t0"] >= self.p.get("trace_seconds", 4.0)):
            self.readings["trace_t1"] = time.perf_counter()
            self.tracer.stop()
            self._traced = "done"

    def finish_trace(self) -> None:
        if self._traced == "on":
            self.readings["trace_t1"] = time.perf_counter()
            self.tracer.stop()
            self._traced = "done"

    @property
    def tracing(self) -> bool:
        return self._traced == "on"

    @property
    def window_start(self) -> float:
        return self._t0

    @property
    def summary(self):
        return self.tracer.summary if self.tracer is not None else None


def device_info(ctx: Context) -> dict:
    dev = ctx.device
    if dev.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(dev), "count": 1,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(dev))}
    try:
        from theoremsearch_tpu_torch.utils.device import gpu_name_power
        info["power_limit"] = gpu_name_power().split(",")[-1].strip()
    except Exception as e:  # noqa: BLE001 - the card's name is recorded either way
        info["power_limit"] = f"unread: {e}"[:80]
    return info


def run(cell: str, seed: int, seconds: float, trace: bool, device="cuda", t_start=None,
        overrides: dict | None = None, control: str | None = None) -> dict:
    """The result's line of one run of `cell` (a dict, keys in order)."""
    t_start = time.perf_counter() if t_start is None else t_start
    cs = specmod.cell_spec(cell, overrides)
    drv = specmod.loop(cs["params"]["loop"])
    ctx = Context(cs, seed, seconds, trace, device, t_start, control)
    drv.setup(ctx)
    if ctx.tracer is not None:
        ctx.tracer.warm()
    drv.window(ctx)
    ctx.finish_trace()
    dev_info = device_info(ctx)
    drv.release(ctx)
    ctx.state.clear()
    gc.collect()
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    numbers = drv.check(ctx)
    # the cell's limits name the numbers compared; the rest are recorded
    limits = cs["limits"]
    checks = {k: {"value": numbers.get(k, float("inf")), "limit": v} for k, v in limits.items()}
    ctx.notes["readings"] = {k: v for k, v in numbers.items() if k not in limits}
    correct = bool(checks) and all(c["value"] <= c["limit"] for c in checks.values())
    units = {m["name"]: m["unit"] for m in cs["end_to_end"] + cs["per_layer"]}
    metrics = {}
    if not trace:
        for m in cs["end_to_end"]:
            v = ctx.e2e.get(m["name"])
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": units[m["name"]]}
    else:
        for m in cs["per_layer"]:
            v = specmod.metric_reader(m["name"]).read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": units[m["name"]]}
        if ctx.summary is not None:
            dev_info["busy_s"] = ctx.summary["busy_s"]
            dev_info["window_s"] = ctx.summary["window_s"]
    out = {"correct": correct, "attempted": ctx.attempted, "failed": ctx.failed,
           "metrics": metrics, "device": dev_info}
    if trace and ctx.summary is not None:
        out["breakdown"] = {"device_ops": ctx.summary["device_ops"],
                            "idle_gaps": ctx.summary["idle_gaps"]}
    out["notes"] = ctx.notes
    out["checks"] = checks
    return out
