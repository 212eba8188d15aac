"""Finding a cell's files by name and merging them into one spec.

A cell (`workloads/<cell>.json`) names its configuration and its traffic
mix and may override any of the mix's parameters under `params`; the mix
(`traffic/<mix>.json`) names the loop (`loops/<loop>.py`) that
runs it; a per-layer metric's reader is `metrics/<metric>.py`, or
`metrics/<stem>.py` for the metric in every cell. BENCHMARK.json says which end-to-end and per-layer metrics the
cell reports."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

PKG = Path(__file__).resolve().parent
ROOT = PKG.parent


def _json(path: Path) -> dict:
    return json.loads(path.read_text())


def load_module(path: Path, name: str):
    """A module loaded from a file whose name need not be an identifier."""
    mod_name = "portbench._loaded." + name.replace("-", "_").replace(".", "_")
    sp = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(sp)
    sp.loader.exec_module(mod)
    return mod


def benchmark() -> dict:
    return _json(ROOT / "BENCHMARK.json")


def cell_spec(cell: str, overrides: dict | None = None) -> dict:
    """The merged spec of a cell: the mix's parameters, then the cell's,
    then `overrides` (tests shrink sizes this way); `config` holds the
    configuration file, `metrics` the metrics BENCHMARK.json gives it."""
    wl = _json(PKG / "workloads" / f"{cell}.json")
    mix = _json(PKG / "traffic" / f"{wl['traffic']}.json")
    params = {**mix, **wl.get("params", {}), **(overrides or {}).get("params", {})}
    cfg = _json(PKG / "configs" / f"{wl['config']}.json")
    cfg_over = (overrides or {}).get("config", {})
    if cfg_over:
        cfg = {**cfg, "model": {**cfg["model"], **cfg_over.get("model", {})},
               **{k: v for k, v in cfg_over.items() if k != "model"}}
    bench = (overrides or {}).get("benchmark") or benchmark()
    e2e = [m for m in bench["end_to_end"] if cell in m.get("workloads", [cell])]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if cell in m.get("workloads", [cell] if m["moves"] in e2e_names else [])]
    return {"cell": cell, "config_name": wl["config"], "traffic": wl["traffic"],
            "chips": int(wl.get("chips", 1)), "params": params, "config": cfg,
            "limits": {**wl.get("limits", {}), **(overrides or {}).get("limits", {})},
            "end_to_end": e2e, "per_layer": per_layer}


def loop(name: str):
    return load_module(PKG / "loops" / f"{name}.py", "loop_" + name)


def metric_reader(name: str):
    """The reader of a per-layer metric: `metrics/<name>.py`, or where there
    is none, `metrics/<stem>.py` for the name's part before its first dot,
    which serves the metric in every cell (`device_idle.search`, `.embed`)."""
    path = PKG / "metrics" / f"{name}.py"
    if not path.exists():
        path = PKG / "metrics" / f"{name.split('.')[0]}.py"
    return load_module(path, "metric_" + path.stem)
