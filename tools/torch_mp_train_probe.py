#!/usr/bin/env python3
"""What the multiproc_gloo train step's readings against one process show,
sound and with the gradient sum broken on purpose, on one card.

    python tools/torch_mp_train_probe.py [--controls sum,no_sum,doubled_sum]

Runs `chip_smoke.py`'s multiproc_gloo train part alone, from the same
constants (`MP_TRAIN`, `MP_TRAIN_STEPS`, `MP_TRAIN_LIMITS`) and phase 18's
tokens (`train_tokens`, 64 pairs x 64): two tests/torch_multihost_worker.py
processes over Gloo, both on cuda:0, mesh_train's qwen tower (vocab
151,936) on (data 2, shard 2) with one data row a process, 3 steps;
process 0 then runs the one-process (2, 2) mesh on the same batches. Once
a control (the worker's `--train-control`): the port's sum ("sum"), twice
the sum, no sum. Prints one JSON line a control: the readings of
`train_readings` and the limits they are held to, the staged bf16 sum's
check, the losses and gradient norms of both runs, step ms, the
all-reduce's ms a step by stage, and each process's peak memory.

Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import shutil
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def _smoke():
    """The phases' constants and helpers from this checkout's chip_smoke.py."""
    spec = importlib.util.spec_from_file_location("chip_smoke_helpers", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--controls", default="sum,no_sum,doubled_sum",
                    help="comma-separated train controls to run")
    args = ap.parse_args(argv)
    from theoremsearch_tpu_torch.core.config import EncoderConfig
    from theoremsearch_tpu_torch.kernels import _build
    from theoremsearch_tpu_torch.utils.device import gpu_name_power, require_cuda

    dev = require_cuda()
    _build.load()           # built once here, not in every worker
    smoke = _smoke()
    W = smoke.mp_worker()
    gpu = gpu_name_power()
    print(gpu, flush=True)
    pairs, steps = smoke.MESH_TRAIN_PAIRS[0], smoke.MP_TRAIN_STEPS
    tq, tp = smoke.train_tokens(np.random.default_rng(0), EncoderConfig(max_seq_len=64).vocab_size,
                                64, 64, 20)
    work = tempfile.mkdtemp(prefix="mp_train_probe_")
    try:
        batch = os.path.join(work, "batch.npz")
        np.savez(batch, q=np.ascontiguousarray(tq[:steps, :pairs]),
                 p=np.ascontiguousarray(tp[:steps, :pairs]))
        for control in args.controls.split(","):
            t0 = time.perf_counter()
            res = W.run_workers([
                ["--rank", str(r), "--world", "2", "--init", f"file://{work}/rendezvous_{control}",
                 "--device", str(dev), "--backend", "gloo", "--local", "2", "--parts", "train",
                 *smoke.MP_TRAIN, "--train-mesh", "2,2", "--train-batch", batch,
                 "--train-steps", str(steps), "--train-control", control,
                 "--check-one-process", "train"] for r in range(2)],
                work, smoke.MP_TIMEOUT_S, name=control)
            t = [r["train"] for r in res]
            reads = t[0]["vs_one_process"]
            print(json.dumps({
                "control": control, "gpu": gpu, "seconds": time.perf_counter() - t0,
                "readings": reads, "limits": smoke.MP_TRAIN_LIMITS,
                "within_limits": {k: reads[k] <= lim for k, lim in smoke.MP_TRAIN_LIMITS.items()},
                "first_loss_equal": reads["first_loss_equal"],
                "params_equal_across_processes": t[0]["params_sha256"] == t[1]["params_sha256"],
                "staged_sum": [x["staged_sum"] for x in t],
                "losses": t[0]["losses"], "one_process_losses": t[0]["one_process"]["losses"],
                "grad_norms": t[0]["grad_norms"],
                "one_process_grad_norms": t[0]["one_process"]["grad_norms"],
                "update_norm": t[0]["update_norm"],
                "one_process_update_norm": t[0]["one_process"]["update_norm"],
                "step_ms": [[s * 1e3 for s in x["step_s"]] for x in t],
                "all_reduce_ms": [[{k: c["all_reduce"].get(k, 0.0) * 1e3
                                    for k in ("s", "pin_s", "to_host_s", "to_device_s")}
                                   for c in x["collectives_a_step"] if "all_reduce" in c] for x in t],
                "peak_mem_gb": [x.get("peak_mem_gb") for x in t]}), flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
