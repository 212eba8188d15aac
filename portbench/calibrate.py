"""Readings that set a cell's limits (steps 3-5 of how `correct` is
decided): runs the cell on each seed in one process, each run with the
control's readings beside the program's.

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,3 --seconds 5 --control int8

--control int8 runs the program's own int8 path where the tower has one
(qwen: w8a8, kernels B3/B4) and reads its numbers as the control's;
--control reference keeps the program as configured. Either way every
run also reads the reference put in the program's place at int8 (the
tower, and the search stage over an int8 corpus) into `notes.control`.
One JSON line a run, on standard output and appended to --out."""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--control", choices=("int8", "reference"), default="reference")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import torch

    from portbench import harness

    import theoremsearch_tpu_torch.kernels._build as build

    build.load()
    for seed in [int(s) for s in args.seeds.split(",")]:
        t0 = time.perf_counter()
        out = harness.run(args.workload, seed, args.seconds, False, device="cuda",
                          control=args.control)
        line = json.dumps({"workload": args.workload, "seed": seed, "control": args.control,
                           "run_s": time.perf_counter() - t0, **out})
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
        torch.cuda.reset_peak_memory_stats()
    return 0


if __name__ == "__main__":
    sys.exit(main())
