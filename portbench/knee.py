"""The knee of an open-loop serving cell: the highest offered rate at
which completions keep pace with arrivals, with no refusals and no
growing backlog. Builds the cell's stack once and offers each rate for
--seconds in turn (a new generator process each).

    python3 portbench/knee.py --workload qwen3-emb-0.6b.serve-text --seed 5 --rates 200,400,800 --seconds 8

One JSON line a rate: offered and completed rates, refusals, p50/p95,
the p50 of the first and the last fifth of the arrivals, the batch mean."""

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import time

    from portbench import harness, spec

    import theoremsearch_tpu_torch.kernels._build as build

    build.load()
    cs = spec.cell_spec(args.workload)
    drv = spec.loop(cs["params"]["loop"])
    ctx = harness.Context(cs, args.seed, args.seconds, False, "cuda", time.perf_counter())
    drv.setup(ctx)
    try:
        for rate in [float(r) for r in args.rates.split(",")]:
            line = json.dumps({"workload": args.workload, **drv.offer(ctx, rate, args.seconds)})
            print(line, flush=True)
            if args.out:
                with open(args.out, "a") as f:
                    f.write(line + "\n")
    finally:
        drv.release(ctx)
    return 0


if __name__ == "__main__":
    sys.exit(main())
