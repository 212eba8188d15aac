"""Run one cell of the port's benchmark once, on the card this process
sees, and print its result as the last line of standard output.

    python3 portbench/run.py --workload qwen3-emb-0.6b.serve-text --seed 7 --seconds 10 --trace 0

Exits non-zero, printing no result, without a CUDA device (or with fewer
than the cell asks for), without the port beside this directory, or if
jax, jaxlib, flax or the JAX package was loaded by the time the window
closed. The numbers that decided `correct` are printed beside their
limits as the last lines of standard error."""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / "portbench" / "_cache"
FORBIDDEN = {"jax", "jaxlib", "flax", "theoremsearch_tpu"}


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # every build and kernel cache at a fixed path inside the checkout
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
        os.environ[var] = str(CACHE / sub)
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_JAX", "0")
    sys.path.insert(0, str(ROOT))
    import torch

    from portbench import harness, spec

    if not torch.cuda.is_available():
        print("portbench: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 2
    chips = spec.cell_spec(args.workload)["chips"]
    if torch.cuda.device_count() < chips:
        print(f"portbench: the cell needs {chips} cards, {torch.cuda.device_count()} present",
              file=sys.stderr)
        return 2
    import theoremsearch_tpu_torch.kernels._build as build

    build.load()
    out = harness.run(args.workload, args.seed, args.seconds, bool(args.trace),
                      device="cuda", t_start=T_START)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: forbidden modules loaded: {', '.join(bad)}", file=sys.stderr)
        return 3
    print(json.dumps({"notes": out.pop("notes")}))
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
