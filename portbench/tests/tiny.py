"""Tiny overrides that let every cell run on the CPU in seconds: the same
loops, program path and reference at toy widths and sizes."""

import json
from pathlib import Path

import torch

# the loops tick their traced sub-window between calls: with every test
# worker on every core, one tiny call can outlast a test's whole window
torch.set_num_threads(min(2, torch.get_num_threads()))

PKG = Path(__file__).resolve().parents[1]

QWEN = {"model": {"hidden_size": 64, "intermediate_size": 128, "num_hidden_layers": 2,
                  "num_attention_heads": 4, "num_key_value_heads": 2, "head_dim": 16,
                  "vocab_size": 1000},
        "serving": {"max_seq_len": 128, "quant": "none", "max_batch": 64, "max_wait_ms": 8,
                    "max_pending": 2048}}
BERT = {"model": {"hidden_size": 48, "intermediate_size": 96, "num_hidden_layers": 2,
                  "num_attention_heads": 4, "vocab_size": 1000},
        "serving": QWEN["serving"]}
WORDS = {"median": 12, "p5": 4, "p95": 40, "min": 2, "max": 100}
PARAMS = {
    "serve-text": {"corpus_rows": 16384, "slogans": 256, "slogan_words": WORDS,
                   "query_words": {"median": 8, "p5": 3, "p95": 20, "min": 2, "max": 60},
                   "rate_qps": 40, "client_threads": 16, "drain_s": 20},
    "search-b1024": {"corpus_rows": 16384, "slogans": 256, "slogan_words": WORDS,
                     "query_words": {"median": 8, "p5": 3, "p95": 20, "min": 2, "max": 60},
                     "batch": 64, "query_batches": 2, "keep_every": 2},
    "embed-slogans": {"slogans": 4096, "per_paper": 16, "slogan_words": WORDS, "chunk": 64,
                      "sample": 16},
}


def overrides(cell: str) -> dict:
    wl = json.loads((PKG / "workloads" / f"{cell}.json").read_text())
    cfg = BERT if wl["config"].startswith("bert") else QWEN
    out = {"config": cfg, "params": dict(PARAMS[wl["traffic"]])}
    if cell in SERVE_CELLS:
        out["benchmark"] = with_serve(json.loads((PKG.parent / "BENCHMARK.json").read_text()))
    return out


SERVE_CELLS = ["qwen3-emb-0.6b.serve-text", "bert-base-zbmath.serve-text"]


def with_serve(bench: dict) -> dict:
    """BENCHMARK.json with the two serve-text cells and their metrics, which
    are defined under portbench/ but not in the benchmark (PERF.md §7)."""
    b = json.loads(json.dumps(bench))
    b["workloads"] += [{"name": c, "config": c.rsplit(".", 1)[0], "traffic": "serve-text",
                        "chips": 1, "why": "test"} for c in SERVE_CELLS]
    b["end_to_end"] += [{"name": n, "unit": "ms", "better": "lower", "bound": 0.25,
                         "source": "host_clock", "workloads": SERVE_CELLS}
                        for n in ("serve_p95_ms", "serve_p50_ms")]
    layers = {"batch_mean": ("queries", "program_counter"), "queue_ms_p99": ("ms", "program_span"),
              "encode_dispatch_ms_p50": ("ms", "program_span"), "encoder_mfu": ("%", "device_trace"),
              "device_idle": ("%", "device_trace")}
    b["per_layer"] += [{"name": f"{n}.serve", "unit": u, "better": "higher", "source": src,
                        "layer": "serving", "moves": "serve_p95_ms", "workloads": SERVE_CELLS}
                       for n, (u, src) in layers.items()]
    return b
