# Verbatim copy of theoremsearch_tpu/slogans/cost.py (jax-free). The port imports nothing of the
# reference package, so it carries its own copy; keep the two in sync.
"""Token-cost accounting (reference: ec2/generate_slogans/cost.py:2 and
the running-cost tqdm postfix of __main__.py:155-161)."""

from __future__ import annotations

import threading
from dataclasses import dataclass, field


def format_usd(usd: float) -> str:
    return f"${usd:.6f}"


@dataclass
class CostTracker:
    total_usd: float = 0.0
    input_tokens: int = 0
    output_tokens: int = 0
    calls: int = 0
    # add() is called from the generation ThreadPool's workers; bare
    # += read-modify-writes interleave and lose increments on paid runs
    _lock: threading.Lock = field(default_factory=threading.Lock, repr=False, compare=False)

    def add(self, input_tokens: int, output_tokens: int, cost_usd: float) -> None:
        with self._lock:
            self.input_tokens += input_tokens
            self.output_tokens += output_tokens
            self.total_usd += cost_usd
            self.calls += 1

    @property
    def avg_usd(self) -> float:
        return self.total_usd / self.calls if self.calls else 0.0

    def summary(self) -> dict:
        return {
            "cost": format_usd(self.total_usd),
            "avg": format_usd(self.avg_usd),
            "input_tokens": self.input_tokens,
            "output_tokens": self.output_tokens,
            "calls": self.calls,
        }
