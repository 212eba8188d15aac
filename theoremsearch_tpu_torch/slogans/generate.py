# Verbatim copy of theoremsearch_tpu/slogans/generate.py (jax-free). The port imports nothing of the
# reference package, so it carries its own copy; keep the two in sync.
"""Paged slogan generation with retry, fan-out, and cost accounting.

Reference behavior being reproduced (ec2/generate_slogans/__main__.py:20
and slogans.py:118-168):
- page theorems lacking a slogan for (model, prompt_id) from the catalog
  (NOT EXISTS work selection -> crash-resumable);
- build the per-theorem payload from the prompt config's context columns;
- fan out LLM calls over a thread pool (network latency hiding);
- retry the page's failed (None) slots up to max_retries;
- upsert per page (the catalog commit is the checkpoint);
- track running $ cost; optional tracing per call.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

from ..ingest.catalog import Catalog
from ..utils.tracing import NullTracer
from .client import LLMClient, OfflineStubClient
from .cost import CostTracker
from .prompts import PromptConfig


def _build_payload(row: dict, prompt: PromptConfig, paper_row: dict | None) -> dict:
    payload = {}
    for table, col in prompt.context_fields:
        if table == "theorem":
            payload[prompt.payload_key(table, col)] = row.get(col, "")
        elif table == "paper" and paper_row is not None:
            payload[prompt.payload_key(table, col)] = paper_row.get(col, "")
    return payload


def generate_slogans(
    catalog: Catalog,
    prompt: PromptConfig,
    client: LLMClient | None = None,
    model_name: str | None = None,
    page_size: int = 100,
    workers: int = 16,
    max_retries: int = 2,
    tracer=None,
    limit: int | None = None,
) -> CostTracker:
    client = client or OfflineStubClient()
    model_name = model_name or getattr(client, "model_name", "offline-stub")
    tracer = tracer or NullTracer()
    cost = CostTracker()
    done = 0

    paper_cols = [c for t, c in prompt.context_fields if t == "paper"]

    for page in catalog.theorems_missing_slogan(model_name, prompt.prompt_id, page_size):
        rows = [dict(r) for r in page]
        if limit is not None:
            rows = rows[: max(0, limit - done)]
            if not rows:
                break

        paper_cache: dict[str, dict] = {}
        if paper_cols:
            for r in rows:
                pid = r["paper_id"]
                if pid not in paper_cache:
                    pr = catalog.conn.execute(
                        "SELECT * FROM paper WHERE paper_id = ?", (pid,)
                    ).fetchone()
                    paper_cache[pid] = dict(pr) if pr else {}

        slogans: list[str | None] = [None] * len(rows)

        def run_one(i: int):
            row = rows[i]
            payload = _build_payload(row, prompt, paper_cache.get(row["paper_id"]))
            with tracer.span(
                "generate_theorem_slogan",
                theorem_id=row["theorem_id"],
                prompt_id=prompt.prompt_id,
                model=model_name,
            ):
                try:
                    c = client.complete(prompt.instructions, payload, prompt.temperature)
                except Exception:
                    return i, None
            if c.text:
                cost.add(c.input_tokens, c.output_tokens, c.cost_usd)
            return i, c.text

        # initial fan-out + whole-page retry of failed slots
        # (reference slogans.py:135-165)
        for attempt in range(max_retries + 1):
            pending = [i for i, s in enumerate(slogans) if s is None]
            if not pending:
                break
            with ThreadPoolExecutor(max_workers=workers) as ex:
                for i, text in ex.map(run_one, pending):
                    slogans[i] = text

        catalog.upsert_rows(
            "theorem_slogan",
            [
                {
                    "theorem_id": rows[i]["theorem_id"],
                    "model": model_name,
                    "prompt_id": prompt.prompt_id,
                    "slogan": s,
                }
                for i, s in enumerate(slogans)
                if s is not None
            ],
            ["theorem_id", "model", "prompt_id"],
        )
        done += len(rows)
        tracer.flush()
        if limit is not None and done >= limit:
            break
    return cost
