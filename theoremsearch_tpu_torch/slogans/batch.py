# Verbatim copy of theoremsearch_tpu/slogans/batch.py (jax-free). The port imports nothing of the
# reference package, so it carries its own copy; keep the two in sync.
"""Batch-inference job builder (offline JSONL mode).

Parity with the reference's Bedrock batch pipeline
(ec2/generate_slogans/batches/build/__main__.py:71-157: JSONL records
with recordId = theorem_id and modelInput = the same messages payload,
paged 10k records per part with zero-padded part keys; run/__main__.py
submits create_model_invocation_job). Here the build step writes local
part files (upload + submit are provider hooks, gated on boto3).
"""

from __future__ import annotations

import json
import uuid
from pathlib import Path

from ..ingest.catalog import Catalog
from .generate import _build_payload
from .prompts import PromptConfig

RECORDS_PER_PART = 10_000


def build_batch_prompts(
    catalog: Catalog,
    prompt: PromptConfig,
    model_name: str,
    out_dir: str | Path,
    records_per_part: int = RECORDS_PER_PART,
) -> list[Path]:
    """Write part-{i:05d}.jsonl files; returns their paths."""
    out_dir = Path(out_dir) / f"batched_slogans/{uuid.uuid4()}/in"
    out_dir.mkdir(parents=True, exist_ok=True)
    parts: list[Path] = []
    buf: list[str] = []
    part_idx = 0

    def flush():
        nonlocal part_idx, buf
        if not buf:
            return
        p = out_dir / f"part-{part_idx:05d}.jsonl"
        p.write_text("\n".join(buf) + "\n")
        parts.append(p)
        part_idx += 1
        buf = []

    paper_cols = any(t == "paper" for t, _ in prompt.context_fields)
    paper_cache: dict[str, dict] = {}
    for page in catalog.theorems_missing_slogan(model_name, prompt.prompt_id, records_per_part):
        for row in page:
            row = dict(row)
            # the SAME payload the online path builds (prompt context
            # columns, incl. paper.* joins) — a batch job must not feed
            # the model less context than generate_slogans under the
            # identical (model, prompt_id) key
            if paper_cols and row["paper_id"] not in paper_cache:
                pr = catalog.conn.execute(
                    "SELECT * FROM paper WHERE paper_id = ?", (row["paper_id"],)
                ).fetchone()
                paper_cache[row["paper_id"]] = dict(pr) if pr else {}
            payload = _build_payload(row, prompt, paper_cache.get(row["paper_id"]))
            record = {
                "recordId": str(row["theorem_id"]),
                "modelInput": {
                    "messages": [
                        {"role": "user", "content": "\n".join(prompt.instructions)},
                        {"role": "user", "content": json.dumps(payload)},
                    ],
                    "max_tokens": 1024,
                    "temperature": prompt.temperature,
                },
            }
            buf.append(json.dumps(record))
            if len(buf) >= records_per_part:
                flush()
    flush()
    return parts


def ingest_batch_results(catalog: Catalog, results_dir: str | Path, model_name: str, prompt_id: str) -> int:
    """Read part JSONL outputs ({recordId, modelOutput}) back into the
    catalog. Returns the number of slogans stored."""
    n = 0
    rows = []
    for p in sorted(Path(results_dir).glob("*.jsonl")):
        for line in p.read_text().splitlines():
            if not line.strip():
                continue
            rec = json.loads(line)
            out = rec.get("modelOutput", {})
            text = None
            if isinstance(out, dict):
                choices = out.get("choices") or []
                if choices:
                    text = (choices[0].get("message") or {}).get("content")
            if text:
                rows.append(
                    {
                        "theorem_id": int(rec["recordId"]),
                        "model": model_name,
                        "prompt_id": prompt_id,
                        "slogan": text.strip(),
                    }
                )
                n += 1
    catalog.upsert_rows("theorem_slogan", rows, ["theorem_id", "model", "prompt_id"])
    return n


def submit_bedrock_batch_job(input_s3_uri: str, output_s3_uri: str, model_name: str, role_arn: str):
    """Submit a Bedrock model-invocation batch job (gated on boto3/creds;
    reference run/__main__.py:8-26)."""
    import boto3
    from .client import MODELS

    brc = boto3.client("bedrock")
    return brc.create_model_invocation_job(
        jobName=f"slogans-{uuid.uuid4()}",
        modelId=MODELS[model_name]["model_id"],
        roleArn=role_arn,
        inputDataConfig={"s3InputDataConfig": {"s3Uri": input_s3_uri}},
        outputDataConfig={"s3OutputDataConfig": {"s3Uri": output_s3_uri}},
    )
