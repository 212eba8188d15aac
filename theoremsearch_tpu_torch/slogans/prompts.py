# Verbatim copy of theoremsearch_tpu/slogans/prompts.py (jax-free). The port imports nothing of the
# reference package, so it carries its own copy; keep the two in sync.
"""Declarative prompt configs, .prompt-JSON compatible.

Same file format as the reference (ec2/slogan_prompts/README.md: JSON with
prompt_id / instructions[] / context[] / temperature, where context
entries name catalog columns like 'theorem.body' that become fields of
the per-theorem payload — config-driven feature selection for the LLM,
consumed at ec2/generate_slogans/__main__.py:41-54).
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from pathlib import Path

BUILTIN_PROMPTS = {
    "body-only-v1": {
        "prompt_id": "body-only-v1",
        "instructions": [
            "You generate summaries of math theorems based on theorem_body.",
            "Summaries are accurate and at most four sentences.",
            "Summaries are plain ASCII sentences with no Unicode.",
            "Describe the result without referencing it as 'this theorem' or similar.",
            "Avoid LaTeX and mathematical symbols; use words instead.",
            "Output only the final summary sentences, with no commentary.",
        ],
        "context": ["theorem.body"],
        "temperature": 0.2,
    },
    "body-and-summary-v1": {
        "prompt_id": "body-and-summary-v1",
        "instructions": [
            "You generate accurate summaries of math theorems based on theorem_body.",
            "You also consider paper_summary in your theorem summaries.",
            "Summaries are accurate and at most four sentences.",
            "Summaries are plain ASCII sentences with no Unicode.",
            "Describe the result without referencing it as 'this theorem' or similar.",
            "Avoid LaTeX and math symbols. Include identifiers that aid retrieval.",
        ],
        "context": ["theorem.body", "paper.summary"],
        "temperature": 0.2,
    },
}


@dataclass
class PromptConfig:
    prompt_id: str
    instructions: list[str]
    context: list[str] = field(default_factory=lambda: ["theorem.body"])
    temperature: float = 0.2

    @property
    def context_fields(self) -> list[tuple[str, str]]:
        """[(table, column)] from 'table.column' context entries; the alias
        used in the payload is table_column (matching the SELECT ... AS
        aliasing of the reference, __main__.py:48-54)."""
        out = []
        for entry in self.context:
            table, _, col = entry.partition(".")
            out.append((table, col or table))
        return out

    def payload_key(self, table: str, col: str) -> str:
        return f"{table}_{col}"


# Shipped config library: the three versioned .prompt files (vendored
# reference data — see prompt_configs/README.md for provenance)
SHIPPED_PROMPTS_DIR = Path(__file__).parent / "prompt_configs"


def load_prompt(name_or_path: str, prompts_dir: str | Path | None = None) -> PromptConfig:
    """Resolve a prompt id: explicit path > prompts_dir/{id}.prompt >
    shipped prompt_configs/ > builtin."""
    p = Path(name_or_path)
    shipped = SHIPPED_PROMPTS_DIR / f"{name_or_path}.prompt"
    if p.suffix == ".prompt" and p.exists():
        data = json.loads(p.read_text())
    elif prompts_dir and (Path(prompts_dir) / f"{name_or_path}.prompt").exists():
        data = json.loads((Path(prompts_dir) / f"{name_or_path}.prompt").read_text())
    elif shipped.exists():
        data = json.loads(shipped.read_text())
    elif name_or_path in BUILTIN_PROMPTS:
        data = BUILTIN_PROMPTS[name_or_path]
    else:
        raise FileNotFoundError(f"prompt config {name_or_path!r} not found")
    return PromptConfig(
        prompt_id=data["prompt_id"],
        instructions=list(data["instructions"]),
        context=list(data.get("context", ["theorem.body"])),
        temperature=float(data.get("temperature", 0.2)),
    )
