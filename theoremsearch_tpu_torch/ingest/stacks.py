# Verbatim copy of theoremsearch_tpu/ingest/stacks.py (jax-free). The port imports nothing of the
# reference package, so it carries its own copy; keep the two in sync.
"""Stacks Project ingest.

Capability-parity with the reference (ec2/upsert_stacks/__main__.py:12-71
and parsed_papers_to_vector_rds/stacks_parsing/): synthesize paper rows
for Stacks Project sections (author "Aise Johan de Jong", link
stacks.math.columbia.edu/tag/{tag}) and theorem rows from either

- pre-parsed JSON files ({"theorem"/"name", "body", "label"} rows per
  section), as the reference ships in stacks_parsed.zip, or
- raw Stacks .tex chapter files, run through our scanner extractor.

The tag map comes from the Stacks `tags` file (lines "TAG,label").
"""

from __future__ import annotations

import json
import re
import zipfile
from pathlib import Path
from typing import Iterable

from .catalog import Catalog
from .latex.extract import extract_theorems

STACKS_AUTHOR = "Aise Johan de Jong"
STACKS_URL = "https://stacks.math.columbia.edu/tag/{tag}"


def load_tag_map(tags_path: str | Path) -> dict[str, str]:
    """Stacks tags file: 'TAG,label' lines (comments start with #).
    Returns label -> tag."""
    out: dict[str, str] = {}
    for line in Path(tags_path).read_text(encoding="utf-8").splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        tag, _, label = line.partition(",")
        if tag and label:
            out[label.strip()] = tag.strip()
    return out


def _section_rows(section_name: str, theorems: list[dict], tag_map: dict[str, str]):
    """paper row + theorem rows for one section; the section's tag is the
    tag of its first labeled item, else the section name slug."""
    tag = None
    for t in theorems:
        lbl = t.get("label")
        if lbl and lbl in tag_map:
            tag = tag_map[lbl]
            break
    paper_id = f"stacks-{tag or re.sub(r'[^a-zA-Z0-9]+', '-', section_name).strip('-').lower()}"
    paper = {
        "paper_id": paper_id,
        "title": f"The Stacks Project: {section_name}",
        "authors": [STACKS_AUTHOR],
        "summary": "",
        "link": STACKS_URL.format(tag=tag) if tag else "https://stacks.math.columbia.edu/",
        "last_updated": None,
        "journal_ref": None,
        "primary_category": "math.AG",
        "categories": ["math.AG"],
        "citations": None,
    }
    return paper, theorems


def upsert_stacks_from_json(
    catalog: Catalog,
    parsed: str | Path,
    tag_map: dict[str, str] | None = None,
) -> int:
    """parsed: a directory of per-section .json files or a .zip of them.
    Each JSON is a list of {theorem|name, body, label} dicts. Returns the
    number of theorems ingested."""
    tag_map = tag_map or {}
    sections: list[tuple[str, list[dict]]] = []
    parsed = Path(parsed)
    if parsed.suffix == ".zip":
        with zipfile.ZipFile(parsed) as zf:
            for name in zf.namelist():
                if name.endswith(".json"):
                    data = json.loads(zf.read(name))
                    sections.append((Path(name).stem, data))
    else:
        for f in sorted(parsed.glob("*.json")):
            sections.append((f.stem, json.loads(f.read_text())))

    n = 0
    for section_name, rows in sections:
        thms = [
            {
                "name": r.get("theorem") or r.get("name") or "Theorem.",
                "body": r.get("body", ""),
                "label": r.get("label"),
            }
            for r in rows
            if r.get("body")
        ]
        if not thms:
            continue
        paper, thms = _section_rows(section_name, thms, tag_map)
        catalog.upsert_paper(paper)
        catalog.replace_theorems(paper["paper_id"], thms, parsing_method="stacks-json")
        n += len(thms)
    return n


def upsert_stacks_from_tex(
    catalog: Catalog,
    tex_files: Iterable[str | Path],
    tag_map: dict[str, str] | None = None,
    preamble: str = "",
) -> int:
    """Parse raw Stacks chapter .tex files with the scanner extractor."""
    tag_map = tag_map or {}
    n = 0
    for path in tex_files:
        path = Path(path)
        src = preamble + "\n" + path.read_text(encoding="utf-8", errors="replace")
        thms = extract_theorems(src)
        rows = [{"name": t.name, "body": t.body, "label": t.label} for t in thms]
        if not rows:
            continue
        paper, rows = _section_rows(path.stem, rows, tag_map)
        catalog.upsert_paper(paper)
        catalog.replace_theorems(paper["paper_id"], rows, parsing_method="stacks-tex")
        n += len(rows)
    return n
