# Verbatim copy of theoremsearch_tpu/ingest/sources.py (jax-free). The port imports nothing of the
# reference package, so it carries its own copy; keep the two in sync.
"""Bulk source acquisition: arXiv S3 bundle locator + paper fetch/extract.

Capability-parity with the reference's data plane:
- bundle locator (ec2/locate_arxiv_in_s3/__main__.py:40-135): walk
  requester-pays s3://arxiv/src/arXiv_src*.tar bundles newest-first,
  record per-paper (bundle, byte-range) after validating the gzip magic,
  upsert into the catalog; resumable via --bundle-start / generator;
- ranged fetch (ec2/parse_arxiv_papers/download_and_extract_paper.py:25):
  byte-range GetObject on the bundle, arxiv.org/src fallback;
- format-sniffing extraction (:48-95): zip / tar / gzip->tar /
  gzip->single-tex / raw payload.

S3/HTTP access is injected so the pipeline is testable offline: the
locator takes any iterable of (bundle_key, tar_path-or-fileobj), and the
fetcher takes a `ranged_get(bundle, start, end) -> bytes`.
"""

from __future__ import annotations

import gzip
import io
import re
import tarfile
import zipfile
from pathlib import Path
from typing import Callable, Iterable, Iterator

from .catalog import Catalog

ARXIV_BUCKET = "arxiv"
GZIP_MAGIC = b"\x1f\x8b\x08"

_OLD_STYLE_RE = re.compile(r"^([a-z\-]+)(\d{7})$")


def normalize_arxiv_id(raw: str) -> str:
    """Drop version suffix and normalize old-style ids (math/0123456)."""
    # strip only a TRAILING version suffix — archives like 'solv-int'
    # contain 'v', so split-at-first-'v' would corrupt the id
    return re.sub(r"v\d+$", "", raw).strip()


def member_name_to_arxiv_id(member_name: str) -> str:
    """'2401/2401.12345.gz' or 'math0309136.gz' -> canonical arXiv id."""
    stem = member_name.rsplit("/", 1)[-1]
    if stem.endswith(".gz"):
        stem = stem[:-3]
    m = _OLD_STYLE_RE.match(stem)
    if m:
        return f"{m.group(1)}/{m.group(2)}"
    return stem


def locate_in_bundles(
    catalog: Catalog,
    bundles: Iterable[tuple[str, "io.IOBase | str"]],
    wanted: set[str] | None = None,
) -> Iterator[tuple[str, int]]:
    """Walk tar bundles, record byte ranges of wanted papers.

    bundles: (bundle_key, path-or-fileobj) pairs, typically newest-first.
    Yields (bundle_key, n_located) after each bundle for progress /
    resumability; the catalog upsert per bundle is the checkpoint."""
    if wanted is None:
        rows = catalog.conn.execute("SELECT paper_id FROM paper").fetchall()
        wanted = {normalize_arxiv_id(r[0]): r[0] for r in rows}
    else:
        wanted = {normalize_arxiv_id(w): w for w in wanted}

    for bundle_key, src in bundles:
        if not wanted:
            return
        locations = []
        fileobj = open(src, "rb") if isinstance(src, (str, Path)) else src
        try:
            with tarfile.open(fileobj=fileobj, mode="r:") as tar:
                for member in tar.getmembers():
                    if not member.isfile() or not member.name.endswith(".gz") or not member.size:
                        continue
                    pid = normalize_arxiv_id(member_name_to_arxiv_id(member.name))
                    if pid not in wanted:
                        continue
                    start = member.offset_data
                    fileobj.seek(start)
                    if fileobj.read(3) != GZIP_MAGIC:
                        continue
                    locations.append(
                        {
                            "paper_id": wanted.pop(pid),
                            "bundle_tar": bundle_key,
                            "offset_start": start,
                            "offset_end": start + member.size - 1,
                        }
                    )
        finally:
            if isinstance(src, (str, Path)):
                fileobj.close()
        if locations:
            catalog.upsert_rows("paper_arxiv_s3_location", locations, ["paper_id"])
        yield bundle_key, len(locations)


def s3_bundle_iterator(bundle_start: int = 0):
    """Production bundle source: list s3://arxiv/src/arXiv_src*.tar
    newest-first (requester pays). Gated on boto3 + credentials."""
    import tempfile

    import boto3  # gated import

    s3 = boto3.client("s3")
    keys = []
    for page in s3.get_paginator("list_objects_v2").paginate(
        Bucket=ARXIV_BUCKET, Prefix="src/arXiv_src", RequestPayer="requester"
    ):
        keys.extend(o["Key"] for o in page.get("Contents", []) if o["Key"].endswith(".tar"))
    keys.sort()
    for i, key in enumerate(reversed(keys)):
        # resume cursor: skip the FIRST bundle_start bundles of the
        # newest-first walk (the ones a previous run already processed,
        # locate_arxiv_in_s3/__main__.py:157-163 semantics)
        if i < bundle_start:
            continue
        tmp = tempfile.NamedTemporaryFile()
        s3.download_fileobj(ARXIV_BUCKET, key, tmp, ExtraArgs={"RequestPayer": "requester"})
        tmp.flush()
        tmp.seek(0)
        yield key, tmp


# ---------------------------------------------------------------------------
# fetch + extract
# ---------------------------------------------------------------------------


def default_ranged_get(bundle: str, start: int, end: int) -> bytes:
    import boto3  # gated import

    res = boto3.client("s3").get_object(
        Bucket=ARXIV_BUCKET, Key=bundle, Range=f"bytes={start}-{end}", RequestPayer="requester"
    )
    return res["Body"].read()


def fetch_paper_source(
    paper_id: str,
    s3_loc: tuple[str, int, int] | None,
    ranged_get: Callable[[str, int, int], bytes] | None = None,
) -> bytes:
    """Raw (usually gzipped) source bytes: byte-range read of the bundle,
    or the arxiv.org/src fallback when no location is known."""
    if s3_loc is not None:
        get = ranged_get or default_ranged_get
        return get(*s3_loc)
    import requests  # gated import

    res = requests.get(f"https://arxiv.org/src/{paper_id}", timeout=60)
    res.raise_for_status()
    return res.content


def extract_source_tree(data: bytes, out_dir: str | Path) -> Path:
    """Format-sniffing extraction into out_dir: zip / tar / gzip->tar /
    gzip->single-tex / raw payload (reference extract_paper_src order)."""
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)

    def try_tar(buf: bytes) -> bool:
        try:
            with tarfile.open(fileobj=io.BytesIO(buf), mode="r:*") as tf:
                tf.extractall(path=out, filter="data")
            return True
        except (tarfile.ReadError, tarfile.TarError):
            return False

    if data[:4] == b"PK\x03\x04":
        with zipfile.ZipFile(io.BytesIO(data)) as zf:
            zf.extractall(out)
        return out
    if try_tar(data):
        return out
    def write_payload(payload: bytes) -> None:
        # arXiv serves a PDF for papers with no TeX source (observed in
        # the wild: downloaded_sources/2509.19389v1 is %PDF despite its
        # .tar.gz name); don't masquerade binary payloads as main.tex
        if payload[:5] == b"%PDF-":
            (out / "paper.pdf").write_bytes(payload)
        else:
            (out / "main.tex").write_bytes(payload)

    if data[:2] == b"\x1f\x8b":
        payload = gzip.decompress(data)
        if try_tar(payload):
            return out
        write_payload(payload)
        return out
    write_payload(data)
    return out
