"""Streaming index builder with checkpoint/resume (port of
theoremsearch_tpu/index/builder.py).

Embedding batches are appended to a spool directory with a JSON manifest
recording the cursor; an interrupted build resumes from the last durable
batch, and `finalize` / `finalize_ivf` pack everything into a FlatIndex
or an IVFIndex. The spool's layout is the reference's, so either package
resumes the other's spool.
"""

from __future__ import annotations

import json
import warnings
from pathlib import Path
from typing import Iterator

import numpy as np

from ..core.config import IndexConfig
from .flat import FlatIndex


class IndexBuilder:
    """Append-only spool of (ids, embeddings) batches.

    Usage:
        b = IndexBuilder(dir, config)
        for ids, emb in batches:           # resume: skip ids <= b.cursor
            b.add(ids, emb)
        index = b.finalize()
    """

    def __init__(self, spool_dir: str | Path, config: IndexConfig | None = None):
        self.dir = Path(spool_dir)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.manifest_path = self.dir / "build_manifest.json"
        if self.manifest_path.exists():
            self.manifest = json.loads(self.manifest_path.read_text())
            self.config = IndexConfig.from_dict(self.manifest["config"])
            if config is not None and config.to_dict() != self.config.to_dict():
                raise ValueError("resuming build with a different IndexConfig")
        else:
            self.config = config or IndexConfig()
            self.manifest = {"config": self.config.to_dict(), "batches": [], "max_id": -1,
                             "total_rows": 0}
            self._write_manifest()

    @property
    def cursor(self) -> int:
        """Largest doc id already spooled: work selection can skip ids <=
        cursor (keyset-pagination resume)."""
        return int(self.manifest["max_id"])

    @property
    def total_rows(self) -> int:
        return int(self.manifest["total_rows"])

    def add(self, ids: np.ndarray, embeddings: np.ndarray) -> None:
        ids = np.asarray(ids, dtype=np.int64)
        emb = np.asarray(embeddings, dtype=np.float32)
        if ids.shape[0] != emb.shape[0]:
            raise ValueError("ids/embeddings length mismatch")
        if emb.shape[0] == 0:
            return
        name = f"batch_{len(self.manifest['batches']):06d}"
        # data first, then the manifest: a crash between the two leaves an
        # orphan file that finalize ignores
        np.save(self.dir / f"{name}.ids.npy", ids)
        np.save(self.dir / f"{name}.emb.npy", emb)
        self.manifest["batches"].append({"name": name, "rows": int(emb.shape[0])})
        self.manifest["max_id"] = max(self.cursor, int(ids.max()))
        self.manifest["total_rows"] += int(emb.shape[0])
        self._write_manifest()

    def batches(self) -> Iterator[tuple[np.ndarray, np.ndarray]]:
        for b in self.manifest["batches"]:
            yield (np.load(self.dir / f"{b['name']}.ids.npy"),
                   np.load(self.dir / f"{b['name']}.emb.npy"))

    def _load_deduped(self) -> tuple[np.ndarray, np.ndarray]:
        """All spooled (ids, embeddings); a re-added id (restart overlap,
        or a repeat inside one batch) keeps its first copy, like an
        upsert. Shared by the flat and IVF finalizers."""
        if not self.manifest["batches"]:
            raise ValueError("no batches spooled")
        all_ids, all_emb = [], []
        seen: set[int] = set()
        for ids, emb in self.batches():
            mask = np.zeros(ids.shape[0], bool)
            for j, i in enumerate(ids.tolist()):
                if i not in seen:
                    seen.add(i)
                    mask[j] = True
            if mask.any():
                all_ids.append(ids[mask])
                all_emb.append(emb[mask])
        return np.concatenate(all_ids), np.concatenate(all_emb)

    def finalize(self, normalize: bool = True, device=None) -> FlatIndex:
        """A FlatIndex of the spool, built on `device` (default: the card)."""
        ids, emb = self._load_deduped()
        return FlatIndex.build(emb, ids=ids, config=self.config, normalize=normalize,
                               device=device)

    def finalize_ivf(
        self,
        normalize: bool = True,
        slab_rows: int | None = None,
        calibrate_gate: float | None = None,
        device=None,
    ):
        """Pack the spool into an IVFIndex on `device` (default: the card),
        with the build's checkpoints in the spool dir (k-means rounds and
        the assignment resume) and optional nprobe calibration against the
        recall gate.

        Returns (IVFIndex, calibration): calibration is (nprobe,
        min_recall) when calibrate_gate is set, else None. The picked
        nprobe goes into the index config, marked calibrated only if it
        cleared the gate. Calibration searches in batches of 16, the
        largest batch the engine sends the IVF route
        (`SearchEngine(ivf_max_batch=16)`): recall is measured at the
        batch that is served, not at the reference's 64."""
        from .ivf import IVFIndex, calibrate_nprobe

        ids, emb = self._load_deduped()
        index = IVFIndex.build(emb, ids=ids, config=self.config, slab_rows=slab_rows,
                               normalize=normalize, checkpoint_dir=self.dir, device=device)
        calib = None
        if calibrate_gate is not None:
            calib = calibrate_nprobe(index, emb, gate=calibrate_gate, ids=ids, normalize=normalize,
                                     query_batch=16)
            # calibrate_nprobe returns its best candidate even when none
            # clears the gate; the engine trusts a calibrated nprobe
            # verbatim, so a below-gate pick must not be stamped as one
            cleared = float(calib[1]) >= float(calibrate_gate)
            if not cleared:
                warnings.warn(
                    f"nprobe calibration did not clear the {calibrate_gate} recall gate "
                    f"(best: nprobe={calib[0]} at recall={calib[1]:.4f}); recording it "
                    "UNCALIBRATED — prefer the flat scan on this corpus",
                    stacklevel=2,
                )
            index.config = index.config.replace(ivf_nprobe=int(calib[0]),
                                                ivf_nprobe_calibrated=cleared)
        return index, calib

    def _write_manifest(self) -> None:
        tmp = self.manifest_path.with_suffix(".tmp")
        tmp.write_text(json.dumps(self.manifest, indent=2))
        tmp.replace(self.manifest_path)
