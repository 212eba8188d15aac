"""The query engine on one device (port of
theoremsearch_tpu/search/engine.py, single-device routes).

Two routes, chosen from the index at construction:

- the speed path (a global-scale int8 index with a rescore copy and
  row-order doc ids): packed lane-maxima scan (`kernels/mips.py:
  fused_mips_topk_g`, CUDA kernel B1 on the card) -> exact rescore of the
  oversampled candidates on the device, against the bf16 copy or, in the
  residual capacity mode (2 bytes/dim), against the two-level int8
  reconstruction (`device_rescore_residual`). Filters stream through the
  same scan as a row mask, or one mask row per query for a heterogeneous
  batch (the grouped form);
- the exact route (any other index: per-row-scale int8, bf16, f32, a
  global-scale index without a rescore copy, custom doc ids): fused scores
  + exact top-k (`kernels/mips.py:fused_mips_topk`, CUDA kernel B5), with
  filters as a 0 / -inf row bias and an optional host rescore against the
  rescore copy or the residual codes.

With an IVF index (`ivf_index=`), unfiltered batches of at most
`ivf_max_batch` real queries take the IVF route instead: the probe-major
search (`index/ivf.py:IVFIndex.device_searcher`, kernel B6 on the card),
rescored on the device. Filtered batches never probe.

Live updates: added documents land in a delta buffer (`search/delta.py`)
whose exact f32 top-k merges into every query; deleted main rows are
tombstones, dropped on the host from a k + margin over-fetch on the
unfiltered routes and folded into the filter masks on the masked ones;
`compact()` folds the delta into the index on the device while queries
run, and `compact(reclaim=True)` also drops the tombstoned rows and
renumbers the ids. Broad filters (at least half the rows pass) stay on
the unfiltered flat route the same way. Then row -> doc-id map, optional
citation-weighted rerank, metadata join.

Under a mesh (`core/meshes.py`; the reference's `shard_map` programs,
`engine.py:1943-2200`) the rows are sharded over the mesh's shard axis,
padded so that each shard holds `rows_per_shard` rows, a multiple of
`row_block`. Each shard's codes, ids, scales and rescore data live on its
device; every route runs once a shard (the speed path's scan and local
rescore, the masked and grouped forms with the masks sharded like the
rows, the exact route's kernel) with the shard's own valid row count, and
the per-shard top-k lists are copied to the mesh's first device in shard
order and merged there (`kernels/mips.py:merge_topk`, the reference's
`all_gather` + `lax.top_k`). The speed path's per-shard candidate width
is the reference's sharded one, `min(max(k, rescore_factor * k),
rows_per_shard)`. The delta, the tombstones and the host-side steps live
once, on the first device; the IVF route takes the list-sharded searcher
(`IVFIndex.sharded_searcher`); compact rebuilds the shards from the
folded host arrays, as the reference does under a mesh.

Across processes (a mesh from `make_mesh` after
`core/distributed.py:initialize`) every process holds the full host
index, as the reference's multi-process worker does, and places only its
own shards, each keeping its global index and first row. Each process
runs its shards, the per-shard lists are all-gathered over the mesh's
row group (the processes of its data row) in global shard order and
merged once on each process's first device, so the result is replicated
and bit-equal to a one-process mesh of the same shards; every data row
runs the same search, as the reference replicates `data`. The delta, the tombstones, the filter caches
and every host step are replicated: each process applies the same
mutation stream, and the route of a batch depends on replicated state
alone, so every process joins the same collectives in the same order.

Streams: queries, the delta and compact's device fold run on the current
(default) stream, so their order is the stream's; only multi-GB host
uploads go through a side stream (`utils/device.py:upload_into`).

A search's host stages run under the spans (`utils/profiling.py:span`)
`ts.engine.upload` (the queries padded and copied up), `ts.engine.scan`
(B1 with the query quantization and the candidate selection; B5 on the
exact route, the IVF searcher on its route), `ts.engine.rescore` (the
device rescore and the row -> doc-id map), `ts.engine.to_host` (the
copies back queued), and in `finalize` `ts.engine.wait` (the batch's
event) and `ts.engine.finalize` (the host's work on the results).
"""

from __future__ import annotations

import itertools
import math
import os
import threading
import time
import warnings
from typing import Any

import numpy as np
import torch

from ..core.config import SearchConfig
from ..core.meshes import gather_shard_lists
from ..index.flat import PAD_ID, FlatIndex
from ..kernels._build import load as _load_kernels
from ..kernels.mips import (
    NEG_INF, device_rescore, device_rescore_residual, fused_mips_topk, fused_mips_topk_g,
    merge_topk, residual_rows,
)
from ..utils.device import resolve_device, upload, upload_into
from ..utils.profiling import span
from ..utils.shapes import pow2_bucket, round_up as _round_up
from .filters import SearchFilters, compile_filter_mask, filter_key, infer_type
from .metadata import CorpusMetadata

# Over-fetch margins for the drop-on-host routes: deletes, or a BROAD
# user filter, stay on the fast unfiltered route, fetch k + margin and
# drop failing ids on the host. Exact whenever a query's top-(k+margin)
# window holds <= margin dropped docs: guaranteed outright while no more
# docs are deleted than the margin, verified per batch otherwise, with
# the masked route as the exact re-run. The margin is the smallest entry
# at >= 6-sigma odds against that re-run (binomial over the window at
# the drop rate); a 50% filter needs the full 64.
_OVERFETCH_MARGINS = (8, 16, 32, 64)
# minimum pass rate for the over-fetch route: below it the masked scan's
# selectivity pays for itself
_OVERFETCH_MIN_PASS = 0.5
_FILTER_CACHE_MAX = 64


def _host_rows(x) -> torch.Tensor:
    """A CPU tensor view of host rows (numpy is wrapped, not copied)."""
    if isinstance(x, np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(x))
    return x.cpu()


def _np(t) -> np.ndarray:
    """A numpy view of a host tensor (or the array itself)."""
    return t if isinstance(t, np.ndarray) else t.cpu().numpy()


def _fold_device_rows(old_dev: torch.Tensor, n_fold: int, target_rows: int, new_rows=None,
                      start: int = 0, upd_idx=None, upd_vals=None, keep=None) -> torch.Tensor:
    """Grow a device row array without uploading it again: zeros <- old_dev
    (device to device) <- the new rows at `start` (the only host upload,
    delta-sized) <- scattered row updates, `target_rows` rows in all.
    With `keep` (device int64 rows of the `n_fold`-row fold), the result
    is those rows in order, zero-padded to `target_rows` (reclaim). Host
    rows convert to old_dev's dtype on the host, as a fresh upload's do."""
    dt, dev = old_dev.dtype, old_dev.device
    rows = n_fold if keep is not None else target_rows
    buf = torch.zeros((rows, old_dev.shape[1]), dtype=dt, device=dev)
    n_old = min(int(old_dev.shape[0]), rows)
    buf[:n_old] = old_dev[:n_old]
    if new_rows is not None and new_rows.shape[0]:
        buf[start : start + new_rows.shape[0]] = upload(_host_rows(new_rows).to(dt), dev)
    if upd_idx is not None and len(upd_idx):
        buf[upload(np.asarray(upd_idx, np.int64), dev)] = upload(_host_rows(upd_vals).to(dt), dev)
    if keep is not None:
        out = torch.zeros((target_rows, buf.shape[1]), dtype=dt, device=dev)
        out[: keep.shape[0]] = buf[keep]
        buf = out
    return buf


class SearchEngine:
    """Owns the device-resident index and runs batched queries.

    index: FlatIndex (int8 with per-row or global scale, bf16 or f32).
    rescore_vectors: optional (num_rows, D) originals (numpy or a tensor,
        any float dtype). With a global-scale int8 index and row-order doc
        ids they are held on the device as bf16 for the speed path's
        rescore; otherwise the exact route rescores on the host from them.
    rescore_residual: instead of rescore_vectors, (res_codes int8 (N, D),
        res_scales f32 (N,)) from `quantize_residual_int8`: the rescore
        rebuilds gscale*cg + s_r*cr (~15 effective bits) at 2 bytes/dim in
        all. Needs a global-scale int8 index and row-order doc ids; an
        index built with config.residual carries them and is adopted.
    device: where the index lives and the scans run. Default: the card
        (RuntimeError without CUDA); "cpu" runs the kernels' plain
        versions.
    mesh: a `core/meshes.py` Mesh: the rows are sharded over its shard
        axis (see the module docstring); `device`, if given, must be the
        mesh's first device, where results are merged.
    ivf_index: optional IVFIndex on the same device, the low-latency
        route for small unfiltered batches (at most `ivf_max_batch` real
        queries). ivf_nprobe: an explicit value wins; else a calibrated
        index's nprobe is trusted verbatim; else the IVF route stays off
        and every batch takes the flat scan (the reference probes 16
        lists here, which holds the 0.99 gate only on well-separated
        clusters).
    device_init: compact()'s device fold: device tensors ("vectors",
        "rescore", "res_codes"), padded as this constructor pads the host
        data, that replace those uploads; a shape or dtype mismatch raises.
    """

    # distinct filter signatures one grouped scan carries; beyond it the
    # dispatch splits (G pads to a power of two in [8, 32])
    max_filter_groups = 32

    def __init__(
        self,
        index: FlatIndex,
        meta: CorpusMetadata | None = None,
        config: SearchConfig | None = None,
        row_block: int | None = None,
        rescore_vectors=None,
        rescore_residual=None,
        rescore_factor: int = 4,
        device=None,
        mesh=None,
        ivf_index=None,
        ivf_nprobe: int | None = None,
        ivf_max_batch: int = 16,
        device_init: dict | None = None,
    ):
        self.meta = meta
        self.config = config or SearchConfig()
        self.mesh = mesh
        if mesh is not None:
            first = mesh.first_device
            if device is not None and resolve_device(device) != first:
                raise ValueError(f"device={device} disagrees with the mesh's first device {first}")
            self.device = first
        else:
            self.device = resolve_device(device)
        self.n_shards = mesh.shape["shard"] if mesh is not None else 1
        self.rescore_factor = rescore_factor
        self._global_scale = float(getattr(index, "global_scale", 0.0) or 0.0)

        if rescore_residual is not None and rescore_vectors is not None:
            raise ValueError("pass rescore_vectors OR rescore_residual, not both")
        ids_all = _np(index.ids)
        if rescore_residual is None and rescore_vectors is None:
            # adopt the capacity mode's data packed into the index, only
            # with row-order doc ids (the mode's requirement)
            auto = getattr(index, "rescore_residual", None)
            if auto is not None:
                n_auto = auto[0].shape[0]
                if np.array_equal(ids_all[:n_auto], np.arange(n_auto, dtype=ids_all.dtype)):
                    rescore_residual = auto
                else:
                    warnings.warn(
                        "index carries residual rescore data but doc ids are not row-order; "
                        "rescoring disabled: reorder the corpus so ids == arange", stacklevel=2)
        if rescore_residual is not None:
            rc, rs = (torch.as_tensor(a) for a in rescore_residual)
            if rc.dtype != torch.int8 or rc.shape[0] != index.num_rows:
                raise ValueError(f"rescore_residual codes must be int8 with {index.num_rows} "
                                 f"rows, got {rc.dtype} {tuple(rc.shape)}")
            if tuple(rs.shape) != (rc.shape[0],):
                raise ValueError("rescore_residual scales must be (N,)")
            if not self._global_scale > 0:
                raise ValueError("rescore_residual requires a global-scale int8 index "
                                 "(the residual is relative to gscale*codes)")
            if not np.array_equal(ids_all[: rc.shape[0]], np.arange(rc.shape[0])):
                raise ValueError("rescore_residual requires row-order doc ids (ids == arange); "
                                 "reorder the corpus before building")
            rescore_residual = (rc, rs.float())
        self.rescore_residual = rescore_residual

        if row_block is None:
            # the reference's corpus-sized default: largest power of two
            # <= rows/64, clamped to [128, 4096] and by the packing bound
            n0 = max(int(index.vectors.shape[0]) // 64, 1)
            row_block = min(4096, max(128, 1 << (n0.bit_length() - 1)))
            dim0 = int(index.vectors.shape[1])
            while row_block > 128 and 127 * 127 * dim0 * (row_block // 128) >= 2**31:
                row_block //= 2
        self.row_block = row_block

        vecs, scales = index.vectors, index.scales
        ids = torch.as_tensor(ids_all)
        target = _round_up(vecs.shape[0], self.n_shards * row_block)
        extra = target - vecs.shape[0]
        if extra:
            vecs = torch.cat([vecs, torch.zeros((extra, vecs.shape[1]), dtype=vecs.dtype,
                                                device=vecs.device)])
            ids = torch.cat([ids, torch.full((extra,), PAD_ID, dtype=ids.dtype)])
            if scales is not None:
                scales = torch.cat([scales, torch.zeros(extra, dtype=scales.dtype,
                                                        device=scales.device)])
        self.n_valid = index.num_rows
        self.padded_rows = target
        self.rows_per_shard = target // self.n_shards
        self.dim = vecs.shape[1]
        self._host_ids = ids.numpy()
        ids_h = self._host_ids[: self.n_valid]
        self._main_ids_arange = bool(
            np.array_equal(ids_h, np.arange(self.n_valid, dtype=ids_h.dtype)))

        if rescore_vectors is not None and rescore_vectors.shape[0] != index.num_rows:
            raise ValueError(
                f"rescore_vectors has {rescore_vectors.shape[0]} rows, index has {index.num_rows}"
            )
        self.rescore_vectors = None if rescore_vectors is None else _host_rows(rescore_vectors)
        # rescore row r holds the original of index row r, whose DOC id is
        # ids[r]; custom ids need an id -> row map for the host rescore
        self._rescore_sorted_ids = None
        self._rescore_order = None
        if self.rescore_vectors is not None and not self._main_ids_arange:
            order = np.argsort(ids_h)
            self._rescore_sorted_ids = ids_h[order]
            self._rescore_order = order
        # the scan codes, for the residual mode's host rescore
        self._host_codes = index.vectors if rescore_residual is not None else None
        has_rescore = self.rescore_vectors is not None or rescore_residual is not None
        rb_ok = not (row_block % 128 or (row_block // 128) & (row_block // 128 - 1))
        self._speed_ok = (
            self._global_scale > 0
            and vecs.dtype == torch.int8
            and has_rescore
            and self._main_ids_arange            # rescore rows == doc ids
            and self.padded_rows % max(row_block, 128) == 0
            and rb_ok
        )

        di = device_init or {}

        def _di(key: str, shape: tuple, dtype) -> torch.Tensor | None:
            arr = di.get(key)
            if arr is not None and (tuple(arr.shape) != tuple(shape) or arr.dtype != dtype
                                    or arr.device != self.device):
                raise ValueError(f"device_init[{key!r}] is {arr.dtype}{tuple(arr.shape)} on "
                                 f"{arr.device}, the engine needs {dtype}{tuple(shape)}")
            return arr

        self._rescore_device = None
        self._res_codes_device = None
        self._res_scales_device = None
        self._shards = None
        if mesh is not None:
            if device_init:
                raise ValueError("device_init is single-device only")
            self.vectors = self.ids = self.scales = None
            self._shards = self._shard_arrays(vecs, ids, scales, rescore_residual)
        else:
            self.vectors = _di("vectors", tuple(vecs.shape), vecs.dtype)
            if self.vectors is None:
                self.vectors = self._upload_rows(vecs)
            self.ids = ids.to(torch.int32).to(self.device)
            self.scales = None if scales is None else scales.float().to(self.device).contiguous()
            if self._speed_ok and rescore_residual is not None:
                rc, rs = rescore_residual
                self._res_codes_device = _di("res_codes", tuple(rc.shape), torch.int8)
                if self._res_codes_device is None:
                    self._res_codes_device = self._upload_rows(rc)
                self._res_scales_device = rs.to(self.device).contiguous()
            elif self._speed_ok:
                rv = self.rescore_vectors
                self._rescore_device = _di("rescore", tuple(rv.shape), torch.bfloat16)
                if self._rescore_device is None:
                    self._rescore_device = self._upload_rows(rv, torch.bfloat16)

        # per-filter-signature (np mask, device mask | bias, pass rate),
        # bounded; the lock also guards the mask-build counters, which
        # attribute first-sight O(N) mask builds in serving traces
        self._filter_cache: dict[tuple, tuple] = {}
        self._filter_cache_lock = threading.Lock()
        self._pass_fail_cache = None
        self.filter_mask_builds = 0
        self.filter_mask_build_s = 0.0
        # dispatches per route (speed, exact, ivf, masked, exact_masked,
        # overfetch, overfetch_rerun, grouped, empty): which route served
        # a batch, for traces and the smoke's route checks
        self.route_counts: dict[str, int] = {}

        # the IVF route for small unfiltered batches. nprobe: an explicit
        # value wins; a calibrated one (it cleared the recall gate at the
        # serving batch) is trusted verbatim; an uncalibrated index with
        # no explicit nprobe leaves the route off (ivf_nprobe None): no
        # nprobe is known to hold the gate on it. Deletes keep the route
        # (over-fetch and a host drop of tombstoned ids).
        if ivf_index is not None and ivf_index.device != self.device:
            raise ValueError(f"ivf_index lives on {ivf_index.device}, the engine on {self.device}")
        if ivf_nprobe:
            self.ivf_nprobe = int(ivf_nprobe)
        elif ivf_index is not None and ivf_index.config.ivf_nprobe_calibrated:
            self.ivf_nprobe = int(ivf_index.config.ivf_nprobe)
        else:
            self.ivf_nprobe = None
        self.ivf = ivf_index if self.ivf_nprobe is not None else None
        # IVF wins only at small batches: its selection scales with the
        # probed width, and batch-deduped probing approaches every list
        # as B grows; bigger batches take the flat scan
        self.ivf_max_batch = ivf_max_batch
        self._ivf_fns: dict = {}
        if self.ivf is not None:
            # uploads the index once, like the flat index, and refuses one
            # the probe-major route cannot search
            self._ivf_fn(self.config.top_k)

        # ---- live updates: adds land in a delta buffer merged into every
        # query; deletes tombstone main rows ----
        self.index = index
        self._delta = None                     # DeltaBuffer, lazy
        self._delta_meta_rows: list = []       # meta of delta docs, in order
        # (doc_id, cols) log of update_document(meta_row=...) calls made
        # while a reclaim compact builds: the build copies the metadata
        # early, and the swap replays these onto the copy
        self._meta_update_log: list | None = None
        self._tombstone = None                 # (n_valid,) bool, True = deleted
        self._tomb_epoch = 0                   # bumps on main-row deletes
        self._tomb_mask_cache: dict[tuple, tuple] = {}
        self._tomb_ids_cache: tuple | None = None      # (epoch, sorted ids)
        self._delta_bias_cache: dict[tuple, Any] = {}
        # RLock: every dispatch holds it (a compact cannot swap state
        # under a half-built dispatch), and the mask and snapshot helpers
        # re-enter it
        self._live_lock = threading.RLock()
        # serializes whole compact() runs (the build is off-lock)
        self._compact_lock = threading.Lock()
        # doc-id generation: bumps on compact(reclaim=True); the remap
        # chain translates ids of queries dispatched before a renumber
        self._generation = 0
        self._remap_chain: list[tuple] = []   # (gen, id_map, n_dropped)
        self.last_id_map = None                # latest reclaim's map
        self.last_compact_stats: dict | None = None
        self._main_id_sorted = None            # lazy id -> row map (custom ids)
        self._main_id_order = None
        self._next_doc_id = int(ids_h.max()) + 1 if self.n_valid else 0
        # compact() builds its new engine with these
        self._ctor = dict(meta=meta, config=config, row_block=row_block,
                          rescore_factor=rescore_factor, device=self.device, mesh=mesh,
                          ivf_max_batch=ivf_max_batch)

    def _upload_rows(self, rows: torch.Tensor, dtype=None, device=None,
                     n_rows: int | None = None) -> torch.Tensor:
        """A (n_rows, ...) array on `device` (default: the engine's) in
        `dtype`: `rows` zero-padded to n_rows (default: its own length). A
        device tensor of the right device, dtype and length is taken as it
        is; host rows go through the side stream in 64k-row chunks,
        converted on the way (a whole f32 upload would double the device
        footprint while it converts)."""
        dtype = dtype or rows.dtype
        device = device or self.device
        n = int(rows.shape[0])
        n_rows = n if n_rows is None else n_rows
        if rows.device == device and rows.dtype == dtype and n == n_rows:
            return rows.contiguous()
        out = torch.zeros((n_rows, *rows.shape[1:]), dtype=dtype, device=device)
        for i in range(0, n, 65_536):
            upload_into(out[i : min(i + 65_536, n)], rows[i : i + 65_536].to(dtype))
        return out

    def _shard_arrays(self, vecs, ids, scales, rescore_residual) -> list[dict]:
        """Per shard this process holds (every shard in one process; a
        contiguous block of them on a row split over processes): its
        device, its first row (`s * rows_per_shard` for global shard s),
        its valid row count
        (`clip(n_valid - s * rows_per_shard, 0, rows_per_shard)`, the
        reference's `local_valid`) and its slices of the padded codes, ids
        and scales and of the rescore data, on its device."""
        rps = self.rows_per_shard
        shards = []
        for s, dev in self.mesh.local_shards:
            lo = s * rps
            sh = {"device": dev, "lo": lo,
                  "valid": int(min(max(self.n_valid - lo, 0), rps)),
                  "vectors": self._upload_rows(vecs[lo : lo + rps], device=dev),
                  "ids": ids[lo : lo + rps].to(torch.int32).to(dev),
                  "scales": None if scales is None
                  else scales[lo : lo + rps].float().to(dev).contiguous(),
                  "rescore": None, "res_codes": None, "res_scales": None}
            if self._speed_ok and rescore_residual is not None:
                rc, rs = rescore_residual
                sh["res_codes"] = self._upload_rows(rc[lo : lo + rps], device=dev, n_rows=rps)
                sh["res_scales"] = self._upload_rows(rs[lo : lo + rps], device=dev, n_rows=rps)
            elif self._speed_ok:
                sh["rescore"] = self._upload_rows(self.rescore_vectors[lo : lo + rps],
                                                  torch.bfloat16, dev, rps)
            shards.append(sh)
        return shards

    def _put_rows(self, host_rows: np.ndarray):
        """A padded (padded_rows,) host row array on the device: one tensor,
        or under a mesh one slice a shard on its device."""
        if self._shards is None:
            return upload(host_rows, self.device)
        rps = self.rows_per_shard
        return [upload(host_rows[sh["lo"] : sh["lo"] + rps], sh["device"]) for sh in self._shards]

    # ------------------------------------------------------------------
    # live updates (upsert -> searchable, the reference's pgvector
    # semantics)
    # ------------------------------------------------------------------

    def _new_delta(self):
        from .delta import DeltaBuffer

        return DeltaBuffer(self.dim, self.device)

    def _doc_row(self, doc_id: int) -> int | None:
        """Main-index row of a doc id, or None if absent."""
        if self._main_ids_arange:
            return int(doc_id) if 0 <= doc_id < self.n_valid else None
        if self._main_id_sorted is None:
            ids_h = self._host_ids[: self.n_valid]
            order = np.argsort(ids_h)
            self._main_id_sorted = ids_h[order]
            self._main_id_order = order
        pos = int(np.searchsorted(self._main_id_sorted, doc_id))
        if pos < self._main_id_sorted.shape[0] and self._main_id_sorted[pos] == doc_id:
            return int(self._main_id_order[pos])
        return None

    def _as_rows(self, embeddings) -> np.ndarray:
        if isinstance(embeddings, torch.Tensor):
            embeddings = embeddings.detach().float().cpu().numpy()
        emb = np.asarray(embeddings, np.float32)
        if emb.ndim == 1:
            emb = emb[None, :]
        if emb.ndim != 2 or emb.shape[1] != self.dim:
            raise ValueError(f"embeddings must be (m, {self.dim})")
        return emb

    def _normalize_rows(self, embeddings) -> np.ndarray:
        emb = self._as_rows(embeddings)
        norms = np.linalg.norm(emb, axis=1, keepdims=True)
        return emb / np.maximum(norms, 1e-12)

    def add_documents(self, embeddings, meta_rows: list[dict] | None = None,
                      normalize: bool = True) -> np.ndarray:
        """Append new documents; they are searchable by the next query.
        Returns the assigned doc ids (sequential). With metadata serving,
        meta_rows (one dict per doc, CorpusMetadata.from_rows spec) is
        required so filters and joins cover the new docs."""
        # the unnormalized branch still validates the shape: a 1-D (D,)
        # vector must become one doc
        emb = self._normalize_rows(embeddings) if normalize else self._as_rows(embeddings)
        m = emb.shape[0]
        with self._live_lock:
            if self.meta is not None:
                if meta_rows is None or len(meta_rows) != m:
                    raise ValueError("metadata serving requires one meta_rows dict per doc")
                if not self._main_ids_arange:
                    # metadata columns are indexed by doc id; ids minted
                    # from len(meta) could collide with live custom ids
                    raise ValueError("live adds with metadata require row-order doc ids "
                                     "(ids == arange); rebuild the corpus id-ordered")
                ids_arr = len(self.meta) + np.arange(m, dtype=np.int64)
                self.meta.extend(meta_rows)
                self._delta_meta_rows.extend(meta_rows)
                self._next_doc_id = max(self._next_doc_id, int(ids_arr[-1]) + 1)
            else:
                ids_arr = self._next_doc_id + np.arange(m, dtype=np.int64)
                self._next_doc_id += m
            if self._delta is None:
                self._delta = self._new_delta()
            self._delta.add(emb, ids_arr)
            self._delta_bias_cache.clear()
        return ids_arr

    def update_document(self, doc_id: int, embedding, meta_row: dict | None = None) -> None:
        """Upsert an existing doc id: tombstone its current row and insert
        the new vector into the delta under the same id (pgvector's ON
        CONFLICT UPDATE). meta_row keys, when given, overwrite that doc's
        columns."""
        emb = self._normalize_rows(embedding)
        with self._live_lock:
            if self.meta is not None and not self._main_ids_arange:
                # checked before any mutation: the delete must not land if
                # the metadata step would raise
                raise ValueError("live updates with metadata require row-order doc ids "
                                 "(ids == arange); rebuild the corpus id-ordered")
            if not self._delete_locked([int(doc_id)]):
                raise KeyError(f"doc id {doc_id} is not live")
            if self.meta is not None:
                if meta_row:
                    self.meta.update_row(int(doc_id), meta_row)
                    if self._meta_update_log is not None:
                        self._meta_update_log.append((int(doc_id), dict(meta_row)))
                self._delta_meta_rows.append(self.meta.row_as_dict(int(doc_id)))
            if self._delta is None:
                self._delta = self._new_delta()
            self._delta.add(emb, np.array([doc_id], np.int64))
            self._delta_bias_cache.clear()

    def delete_documents(self, doc_ids) -> int:
        """Tombstone docs by id; returns how many were live. Main rows
        leave every later scan (over-fetch and a host drop, or the masks);
        delta rows get a -inf bias. compact(reclaim=True) frees them."""
        with self._live_lock:
            return self._delete_locked([int(d) for d in np.atleast_1d(doc_ids)])

    def _delete_locked(self, doc_ids: list[int]) -> int:
        killed_delta: list[int] = []
        main_hit = False
        n = 0
        for d in doc_ids:
            if self._delta is not None:
                r = self._delta.row_of(d)
                if r is not None:
                    killed_delta.append(r)
                    n += 1
                    continue
            row = self._doc_row(d)
            if row is not None and not (self._tombstone is not None and self._tombstone[row]):
                if self._tombstone is None:
                    self._tombstone = np.zeros(self.n_valid, bool)
                self._tombstone[row] = True
                main_hit = True
                n += 1
        if killed_delta:
            self._delta.kill_rows(killed_delta)
        if main_hit:
            self._tomb_epoch += 1
            self._tomb_mask_cache.clear()
        return n

    @property
    def num_live(self) -> int:
        """Documents a query can return now."""
        d = self._delta.n_live if self._delta is not None else 0
        t = int(self._tombstone.sum()) if self._tombstone is not None else 0
        return self.n_valid - t + d

    # ------------------------------------------------------------------
    # compact: fold the delta into the index while queries run
    # ------------------------------------------------------------------

    def compact(self, reclaim: bool = False, warm_batches=None) -> int:
        """Fold live delta rows into the packed index (quantized with the
        index's own scheme: the global scale is kept, so scores stay
        comparable) and swap the rebuilt state in without stopping
        serving. Returns the live rows folded in.

        1. snapshot (brief lock): delta rows and tombstones.
        2. build (no lock): the new host index and, on the device, the
           new arrays folded from the old device copies plus the delta
           rows; queries keep running against the old state.
        3. swap (brief lock): install the new state and reconcile what
           arrived during the build: adds stay in the delta, deletes or
           updates of folded docs tombstone their new rows.

        reclaim=True also drops tombstoned rows and renumbers doc ids
        dense (row-order ids required): metadata follows the same
        permutation, `last_id_map` gives old id -> new id (-1 = dropped),
        and a remap chain translates the ids of queries dispatched before
        the renumbering. The IVF route survives: folded rows go to their
        nearest existing centroids (`IVFIndex.with_updates`).

        warm_batches: the reference's padded batch sizes whose scan
        programs it compiles before the swap. The port compiles no
        programs, and what phase 2b builds (the IVF searcher for each k,
        the grouped pass/fail rows) does not depend on the batch size, so
        the argument is checked (positive ints or None) and changes
        nothing else."""
        if warm_batches is not None and not all(
                isinstance(b, (int, np.integer)) and b > 0 for b in warm_batches):
            raise ValueError(f"warm_batches must be positive ints, got {warm_batches!r}")
        result: list = [None]
        error: list = [None]

        def _run():
            # the build runs on a disposable thread that lowers its own
            # priority (an unprivileged thread cannot raise it back)
            try:
                os.setpriority(os.PRIO_PROCESS, threading.get_native_id(), 19)
            except (OSError, AttributeError):
                pass
            try:
                result[0] = self._compact_inner(reclaim)
            except BaseException as e:  # noqa: BLE001 - relayed to the caller
                error[0] = e

        t = threading.Thread(target=_run, name="compact-build")
        t.start()
        t.join()
        if error[0] is not None:
            raise error[0]
        return result[0]

    def _compact_inner(self, reclaim: bool) -> int:
        with self._compact_lock:
            t0 = time.monotonic()
            snap = self._compact_snapshot(reclaim)
            stats = {"snapshot_s": time.monotonic() - t0}
            if snap is None:
                return 0
            built = self._compact_build(snap, reclaim)
            stats["build_s"] = time.monotonic() - t0 - stats["snapshot_s"]
            if built is None:
                # nothing to fold and nothing to reclaim: drop the
                # (all-dead, no-new-ids) snapshotted delta prefix
                with self._live_lock:
                    self._compact_trim_delta(snap)
                    self._meta_update_log = None
                return 0
            stats.update(built["stats"])
            t_w = time.monotonic()
            self._compact_warm(built)
            stats["warm_s"] = time.monotonic() - t_w
            hook = getattr(self, "_compact_pre_swap_hook", None)
            if hook is not None:
                hook()   # test seam: mutations that land mid-build
            with self._live_lock:
                t_sw = time.monotonic()
                out = self._compact_swap(snap, built, reclaim)
                stats["swap_s"] = time.monotonic() - t_sw
                stats["total_s"] = time.monotonic() - t0
                self.last_compact_stats = stats
            from ..utils.gc_tuning import refreeze_if_frozen

            refreeze_if_frozen()
            return out

    def _compact_snapshot(self, reclaim: bool) -> dict | None:
        """Phase 1: copies of the delta prefix and the tombstones (brief
        lock). Rows appended after `wm` stay in the delta."""
        with self._live_lock:
            delta = self._delta
            wm = delta.n if delta is not None else 0
            tomb = self._tombstone
            want_reclaim = reclaim and tomb is not None and bool(tomb.any())
            if wm == 0 and not want_reclaim:
                return None
            if reclaim and self.meta is not None:
                self._meta_update_log = []
            return {
                "wm": wm,
                "meta_wm": len(self._delta_meta_rows),
                "meta_len": len(self.meta) if self.meta is not None else 0,
                "ids": delta.ids[:wm].copy() if wm else np.zeros(0, np.int64),
                "live": delta.live[:wm].copy() if wm else np.zeros(0, bool),
                "vecs": delta.vecs[:wm].copy() if wm else np.zeros((0, self.dim), np.float32),
                "tomb": tomb.copy() if tomb is not None else None,
            }

    def _compact_trim_delta(self, snap: dict) -> None:
        """Drop the snapshotted (all-dead) delta prefix, keeping rows
        appended during the build. Caller holds _live_lock."""
        cur = self._delta
        if cur is None:
            return
        wm = snap["wm"]
        if cur.n <= wm:
            self._delta = None
            self._delta_meta_rows = []
        else:
            self._delta = self._rebuild_delta(cur.vecs[wm : cur.n], cur.ids[wm : cur.n],
                                              cur.live[wm : cur.n])
            self._delta_meta_rows = list(self._delta_meta_rows[snap["meta_wm"] :])
        self._delta_bias_cache.clear()

    def _rebuild_delta(self, vecs, ids, live):
        """A fresh DeltaBuffer holding these rows in order (dead rows kept
        as tombstones, so _delta_meta_rows positions stay aligned)."""
        d2 = self._new_delta()
        if ids.shape[0]:
            d2.add(np.asarray(vecs, np.float32), np.asarray(ids, np.int64))
            dead = np.nonzero(~np.asarray(live, bool))[0]
            if dead.size:
                d2.kill_rows(dead.tolist())
            # kill_rows pops by id, which aliases when a dead row shares
            # its id with a later live row (a mid-build re-update)
            d2.rebuild_row_of()
        return d2

    def _quantize_like_index(self, x: np.ndarray):
        """(codes, per-row scales | None) tensors of f32 rows in the
        index's own scheme: global-scale int8 with the index's scale
        (an f32 divide, round half to even, as a fresh build), per-row
        int8, or a float cast."""
        idx, cfg = self.index, self.index.config
        xt = torch.from_numpy(np.ascontiguousarray(x, np.float32))
        if cfg.dtype != "int8":
            return xt.to(idx.vectors.dtype), None
        if cfg.int8_scale == "global":
            g = torch.tensor(np.float32(idx.global_scale))
            return (torch.clamp(torch.round(xt / g), -127, 127).to(torch.int8),
                    torch.full((x.shape[0],), np.float32(idx.global_scale)))
        from ..index.quant import quantize_int8

        return quantize_int8(xt)

    def _compact_build(self, snap: dict, reclaim: bool) -> dict | None:
        """Phase 2 (no lock): fold the snapshot into a new FlatIndex and a
        new engine around it, its device arrays folded on the device from
        the old ones, and fold the IVF route forward. Reads only state
        that stays fixed until the swap this build performs."""
        t_b = time.monotonic()
        live = snap["live"]
        fold_rows = np.nonzero(live)[0]
        ids_all = snap["ids"][fold_rows]
        emb_all = snap["vecs"][fold_rows]
        # docs whose id has a main row (live upserts) are written back in
        # place and un-tombstoned: appending them would duplicate the id
        upd_rows, upd_j, app_j = [], [], []
        for j, d in enumerate(ids_all):
            r = self._doc_row(int(d))
            if r is not None:
                upd_rows.append(r)
                upd_j.append(j)
            else:
                app_j.append(j)
        m_total = int(ids_all.shape[0])
        idx, cfg = self.index, self.index.config
        old_n = self.n_valid
        # new ids were minted sequentially but deletes may have punched
        # gaps: fold the DENSE id range over every snapshotted id (dead
        # ones too), with tombstoned zero rows in the gaps, so row-order
        # corpora keep ids == row
        new_all = np.array([int(d) for d in np.unique(snap["ids"]) if self._doc_row(int(d)) is None],
                           np.int64)
        tomb0 = snap["tomb"]
        want_reclaim = reclaim and tomb0 is not None and bool(tomb0.any())
        if not upd_rows and not app_j and new_all.size == 0 and not want_reclaim:
            # every snapshotted row updated a main row later deleted, and
            # no new id was minted: nothing to fold
            return None
        if reclaim and not self._main_ids_arange:
            raise ValueError("compact(reclaim=True) requires row-order doc ids (ids == arange)")
        app_ids = ids_all[app_j].astype(np.int64)
        base = int(new_all.min()) if new_all.size else old_n
        hi = int(new_all.max()) + 1 if new_all.size else base
        m = hi - base
        emb = np.zeros((m, self.dim), np.float32)
        emb[app_ids - base] = emb_all[app_j]
        gap = np.ones(m, bool)
        gap[app_ids - base] = False
        new_ids = np.arange(base, hi, dtype=np.int64)

        codes_new, sc_new = self._quantize_like_index(emb)
        vecs_cat = torch.cat([idx.vectors[:old_n].cpu(), codes_new])
        ids_cat = torch.cat([torch.as_tensor(_np(idx.ids)[:old_n]), torch.from_numpy(new_ids)])
        sc_cat = (torch.cat([idx.scales[:old_n].cpu(), sc_new])
                  if idx.scales is not None else None)
        res_cat = rc_new = rc_u = None
        if self.rescore_residual is not None:
            from ..index.quant import quantize_residual_int8

            rc_new, rs_new = quantize_residual_int8(torch.from_numpy(emb), codes_new,
                                                    idx.global_scale)
            rc, rs = self.rescore_residual
            res_cat = (torch.cat([rc[:old_n].cpu(), rc_new]), torch.cat([rs[:old_n].cpu(), rs_new]))
        rescore_vec = None
        if self.rescore_vectors is not None:
            rv = self.rescore_vectors
            rescore_vec = torch.cat([rv, torch.from_numpy(emb).to(rv.dtype)])
        # build-time tombstones (snapshot + fold): the reclaim drop set.
        # Docs dead at the snapshot cannot come back mid-build (an update
        # needs a live doc; an add mints a fresh id)
        tomb_build = np.concatenate([tomb0 if tomb0 is not None else np.zeros(old_n, bool), gap])
        emb_u = codes_u = None
        if upd_rows:
            emb_u = emb_all[upd_j]
            codes_u, sc_u = self._quantize_like_index(emb_u)
            vecs_cat[upd_rows] = codes_u
            if sc_cat is not None and sc_u is not None:
                sc_cat[upd_rows] = sc_u
            if res_cat is not None:
                from ..index.quant import quantize_residual_int8

                rc_u, rs_u = quantize_residual_int8(torch.from_numpy(emb_u), codes_u,
                                                    idx.global_scale)
                res_cat[0][upd_rows] = rc_u
                res_cat[1][upd_rows] = rs_u
            if rescore_vec is not None:
                rescore_vec[upd_rows] = torch.from_numpy(emb_u).to(rescore_vec.dtype)
            tomb_build[upd_rows] = False   # the id is live again, in place

        # ---- the IVF route survives: fold rows into the existing lists ----
        t_ivf = time.monotonic()
        ivf2 = self.ivf
        if ivf2 is not None and m_total:
            # updated docs may have moved: kill their old slab entries
            ivf2 = ivf2.with_updates(add_emb=emb_all, add_ids=ids_all,
                                     remove_ids=ids_all[upd_j] if upd_j else None)

        # ---- reclaim: drop tombstoned rows, renumber ids dense ----
        id_map = None
        n_dropped = 0
        keep_dev = None
        meta_built = self.meta
        if reclaim:
            keep = ~tomb_build
            n_keep = int(keep.sum())
            id_map = np.full(old_n + m, -1, np.int64)
            id_map[keep] = np.arange(n_keep, dtype=np.int64)
            n_dropped = old_n + m - n_keep
            keep_t = torch.from_numpy(keep)
            vecs_cat = vecs_cat[keep_t]
            ids_cat = torch.arange(n_keep, dtype=torch.int64)
            if sc_cat is not None:
                sc_cat = sc_cat[keep_t]
            if res_cat is not None:
                res_cat = (res_cat[0][keep_t], res_cat[1][keep_t])
            if rescore_vec is not None:
                rescore_vec = rescore_vec[keep_t]
            if self.meta is not None:
                meta_built = self._meta_subset(self.meta, keep)
            if ivf2 is not None:
                ivf2 = ivf2.remap_ids(id_map)
            if self._shards is None:
                keep_dev = upload(np.nonzero(keep)[0], self.device)
        ivf_s = time.monotonic() - t_ivf

        # ---- the device fold: the new device arrays from the old device
        # copies plus delta-sized uploads (reclaim gathers the kept rows
        # on the device). Under a mesh the new engine re-shards the folded
        # host arrays instead, as the reference's does ----
        t_f = time.monotonic()
        n_fold, n_rows = old_n + m, int(vecs_cat.shape[0])
        upd = upd_rows or None
        folds = {"vectors": (self.vectors, _round_up(n_rows, self.row_block), codes_new, codes_u),
                 "rescore": (self._rescore_device, n_rows, emb, emb_u),
                 "res_codes": (self._res_codes_device, n_rows, rc_new, rc_u)}
        device_init, bytes_h2d = {}, 0
        for key, (old_dev, target, new_rows, upd_vals) in folds.items():
            if self._shards is not None:
                break
            if old_dev is not None:
                device_init[key] = _fold_device_rows(old_dev, n_fold, target, new_rows, old_n,
                                                     upd, upd_vals, keep_dev)
                bytes_h2d += sum(int(np.prod(a.shape)) * old_dev.element_size()
                                 for a in (new_rows, upd_vals) if a is not None)
        fold_s = time.monotonic() - t_f

        new_index = FlatIndex(vectors=vecs_cat, ids=ids_cat, scales=sc_cat, num_rows=n_rows,
                              config=cfg, global_scale=idx.global_scale,
                              rescore_residual=res_cat)
        ctor = dict(self._ctor)
        ctor["meta"] = meta_built
        t_e = time.monotonic()
        eng2 = SearchEngine(
            new_index, rescore_vectors=rescore_vec, rescore_residual=res_cat, ivf_index=ivf2,
            ivf_nprobe=self.ivf_nprobe if ivf2 is not None else None, device_init=device_init,
            **ctor)
        return {
            "eng": eng2, "old_n": old_n, "m": m, "m_total": m_total, "gap": gap,
            "id_map": id_map, "n_dropped": n_dropped,
            # delta row -> row in the folded (pre-reclaim) index, for the
            # swap's reconcile of mid-build deletes and updates
            "upd_pairs": [(int(fold_rows[j]), int(r)) for j, r in zip(upd_j, upd_rows)],
            "app_pairs": [(int(fold_rows[j]), old_n + int(ids_all[j]) - base) for j in app_j],
            "stats": {"host_build_s": t_ivf - t_b, "ivf_and_reclaim_s": ivf_s, "device_fold_s": fold_s,
                      "engine_s": time.monotonic() - t_e, "bytes_h2d": int(bytes_h2d)},
        }

    @staticmethod
    def _meta_subset(meta: CorpusMetadata, keep: np.ndarray) -> CorpusMetadata:
        """Columnar row filter of the metadata (the reclaim permutation)."""
        from .metadata import _LIST_COLUMNS, _NUM_COLUMNS

        n = keep.shape[0]
        flags = keep.tolist()
        kw = {name: list(itertools.compress(getattr(meta, name), flags)) for name in _LIST_COLUMNS}
        for name in _NUM_COLUMNS:
            kw[name] = np.asarray(getattr(meta, name))[:n][keep]
        return CorpusMetadata(**kw)

    def _compact_warm(self, built: dict) -> None:
        """Phase 2b (no lock): what the first query after the swap would
        otherwise build under the lock: the new engine's IVF searcher for
        every k this engine serves, and its grouped pass/fail rows (the
        reference compiles its scan programs here; the port has none)."""
        eng2: SearchEngine = built["eng"]
        if eng2.ivf is not None:
            for kq in list(self._ivf_fns.keys()) or [self.config.top_k]:
                eng2._ivf_fn(kq)
        if self._pass_fail_cache is not None and eng2.supports_grouped_filters:
            eng2._pass_fail_rows()

    def _compact_swap(self, snap: dict, built: dict, reclaim: bool) -> int:
        """Phase 3 (caller holds _live_lock): install the new engine state
        and reconcile everything since the snapshot."""
        eng2: SearchEngine = built["eng"]
        cur = self._delta
        wm = snap["wm"]
        old_meta = self.meta
        cur_next_id = self._next_doc_id

        # the remaining delta: rows appended during the build
        if cur is not None and cur.n > wm:
            r_vecs = cur.vecs[wm : cur.n].copy()
            r_ids = cur.ids[wm : cur.n].copy()
            r_live = cur.live[wm : cur.n].copy()
        else:
            r_vecs = np.zeros((0, self.dim), np.float32)
            r_ids = np.zeros(0, np.int64)
            r_live = np.zeros(0, bool)
        rem_meta = list(self._delta_meta_rows[snap["meta_wm"] :])

        # tombstones over the folded (pre-reclaim) rows from the PRESENT
        # state (mid-build deletes of main rows included); a folded doc
        # deleted or updated again mid-build tombstones its new row (a
        # live newer delta row shadows it)
        t = np.zeros(built["old_n"] + built["m"], bool)
        if self._tombstone is not None:
            t[: built["old_n"]] = self._tombstone
        t[built["old_n"] :][built["gap"]] = True
        for dj, row in built["upd_pairs"] + built["app_pairs"]:
            t[row] = not bool(cur.live[dj])

        id_map = built["id_map"]
        if reclaim and id_map is not None:
            keep = id_map >= 0
            final_tomb = t[keep]
            nd = built["n_dropped"]
            if r_ids.size:
                # the remaining delta's ids renumber too; ids beyond the
                # map (docs added mid-build) shift down by the drop count
                within = r_ids < len(id_map)
                r_ids = np.where(within, id_map[np.clip(r_ids, 0, len(id_map) - 1)], r_ids - nd)
            if old_meta is not None:
                # metadata rows added mid-build join the compacted copy,
                # and in-place column updates made while the copy aged
                # replay onto it, renumbered (replays it saw are no-ops)
                extra = [old_meta.row_as_dict(i) for i in range(snap["meta_len"], len(old_meta))]
                if extra:
                    eng2.meta.extend(extra)
                for did, cols in self._meta_update_log or ():
                    nid = int(id_map[did]) if did < len(id_map) else did - nd
                    if 0 <= nid < len(eng2.meta):
                        eng2.meta.update_row(nid, cols)
        else:
            final_tomb = t

        # ---- transplant: eng2's state becomes ours. Never clear __dict__:
        # finalize() closures and stats readers run lock-free and must
        # find every attribute. The locks (other threads wait on them now)
        # stay, and so do the generation and remap fields, so a lock-free
        # _translate_ids never sees a rolled-back generation ----
        gen = self._generation
        chain = self._remap_chain
        # monotonic counters survive (the scheduler reads deltas of them)
        fm_builds = self.filter_mask_builds + eng2.filter_mask_builds
        fm_build_s = self.filter_mask_build_s + eng2.filter_mask_build_s
        routes = dict(self.route_counts)
        for r, c in eng2.route_counts.items():
            routes[r] = routes.get(r, 0) + c
        d = dict(eng2.__dict__)
        for key in ("_live_lock", "_filter_cache_lock", "_compact_lock", "_generation",
                    "_remap_chain", "last_id_map", "filter_mask_builds",
                    "filter_mask_build_s", "route_counts", "last_compact_stats"):
            d.pop(key, None)
        if reclaim and id_map is not None:
            # publish order for lock-free finalize() readers: chain, then
            # generation, then state. A reader that sees the new
            # generation sees the new map; one that still sees the old
            # generation ran its scan before the swap, on old ids
            self._remap_chain = (chain + [(gen + 1, id_map, built["n_dropped"])])[-8:]
            self._generation = gen + 1
        self.__dict__.update(d)
        self.filter_mask_builds = fm_builds
        self.filter_mask_build_s = fm_build_s
        self.route_counts = routes
        if reclaim and id_map is not None:
            self.last_id_map = id_map
            self._next_doc_id = cur_next_id - built["n_dropped"]
        else:
            self._next_doc_id = max(cur_next_id, self._next_doc_id)
        if final_tomb.any():
            self._tombstone = final_tomb
            self._tomb_epoch = 1
        if r_ids.size:
            # the rows appended mid-build go to the device under the lock:
            # bounded by the mid-build mutations, not the corpus
            self._delta = self._rebuild_delta(r_vecs, r_ids, r_live)
            self._delta_meta_rows = rem_meta
        return built["m_total"]

    # ------------------------------------------------------------------
    # filters
    # ------------------------------------------------------------------

    def _require_arange_for_filters(self) -> None:
        """Filtered search applies the mask per ROW and looks ids up as
        rows; on a custom-id corpus those lookups would be wrong."""
        if not self._main_ids_arange:
            raise ValueError(
                "filtered search requires row-order doc ids "
                "(ids == arange); rebuild the corpus id-ordered"
            )

    def _mask_device_entry(self, mask: np.ndarray) -> tuple:
        """(np mask, device int8 mask | f32 bias, pass rate) for the
        active route. The pass rate is computed once here: the broad-
        filter routing must not rescan an O(N) mask per batch."""
        pass_rate = float(np.mean(mask)) if mask.size else 0.0
        if self._speed_ok:
            mask_host = np.zeros(self.padded_rows, np.int8)
            mask_host[: mask.shape[0]] = mask
            return mask, self._put_rows(mask_host), pass_rate
        bias_host = np.full(self.padded_rows, NEG_INF, np.float32)
        bias_host[: mask.shape[0]] = np.where(mask, 0.0, NEG_INF)
        return mask, self._put_rows(bias_host), pass_rate

    def _cache_put(self, cache: dict, key, entry, t0: float) -> None:
        with self._filter_cache_lock:
            self.filter_mask_builds += 1
            self.filter_mask_build_s += time.monotonic() - t0
            if len(cache) >= _FILTER_CACHE_MAX:
                cache.pop(next(iter(cache)))
            cache[key] = entry

    def _filter_device_inputs(self, filters: SearchFilters):
        """Compiled + device-placed filter inputs, cached per signature
        (the O(N) host compile runs once per signature, not per batch)."""
        key = filter_key(filters)
        if key == ():
            return None, None, 0.0
        with self._filter_cache_lock:
            hit = self._filter_cache.get(key)
        if hit is not None:
            return hit
        t0 = time.monotonic()
        if self.meta is None:
            raise ValueError("filters require CorpusMetadata")
        self._require_arange_for_filters()
        with self._live_lock:
            # live adds extend the metadata column by column
            mask = compile_filter_mask(filters, self.meta)
        if mask is not None:
            # the metadata can outgrow the index (delta docs, which get
            # their own bias): main rows are doc ids [0, n_valid)
            mask = mask[: self.n_valid]
        entry = (None, None, 0.0) if mask is None else self._mask_device_entry(mask)
        self._cache_put(self._filter_cache, key, entry, t0)
        return entry

    def _combined_mask_inputs(self, filters: SearchFilters | None):
        """The user filter's mask AND the delete tombstones, device-cached
        per (signature, tombstone epoch): (np bool mask | None, device
        mask/bias | None, pass rate) over the main rows."""
        if self._tombstone is None:
            if filters is None:
                return None, None, 0.0
            return self._filter_device_inputs(filters)
        fkey = filter_key(filters) if filters is not None else ()
        key = (fkey, self._tomb_epoch)
        with self._filter_cache_lock:
            hit = self._tomb_mask_cache.get(key)
        if hit is not None:
            return hit
        t0 = time.monotonic()
        user = None
        if fkey != ():
            if self.meta is None:
                raise ValueError("filters require CorpusMetadata")
            self._require_arange_for_filters()
            with self._live_lock:
                user = compile_filter_mask(filters, self.meta)
        alive = ~self._tombstone
        mask = alive if user is None else user[: self.n_valid] & alive
        entry = self._mask_device_entry(mask)
        self._cache_put(self._tomb_mask_cache, key, entry, t0)
        return entry

    @property
    def supports_grouped_filters(self) -> bool:
        """True when a heterogeneous filtered batch runs as ONE scan with
        a mask row per query (the grouped maxima scan of the speed path).
        The exact route dispatches per signature, as the reference's
        per-row-scale kernel path does."""
        return self._speed_ok

    def _pass_fail_rows(self):
        """Cached (all-pass, all-excluded) int8 device rows of the grouped
        scan's mask stack."""
        if self._pass_fail_cache is None:
            ones = np.zeros(self.padded_rows, np.int8)
            ones[: self.n_valid] = 1
            self._pass_fail_cache = (self._put_rows(ones),
                                     self._put_rows(np.zeros(self.padded_rows, np.int8)))
        return self._pass_fail_cache

    def _grouped_device_masks(self, ordered_keys, reps) -> torch.Tensor:
        """(G_pad, padded_rows) int8 device stack, row g = signature g's
        mask with the tombstones, pad rows all excluded (under a mesh, one
        (G_pad, rows_per_shard) stack a shard). Stacked on the device per
        dispatch from the per-signature cached rows: a set-level cache
        would miss nearly always under a rotating mix while pinning dead
        stacks."""
        g_pad = max(8, pow2_bucket(len(ordered_keys)))
        pass_row, fail_row = self._pass_fail_rows()
        rows = []
        for fk, f in zip(ordered_keys, reps):
            if fk == () and self._tombstone is None:
                rows.append(pass_row)
                continue
            mask, dev, _ = self._combined_mask_inputs(f if fk != () else None)
            rows.append(pass_row if mask is None else dev)
        rows.extend([fail_row] * (g_pad - len(rows)))
        if self._shards is not None:
            return [torch.stack([r[j] for r in rows]) for j in range(len(self._shards))]
        return torch.stack(rows)

    def _tomb_ids_snapshot(self) -> np.ndarray:
        """Doc ids whose MAIN row is tombstoned (sorted int64, cached per
        delete epoch): the over-fetch route drops them on the host. An id
        re-added by update_document stays listed: its stale main row must
        drop while its delta row survives."""
        snap = self._tomb_ids_cache
        if snap is not None and snap[0] == self._tomb_epoch:
            return snap[1]
        with self._live_lock:
            tomb = self._tombstone
            epoch = self._tomb_epoch
            ids = (np.sort(self._host_ids[: self.n_valid][tomb].astype(np.int64))
                   if tomb is not None else np.zeros(0, np.int64))
        self._tomb_ids_cache = (epoch, ids)
        return ids

    def _delta_filter_mask_np(self, filters: SearchFilters | None, delta):
        """Host bool mask over delta rows [0, delta.n) for the user's
        filters, or None when no filter applies (compiled over the small
        delta metadata view only)."""
        if filters is None or self.meta is None or filter_key(filters) == ():
            return None
        view = CorpusMetadata.from_rows(self._delta_meta_rows[: delta.n])
        return compile_filter_mask(filters, view)

    def _delta_filter_bias(self, filters: SearchFilters | None, delta):
        """Per-delta-row f32 device bias (0 pass / -inf fail), or None
        when no filter applies."""
        if filters is None or self.meta is None:
            return None
        fkey = filter_key(filters)
        if fkey == ():
            return None
        key = (fkey, delta.n)
        with self._filter_cache_lock:
            hit = self._delta_bias_cache.get(key)
        if hit is not None:
            return hit[0]
        mask = self._delta_filter_mask_np(filters, delta)
        bias = None
        if mask is not None:
            bias_host = np.full(delta.cap, NEG_INF, np.float32)
            bias_host[: delta.n] = np.where(mask, 0.0, NEG_INF)
            bias = upload(bias_host, self.device)
        with self._filter_cache_lock:
            if len(self._delta_bias_cache) >= _FILTER_CACHE_MAX:
                self._delta_bias_cache.pop(next(iter(self._delta_bias_cache)))
            self._delta_bias_cache[key] = (bias,)
        return bias

    def _delta_bias_stack(self, ordered_keys, reps, delta):
        """(G_pad, cap) f32 device stack of per-signature delta biases for
        a grouped dispatch (pad rows all -inf), or None when no signature
        filters the delta."""
        if self.meta is None or all(fk == () for fk in ordered_keys):
            return None
        g_pad = max(8, pow2_bucket(len(ordered_keys)))
        zeros_row = None
        rows = []
        for fk, f in zip(ordered_keys, reps):
            bias = self._delta_filter_bias(f, delta) if fk != () else None
            if bias is None:
                # every delta row passes; dead rows already carry -inf in
                # the base bias this stack adds to
                if zeros_row is None:
                    zeros_row = torch.zeros(delta.cap, dtype=torch.float32, device=self.device)
                rows.append(zeros_row)
            else:
                rows.append(bias)
        fail_row = torch.full((delta.cap,), NEG_INF, dtype=torch.float32, device=self.device)
        rows.extend([fail_row] * (g_pad - len(rows)))
        return torch.stack(rows)

    def warm_overfetch(self, batch_sizes=(1,), k: int | None = None) -> None:
        """The reference compiles its over-fetch and IVF programs here; the
        port has nothing to compile, so this loads the kernels' library and
        runs the IVF route once per batch size it serves (first-use set-up
        stays out of a served request)."""
        with self._live_lock:
            if self.device.type == "cuda":
                _load_kernels()
            if self.ivf is not None:
                for b in batch_sizes:
                    if b <= self.ivf_max_batch:
                        q, _ = self._pad_queries(np.zeros((b, self.dim), np.float32))
                        self._ivf_fn(k or self.config.top_k)(q)

    def warm_grouped(self, batch_sizes=(8,), g_pads=(8, 16, 32), k: int | None = None) -> None:
        """The reference compiles its grouped programs here; the port
        builds the pass/fail rows and loads the kernels' library."""
        with self._live_lock:
            if not self.supports_grouped_filters:
                return
            self._pass_fail_rows()
            if self.device.type == "cuda":
                _load_kernels()

    def _overfetch_margin(self, k: int, drop_p: float) -> int:
        """Smallest `_OVERFETCH_MARGINS` entry m such that a (k+m) window
        holds more than m dropped docs only at ~6-sigma odds (binomial
        with per-doc drop probability `drop_p`); the largest entry when
        none qualifies."""
        for m in _OVERFETCH_MARGINS[:-1]:
            w = k + m
            mean = w * drop_p
            sigma = math.sqrt(max(w * drop_p * (1.0 - drop_p), 0.0))
            if mean + 6.0 * sigma <= m:
                return m
        return _OVERFETCH_MARGINS[-1]

    def _candidate_width(self, k_q: int, base_k: int) -> int:
        """Rescore-candidate width for a window `k_q` whose final k is
        `base_k`: the window plus the plain path's absolute oversampling
        tail, (rescore_factor - 1) * base_k."""
        return k_q + (self.rescore_factor - 1) * base_k

    # ------------------------------------------------------------------
    # device routes
    # ------------------------------------------------------------------

    def _count_route(self, route: str) -> None:
        with self._filter_cache_lock:
            self.route_counts[route] = self.route_counts.get(route, 0) + 1

    @staticmethod
    def _to_doc_ids(li: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
        return torch.where(li >= 0, ids[li.clamp(min=0).long()], PAD_ID)

    def _over_shards(self, q, k: int, width: int, run, *sharded):
        """Run `run(shard, q_s, *args_s) -> (scores, doc ids) (B, width)` on
        every shard this process holds, with q and each per-shard argument
        (a list of one tensor a local shard, or one tensor copied to every
        shard) on the shard's device; bring the lists to the first device
        (over the mesh's row group when the row spans processes:
        `core/meshes.py:gather_shard_lists`), in global shard order, and
        merge them (`merge_topk`: ties to the lower shard, then the lower
        slot, as the reference's all_gather + lax.top_k). A shard without
        valid rows contributes nothing, as its -inf slots would; which
        shards those are is replicated state, so every process joins the
        gather whatever its own shards hold."""
        lists = []
        for j, sh in enumerate(self._shards):
            if sh["valid"] == 0:
                lists.append(None)
                continue
            dev = sh["device"]
            args = [a[j] if isinstance(a, list)
                    else None if a is None else a.to(dev, non_blocking=True) for a in sharded]
            out_s, out_i = run(sh, q.to(dev, non_blocking=True), *args)
            lists.append((out_s.to(self.device, non_blocking=True),
                          out_i.to(self.device, non_blocking=True)))
        b = q.shape[0]
        lists = gather_shard_lists(self.mesh, lists, b, width, self.device)
        rps = self.rows_per_shard
        parts = [e for s, e in enumerate(lists) if self.n_valid > s * rps]
        if not parts:
            return (torch.full((b, k), NEG_INF, device=self.device),
                    torch.full((b, k), PAD_ID, dtype=torch.int32, device=self.device))
        all_s = torch.cat([e[0] for e in parts], dim=1)
        all_i = torch.cat([e[1] for e in parts], dim=1)
        if all_s.shape[1] < k:
            pad = k - all_s.shape[1]
            all_s = torch.nn.functional.pad(all_s, (0, pad), value=NEG_INF)
            all_i = torch.nn.functional.pad(all_i, (0, pad), value=PAD_ID)
        return merge_topk(all_s, torch.where(all_i < 0, PAD_ID, all_i), k)

    def _sharded_speed_search(self, q, k: int, mask=None, gmasks=None, mask_ids=None):
        """The speed route once a shard: scan, local rescore to k, doc ids;
        merged. Candidates a shard: the reference's sharded width,
        min(max(k, rescore_factor * k), rows_per_shard)."""
        kr = min(max(k, self.rescore_factor * k), self.rows_per_shard)
        k_loc = min(k, kr)
        gs = self._global_scale

        def run(sh, qs, m, gm, mid):
            with span("ts.engine.scan"):
                _, li = fused_mips_topk_g(qs, sh["vectors"], gs, sh["valid"], m, k=kr,
                                          row_block=self.row_block, gmasks=gm, mask_ids=mid)
            with span("ts.engine.rescore"):
                if sh["res_codes"] is not None:
                    s_, li = device_rescore_residual(qs, li, sh["vectors"], gs, sh["res_codes"],
                                                     sh["res_scales"], sh["valid"], k=k_loc)
                else:
                    s_, li = device_rescore(qs, li, sh["rescore"], sh["valid"], k=k_loc)
                return s_, self._to_doc_ids(li, sh["ids"])

        return self._over_shards(q, k, k_loc, run, mask, gmasks, mask_ids)

    def _speed_search(self, q, k_q: int, base_k: int, mask=None, gmasks=None, mask_ids=None):
        """The speed route: (B_pad, D) f32 device queries -> (scores, doc
        ids) (B_pad, k_q), rescored on the device. Retrieves the window
        plus the oversampling tail from the quasi-exact int32 scan (masked
        or grouped when given masks), rescores exactly against the bf16
        copy or the residual reconstruction and maps rows -> doc ids."""
        if self._shards is not None:
            return self._sharded_speed_search(q, k_q, mask, gmasks, mask_ids)
        kr = min(self._candidate_width(k_q, base_k), self.padded_rows)
        with span("ts.engine.scan"):
            _, li = fused_mips_topk_g(q, self.vectors, self._global_scale, self.n_valid, mask,
                                      k=kr, row_block=self.row_block, gmasks=gmasks,
                                      mask_ids=mask_ids)
        with span("ts.engine.rescore"):
            if self._res_codes_device is not None:
                s, li = device_rescore_residual(q, li, self.vectors, self._global_scale,
                                                self._res_codes_device, self._res_scales_device,
                                                self.n_valid, k=k_q)
            else:
                s, li = device_rescore(q, li, self._rescore_device, self.n_valid, k=k_q)
            return s, self._to_doc_ids(li, self.ids)

    def _ivf_fn(self, k: int):
        """The IVF route's searcher for k, built once per k (the list-
        sharded searcher under a mesh)."""
        if k not in self._ivf_fns:
            if self.mesh is not None:
                self._ivf_fns[k] = self.ivf.sharded_searcher(
                    self.mesh, k=k, nprobe=self.ivf_nprobe, rescore_factor=self.rescore_factor)
            else:
                self._ivf_fns[k] = self.ivf.device_searcher(
                    k=k, nprobe=self.ivf_nprobe, rescore_factor=self.rescore_factor)
        return self._ivf_fns[k]

    def _exact_search(self, q, k_dev: int, bias=None):
        """The exact route (kernel B5): (scores, doc ids) (B_pad, k_dev);
        once a shard under a mesh (the reference's `_local_topk`)."""
        if self._shards is not None:
            def run(sh, qs, b_s):
                with span("ts.engine.scan"):
                    s_, li = fused_mips_topk(qs, sh["vectors"], sh["scales"], sh["valid"], b_s,
                                             k=k_dev, row_block=self.row_block)
                    return s_, self._to_doc_ids(li, sh["ids"])

            return self._over_shards(q, k_dev, k_dev, run, bias)
        with span("ts.engine.scan"):
            s, li = fused_mips_topk(q, self.vectors, self.scales, self.n_valid, bias,
                                    k=k_dev, row_block=self.row_block)
            return s, self._to_doc_ids(li, self.ids)

    def _pad_queries(self, query_vecs) -> tuple[torch.Tensor, int]:
        """(padded device queries, real batch): batches pad to the next
        power of two (min 8), so a serving mix sees few distinct shapes."""
        with span("ts.engine.upload"):
            if isinstance(query_vecs, torch.Tensor):
                q = query_vecs.to(self.device, torch.float32)
            else:
                q = upload(np.asarray(query_vecs, dtype=np.float32), self.device)
            if q.ndim == 1:
                q = q[None, :]
            b = q.shape[0]
            b_pad = pow2_bucket(b)
            if b_pad != b:
                q = torch.cat([q, torch.zeros((b_pad - b, q.shape[1]), dtype=q.dtype,
                                              device=q.device)])
            return q.contiguous(), b

    @staticmethod
    def _to_host(*tensors):
        """Enqueue device -> pinned host copies and an event; returns
        (host tensors, event or None); None entries stay None. The event,
        not the stream, is synchronized later, so later batches keep
        running."""
        with span("ts.engine.to_host"):
            live = [t for t in tensors if t is not None]
            if not live or live[0].device.type != "cuda":
                return tensors, None
            out = []
            for t in tensors:
                if t is None:
                    out.append(None)
                    continue
                h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                h.copy_(t, non_blocking=True)
                out.append(h)
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(live[0].device))
            return tuple(out), done

    @staticmethod
    def _merge_delta(s2, i2, ds_h, di_h, b: int, k: int):
        """The delta's exact f32 top-k merged with the main top-k (stable:
        main entries win ties)."""
        ds2 = ds_h[:b].astype(np.float32)
        di2 = di_h[:b].astype(i2.dtype)
        ds2 = np.where(di2 >= 0, ds2, NEG_INF)
        all_s = np.concatenate([s2.astype(np.float32), ds2], axis=1)
        all_i = np.concatenate([i2, di2], axis=1)
        sel = np.argsort(-all_s, axis=1, kind="stable")[:, :k]
        return np.take_along_axis(all_s, sel, 1), np.take_along_axis(all_i, sel, 1)

    def search_vectors_async(self, query_vecs, k: int | None = None, filters=None,
                             _force_masked: bool = False):
        """Dispatch a batched search without waiting; returns
        ``finalize() -> (scores, ids)``, which waits on this batch's CUDA
        event only and reads the host copies. `filters` is one
        SearchFilters (or None) for the batch, or a list with one per
        query row (a grouped dispatch). The dispatch holds the live-update
        lock, so a mutation or a compact swap cannot change the state
        under it; finalize() runs lock-free on what the dispatch took."""
        with self._live_lock:
            if isinstance(filters, (list, tuple)):
                return self._dispatch_grouped(query_vecs, k, list(filters))
            return self._dispatch_search_async(query_vecs, k, filters, _force_masked)

    def _dispatch_search_async(self, query_vecs, k, filters, _force_masked: bool):
        k = k or self.config.top_k
        do_rescore = self.rescore_vectors is not None or self.rescore_residual is not None
        # the doc-id generation at dispatch: a reclaim before finalize()
        # renumbers, and the remap chain translates this batch's ids
        gen0 = self._generation
        # the host rescore's sources, taken at dispatch: a reclaim swap
        # replaces them with row-permuted arrays, while this batch's
        # candidate ids are old-generation
        rescore_src = self._rescore_src()

        # tombstones, or a BROAD user filter, stay on the fast unfiltered
        # route: fetch k + margin, drop failing ids on the host
        tomb_drop = drop_mask = None
        margin = 0
        k_q = k
        pass_rate = 0.0
        overfetch_ok = not _force_masked and self.n_valid > k
        if (overfetch_ok and self._tombstone is not None
                and (filters is None or filter_key(filters) == ())
                # a heavily deleted corpus goes to the masked scan: the
                # window would keep tripping the exact re-run
                and self._tomb_ids_snapshot().size <= (1.0 - _OVERFETCH_MIN_PASS) * self.n_valid):
            # deletes only: drop against the small tombstoned-id set,
            # with no row mask at all
            tomb_drop = self._tomb_ids_snapshot()
            margin = min(self._overfetch_margin(k, tomb_drop.size / self.n_valid), self.n_valid - k)
            k_q = k + margin
            mask = dev = None
        else:
            mask, dev, pass_rate = self._combined_mask_inputs(filters)
            if overfetch_ok and mask is not None and pass_rate >= _OVERFETCH_MIN_PASS:
                # broad filter: host drop by mask[id] (ids == rows here)
                margin = min(self._overfetch_margin(k, 1.0 - pass_rate), self.n_valid - k)
                drop_mask = mask
                k_q = k + margin
                mask = dev = None
        k_fetch = self._candidate_width(k_q, k) if do_rescore else k_q
        k_dev = min(max(k_fetch, 1), self.rows_per_shard)
        q, b = self._pad_queries(query_vecs)

        delta_run = delta_bias = None
        delta = self._delta
        if delta is not None and delta.n_live > 0:
            delta_run = delta.searcher(min(k, delta.cap))
            delta_bias = self._delta_filter_bias(filters, delta)

        on_device = self._speed_ok
        s = i = None
        if mask is not None and pass_rate == 0.0:
            route = "empty"     # no main row passes; the delta may still
        elif (mask is None and drop_mask is None and self.ivf is not None
              and b <= self.ivf_max_batch):
            route = "ivf"       # rescored on the device; doc ids already
            with span("ts.engine.scan"):
                s, i = self._ivf_fn(k_q)(q)
            on_device = True
        elif mask is None:
            route = ("overfetch" if (drop_mask is not None or tomb_drop is not None)
                     else "speed" if self._speed_ok else "exact")
            s, i = self._speed_search(q, k_q, k) if self._speed_ok else self._exact_search(q, k_dev)
        elif self._speed_ok:
            route = "masked"
            s, i = self._speed_search(q, k, k, mask=dev)
        else:
            route = "exact_masked"
            s, i = self._exact_search(q, k_dev, dev)
        self._count_route(route)
        ds = di = None
        if delta_run is not None:
            ds, di = delta_run(q, delta_bias)
        host_q = q if (s is not None and do_rescore and not on_device) else None
        host, done = self._to_host(s, i, host_q, ds, di)

        def finalize() -> tuple[np.ndarray, np.ndarray]:
            if s is None and ds is None:
                return (np.full((b, k), NEG_INF, np.float32), np.full((b, k), PAD_ID, np.int32))
            if done is not None:
                with span("ts.engine.wait"):
                    done.synchronize()
            with span("ts.engine.finalize"):
                return finish()

        def finish() -> tuple[np.ndarray, np.ndarray]:
            if s is None:
                s2 = np.full((b, k), NEG_INF, np.float32)
                i2 = np.full((b, k), PAD_ID, np.int32)
            else:
                s_h, i_h = host[0].numpy()[:b], host[1].numpy()[:b]
                if host_q is not None:
                    s_h, i_h = self._rescore(host[2].numpy()[:b], s_h, i_h, k_q, src=rescore_src)
                if tomb_drop is not None or drop_mask is not None:
                    idsw = i_h[:, :k_q]
                    if tomb_drop is not None:
                        dead = np.isin(idsw, tomb_drop)
                        guaranteed = tomb_drop.size <= margin
                    else:
                        safe = np.clip(idsw, 0, drop_mask.shape[0] - 1)
                        dead = ~drop_mask[safe] & (idsw >= 0)
                        guaranteed = False
                    if dead.any():
                        if not guaranteed and int(dead.sum(axis=1).max()) > margin:
                            # some query's window holds more dropped docs
                            # than the margin: exactness is no longer
                            # guaranteed, so re-run through the masked route
                            self._count_route("overfetch_rerun")
                            return self.search_vectors_async(query_vecs, k, filters,
                                                             _force_masked=True)()
                        s_w = np.where(dead, NEG_INF, s_h[:, :k_q])
                        sel = np.argsort(-s_w, axis=1, kind="stable")[:, :k]
                        s_h = np.take_along_axis(s_w, sel, 1)
                        i_h = np.take_along_axis(idsw, sel, 1)
                s2, i2 = s_h[:, :k], i_h[:, :k]
            if ds is not None:
                s2, i2 = self._merge_delta(s2, i2, host[3].numpy(), host[4].numpy(), b, k)
            if self._generation != gen0:
                i2 = self._translate_ids(i2, gen0)
            # -inf scores mean "fewer than k docs pass the filter"
            return s2, np.where(np.isfinite(s2), i2, PAD_ID)

        return finalize

    def _dispatch_grouped(self, query_vecs, k: int | None, filters_list: list):
        """One dispatch for a batch whose queries carry DIFFERENT filters
        (one SearchFilters-or-None per query row): per-query mask rows in
        a single scan; more than `max_filter_groups` signatures split and
        stitch by row, and engines without the grouped scan dispatch per
        signature. Rows of the query matrix beyond the list are scanned as
        don't-cares and never returned. Caller holds _live_lock."""
        k = k or self.config.top_k
        qv = query_vecs
        q_rows = qv.shape[0] if getattr(qv, "ndim", 2) == 2 else 1
        n_rows = len(filters_list)
        if n_rows > q_rows:
            raise ValueError(f"filters list has {n_rows} entries for {q_rows} queries")
        keys = [filter_key(f) if f is not None else () for f in filters_list]
        # canonical signature order: arrival order must not change the scan
        rep_of: dict[tuple, Any] = {}
        for f, fk in zip(filters_list, keys):
            rep_of.setdefault(fk, f)
        ordered = sorted(rep_of, key=repr)
        reps = [rep_of[fk] for fk in ordered]
        gid = {fk: i for i, fk in enumerate(ordered)}
        if len(ordered) == 1:
            # homogeneous batch: the single-signature route also unlocks
            # over-fetch
            return self._dispatch_search_async(qv, k, reps[0], False)
        if len(ordered) > self.max_filter_groups or not self.supports_grouped_filters:
            budget = self.max_filter_groups if self.supports_grouped_filters else 1
            parts = []
            for lo in range(0, len(ordered), budget):
                sigs = set(ordered[lo : lo + budget])
                rows = np.array([r for r, fk in enumerate(keys) if fk in sigs], np.int64)
                sub_q = qv[rows] if isinstance(qv, np.ndarray) else qv[upload(rows, qv.device)]
                sub_f = [filters_list[r] for r in rows]
                fin = (self._dispatch_search_async(sub_q, k, sub_f[0], False) if budget == 1
                       else self._dispatch_grouped(sub_q, k, sub_f))
                parts.append((rows, fin))

            def finalize_stitched():
                s_out = np.full((n_rows, k), NEG_INF, np.float32)
                i_out = np.full((n_rows, k), PAD_ID, np.int32)
                for rows, fin in parts:
                    s_p, i_p = fin()
                    s_out[rows] = s_p[: len(rows)]
                    i_out[rows] = i_p[: len(rows)]
                return s_out, i_out

            return finalize_stitched

        gen0 = self._generation
        if self.meta is not None:
            self._require_arange_for_filters()
        gm_dev = self._grouped_device_masks(ordered, reps)
        q, b = self._pad_queries(qv)
        mid = np.zeros(q.shape[0], np.int32)
        mid[:n_rows] = [gid[fk] for fk in keys]
        mid_dev = upload(mid, self.device)
        self._count_route("grouped")
        s, i = self._speed_search(q, k, k, gmasks=gm_dev, mask_ids=mid_dev)
        ds = di = None
        delta = self._delta
        if delta is not None and delta.n_live > 0:
            stack = self._delta_bias_stack(ordered, reps, delta)
            delta_bias = stack[mid_dev.long()] if stack is not None else None
            ds, di = delta.searcher(min(k, delta.cap))(q, delta_bias)
        host, done = self._to_host(s, i, ds, di)

        def finalize() -> tuple[np.ndarray, np.ndarray]:
            if done is not None:
                with span("ts.engine.wait"):
                    done.synchronize()
            with span("ts.engine.finalize"):
                s2, i2 = host[0].numpy()[:n_rows, :k], host[1].numpy()[:n_rows, :k]
                if ds is not None:
                    s2, i2 = self._merge_delta(s2, i2, host[2].numpy(), host[3].numpy(), n_rows, k)
                if self._generation != gen0:
                    i2 = self._translate_ids(i2, gen0)
                return s2, np.where(np.isfinite(s2), i2, PAD_ID)

        return finalize

    def _translate_ids(self, ids: np.ndarray, gen0: int) -> np.ndarray:
        """Translate doc ids retrieved at generation `gen0` through every
        later reclaim's id map (old -> new, -1 = dropped; ids beyond a
        map, docs added after that reclaim's snapshot, shift down by its
        drop count). The chain is append-only, so a lock-free read of it
        is consistent."""
        for g, mp, nd in list(self._remap_chain):
            if g <= gen0:
                continue
            safe = np.clip(ids, 0, len(mp) - 1)
            within = ids < len(mp)
            ids = np.where(ids >= 0, np.where(within, mp[safe], ids - nd), PAD_ID).astype(ids.dtype)
        return ids

    def search_vectors(self, query_vecs, k: int | None = None, filters=None):
        """Batched vector search: (scores (B, k), doc_ids (B, k)); PAD_ID
        (-1) marks slots beyond the number of matching docs."""
        return self.search_vectors_async(query_vecs, k, filters)()

    # ------------------------------------------------------------------
    # host rescore (exact route)
    # ------------------------------------------------------------------

    def _rescore_src(self) -> tuple:
        """The host arrays `_rescore` reads, taken at dispatch: a lock-free
        finalize() holds old-generation candidate ids, and a reclaim swap
        replaces these attributes with row-permuted arrays."""
        return (self.rescore_vectors, self.rescore_residual, self._host_codes,
                self._global_scale, self._rescore_sorted_ids, self._rescore_order)

    def _rescore(self, q: np.ndarray, s: np.ndarray, ids: np.ndarray, k: int,
                 src: tuple | None = None):
        """Exact f32 rescoring of the oversampled candidates on the host:
        gather the original rows (or rebuild them from the two-level
        codes) for each (query, candidate) and re-rank (stable, so ties
        keep the scan's order)."""
        (rescore_vectors, rescore_residual, host_codes, gscale, sorted_ids,
         order) = src if src is not None else self._rescore_src()
        if sorted_ids is not None:
            # doc id -> index row via the sorted-id map (custom ids)
            pos = np.searchsorted(sorted_ids, np.maximum(ids, 0))
            pos = np.clip(pos, 0, order.shape[0] - 1)
            safe = order[pos]
        else:
            n = (rescore_vectors if rescore_vectors is not None else rescore_residual[0]).shape[0]
            safe = np.clip(ids, 0, n - 1)
        rows = torch.from_numpy(safe.astype(np.int64))
        if rescore_vectors is not None:
            cand = rescore_vectors[rows].float().numpy()
        else:
            rc, rs = rescore_residual
            cand = residual_rows(host_codes[rows].cpu(), gscale, rc[rows].cpu(),
                                 rs[rows].cpu()).numpy()
        re_s = np.einsum("bcd,bd->bc", cand, q.astype(np.float32))
        re_s = np.where((ids >= 0) & np.isfinite(s), re_s, -np.inf)
        sel = np.argsort(-re_s, axis=1, kind="stable")[:, :k]
        return np.take_along_axis(re_s, sel, 1), np.take_along_axis(ids, sel, 1)

    # ------------------------------------------------------------------
    # full serving path
    # ------------------------------------------------------------------

    def search_pool_k(self, filters: SearchFilters) -> int:
        """Candidates to retrieve: top_k, or the rerank pool
        max(50, 10*top_k) when citation-weighted."""
        top_k = int(filters.top_k)
        if float(filters.citation_weight) == 0.0:
            return top_k
        return max(self.config.rerank_min_pool, self.config.rerank_pool_multiple * top_k)

    def rank_results(
        self, scores: np.ndarray, ids: np.ndarray, citation_weight: float, top_k: int,
    ) -> list[dict[str, Any]]:
        """Join + (optional) citation-weighted rerank of one query's
        retrieved candidates."""
        rows = self._join(ids, scores)
        if citation_weight == 0.0:
            for r in rows:
                r["score"] = r["similarity"]
            return rows[:top_k]
        for r in rows:
            cit = r["citations"]
            bonus = citation_weight * math.log(cit) if (cit is not None and cit > 0) else 0.0
            r["score"] = r["similarity"] + bonus
        rows.sort(key=lambda r: (-r["score"], -r["similarity"]))
        return rows[:top_k]

    def search(self, query_vec, filters: SearchFilters | None = None) -> list[dict[str, Any]]:
        """Single query -> ranked result dicts with metadata joined."""
        filters = filters or SearchFilters()
        if not filters.sources:
            return []
        scores, ids = self.search_vectors(query_vec, k=self.search_pool_k(filters), filters=filters)
        return self.rank_results(
            scores[0], ids[0], float(filters.citation_weight), int(filters.top_k)
        )

    def _join(self, ids: np.ndarray, scores: np.ndarray) -> list[dict[str, Any]]:
        if self.meta is None:
            return [
                {"doc_id": int(d), "similarity": float(s), "score": float(s)}
                for d, s in zip(ids, scores)
                if d >= 0
            ]
        out = []
        m = self.meta
        for d, s in zip(ids, scores):
            if d < 0:
                continue
            d = int(d)
            link = m.link[d] or ""
            cit = int(m.citations[d])
            out.append(
                {
                    "doc_id": d,
                    "paper_id": m.paper_id[d],
                    "authors": m.authors[d],
                    "paper_title": m.paper_title[d],
                    "paper_url": link,
                    "year": int(m.year[d]) or None,
                    "primary_category": m.primary_category[d],
                    "source": "arXiv" if "arxiv.org" in link.lower() else "Stacks Project",
                    "type": infer_type(m.theorem_name[d]),
                    "journal_published": bool(m.journal_ref[d]),
                    "citations": cit if cit >= 0 else None,
                    "theorem_name": m.theorem_name[d],
                    "theorem_slogan": m.slogan[d],
                    "theorem_body": m.theorem_body[d],
                    "similarity": float(s),
                    "score": float(s),
                }
            )
        return out
