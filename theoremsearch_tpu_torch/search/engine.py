"""The query engine on one device (port of
theoremsearch_tpu/search/engine.py, single-device routes).

Two routes, chosen from the index at construction:

- the speed path (a global-scale int8 index with a bf16 rescore copy and
  row-order doc ids): packed lane-maxima scan (`kernels/mips.py:
  fused_mips_topk_g`, CUDA kernel B1 on the card) -> exact rescore of the
  oversampled candidates against the bf16 copy on the device. Filters
  stream through the same scan as a row mask, or one mask row per query
  for a heterogeneous batch (the grouped form);
- the exact route (any other index: per-row-scale int8, bf16, f32, a
  global-scale index without a rescore copy, custom doc ids): fused scores
  + exact top-k (`kernels/mips.py:fused_mips_topk`, CUDA kernel B5), with
  filters as a 0 / -inf row bias and an optional host rescore against the
  rescore copy.

With an IVF index (`ivf_index=`), unfiltered batches of at most
`ivf_max_batch` real queries take the IVF route instead: the probe-major
search (`index/ivf.py:IVFIndex.device_searcher`, kernel B6 on the card),
rescored on the device. Filtered batches never probe.

Broad filters (at least half the rows pass) stay on the unfiltered flat
route, fetch k + margin and drop failing ids on the host, re-running the
batch through the masked route when a query's window holds more failures
than the margin. Then row -> doc-id map, optional citation-weighted
rerank, metadata join. A mesh, live updates and the residual rescore mode
raise NotImplementedError; they come with later slices of the port.
"""

from __future__ import annotations

import math
import threading
import time
from typing import Any

import numpy as np
import torch

from ..core.config import SearchConfig
from ..index.flat import PAD_ID, FlatIndex
from ..kernels._build import load as _load_kernels
from ..kernels.mips import NEG_INF, device_rescore, fused_mips_topk, fused_mips_topk_g
from ..utils.device import resolve_device, upload
from ..utils.shapes import pow2_bucket, round_up as _round_up
from .filters import SearchFilters, compile_filter_mask, filter_key, infer_type
from .metadata import CorpusMetadata

# Over-fetch margins for the drop-on-host route: a BROAD filter fetches
# k + margin on the fast unfiltered route and drops non-passing ids on the
# host. Exact whenever a query's top-(k+margin) window holds <= margin
# failing docs, verified per batch, with the masked route as the exact
# re-run. The margin is the smallest entry at >= 6-sigma odds against that
# re-run (binomial over the window at the filter's failure rate); a 50%
# filter needs the full 64.
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


class SearchEngine:
    """Owns the device-resident index and runs batched queries.

    index: FlatIndex (int8 with per-row or global scale, bf16 or f32).
    rescore_vectors: optional (num_rows, D) originals (numpy or a tensor,
        any float dtype). With a global-scale int8 index and row-order doc
        ids they are held on the device as bf16 for the speed path's
        rescore; otherwise the exact route rescores on the host from them.
    device: where the index lives and the scans run. Default: the card
        (RuntimeError without CUDA); "cpu" runs the kernels' plain
        versions.
    ivf_index: optional IVFIndex on the same device, the low-latency
        route for small unfiltered batches (at most `ivf_max_batch` real
        queries). ivf_nprobe: an explicit value wins; else a calibrated
        index's nprobe is trusted verbatim; else the IVF route stays off
        and every batch takes the flat scan (the reference probes 16
        lists here, which holds the 0.99 gate only on well-separated
        clusters).
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
        rescore_factor: int = 4,
        device=None,
        mesh=None,
        ivf_index=None,
        ivf_nprobe: int | None = None,
        ivf_max_batch: int = 16,
    ):
        if mesh is not None:
            raise NotImplementedError("multi-device search is not ported yet")
        self.meta = meta
        self.config = config or SearchConfig()
        self.device = resolve_device(device)
        self.rescore_factor = rescore_factor
        self._global_scale = float(getattr(index, "global_scale", 0.0) or 0.0)

        if row_block is None:
            # the reference's corpus-sized default: largest power of two
            # <= rows/64, clamped to [128, 4096] and by the packing bound
            n0 = max(int(index.vectors.shape[0]) // 64, 1)
            row_block = min(4096, max(128, 1 << (n0.bit_length() - 1)))
            dim0 = int(index.vectors.shape[1])
            while row_block > 128 and 127 * 127 * dim0 * (row_block // 128) >= 2**31:
                row_block //= 2
        self.row_block = row_block

        vecs, ids, scales = index.vectors, index.ids, index.scales
        target = _round_up(vecs.shape[0], row_block)
        extra = target - vecs.shape[0]
        if extra:
            vecs = torch.cat([vecs, torch.zeros((extra, vecs.shape[1]), dtype=vecs.dtype)])
            ids = torch.cat([ids, torch.full((extra,), PAD_ID, dtype=ids.dtype)])
            if scales is not None:
                scales = torch.cat([scales, torch.zeros(extra, dtype=scales.dtype)])
        self.n_valid = index.num_rows
        self.padded_rows = target
        self.dim = vecs.shape[1]
        ids_h = ids[: self.n_valid].numpy()
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
        rb_ok = not (row_block % 128 or (row_block // 128) & (row_block // 128 - 1))
        self._speed_ok = (
            self._global_scale > 0
            and vecs.dtype == torch.int8
            and self.rescore_vectors is not None
            and self._main_ids_arange            # rescore rows == doc ids
            and self.padded_rows % max(row_block, 128) == 0
            and rb_ok
        )
        self.vectors = vecs.to(self.device).contiguous()
        self.ids = ids.to(torch.int32).to(self.device)
        self.scales = None if scales is None else scales.float().to(self.device).contiguous()
        self._rescore_device = None
        if self._speed_ok:
            rv = self.rescore_vectors
            # bf16 copy filled in row chunks: a whole f32 upload would
            # double the device footprint while it converts
            self._rescore_device = torch.empty(tuple(rv.shape), dtype=torch.bfloat16,
                                               device=self.device)
            for i in range(0, rv.shape[0], 65_536):
                self._rescore_device[i : i + 65_536] = rv[i : i + 65_536].to(self.device)

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
        # nprobe is known to hold the gate on it
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

    # ------------------------------------------------------------------
    # filters
    # ------------------------------------------------------------------

    @property
    def num_live(self) -> int:
        return self.n_valid

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
            return mask, torch.from_numpy(mask_host).to(self.device), pass_rate
        bias_host = np.full(self.padded_rows, NEG_INF, np.float32)
        bias_host[: mask.shape[0]] = np.where(mask, 0.0, NEG_INF)
        return mask, torch.from_numpy(bias_host).to(self.device), pass_rate

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
        mask = compile_filter_mask(filters, self.meta)
        if mask is not None:
            mask = mask[: self.n_valid]
        entry = (None, None, 0.0) if mask is None else self._mask_device_entry(mask)
        with self._filter_cache_lock:
            self.filter_mask_builds += 1
            self.filter_mask_build_s += time.monotonic() - t0
            if len(self._filter_cache) >= _FILTER_CACHE_MAX:
                self._filter_cache.pop(next(iter(self._filter_cache)))
            self._filter_cache[key] = entry
        return entry

    def _combined_mask_inputs(self, filters: SearchFilters | None):
        """(np bool mask | None, device mask/bias | None, pass rate) over
        the index rows. Delete tombstones would combine in here; live
        updates are not ported, so it is the user filter alone."""
        if filters is None:
            return None, None, 0.0
        return self._filter_device_inputs(filters)

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
            ones = torch.zeros(self.padded_rows, dtype=torch.int8)
            ones[: self.n_valid] = 1
            self._pass_fail_cache = (ones.to(self.device),
                                     torch.zeros(self.padded_rows, dtype=torch.int8,
                                                 device=self.device))
        return self._pass_fail_cache

    def _grouped_device_masks(self, ordered_keys, reps) -> torch.Tensor:
        """(G_pad, padded_rows) int8 device stack, row g = signature g's
        mask, pad rows all excluded. Stacked on the device per dispatch
        from the per-signature cached rows: a set-level cache would miss
        nearly always under a rotating mix while pinning dead stacks."""
        g_pad = max(8, pow2_bucket(len(ordered_keys)))
        pass_row, fail_row = self._pass_fail_rows()
        rows = []
        for fk, f in zip(ordered_keys, reps):
            mask, dev, _ = self._combined_mask_inputs(f if fk != () else None)
            rows.append(pass_row if mask is None else dev)
        rows.extend([fail_row] * (g_pad - len(rows)))
        return torch.stack(rows)

    def warm_overfetch(self, batch_sizes=(1,), k: int | None = None) -> None:
        """The reference compiles its over-fetch and IVF programs here; the
        port has nothing to compile, so this loads the kernels' library and
        runs the IVF route once per batch size it serves (first-use set-up
        stays out of a served request)."""
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

    def _to_doc_ids(self, li: torch.Tensor) -> torch.Tensor:
        return torch.where(li >= 0, self.ids[li.clamp(min=0).long()], PAD_ID)

    def _speed_search(self, q, k_q: int, base_k: int, mask=None, gmasks=None, mask_ids=None):
        """The speed route: (B_pad, D) f32 device queries -> (scores, doc
        ids) (B_pad, k_q), rescored on the device. Retrieves the window
        plus the oversampling tail from the quasi-exact int32 scan (masked
        or grouped when given masks), rescores exactly against the bf16
        copy and maps rows -> doc ids."""
        kr = min(self._candidate_width(k_q, base_k), self.padded_rows)
        _, li = fused_mips_topk_g(q, self.vectors, self._global_scale, self.n_valid, mask,
                                  k=kr, row_block=self.row_block, gmasks=gmasks,
                                  mask_ids=mask_ids)
        s, li = device_rescore(q, li, self._rescore_device, self.n_valid, k=k_q)
        return s, self._to_doc_ids(li)

    def _ivf_fn(self, k: int):
        """The IVF route's searcher for k, built once per k."""
        if k not in self._ivf_fns:
            self._ivf_fns[k] = self.ivf.device_searcher(
                k=k, nprobe=self.ivf_nprobe, rescore_factor=self.rescore_factor)
        return self._ivf_fns[k]

    def _exact_search(self, q, k_dev: int, bias=None):
        """The exact route (kernel B5): (scores, doc ids) (B_pad, k_dev)."""
        s, li = fused_mips_topk(q, self.vectors, self.scales, self.n_valid, bias,
                                k=k_dev, row_block=self.row_block)
        return s, self._to_doc_ids(li)

    def _pad_queries(self, query_vecs) -> tuple[torch.Tensor, int]:
        """(padded device queries, real batch): batches pad to the next
        power of two (min 8), so a serving mix sees few distinct shapes."""
        if isinstance(query_vecs, torch.Tensor):
            q = query_vecs.to(self.device, torch.float32)
        else:
            q = upload(np.asarray(query_vecs, dtype=np.float32), self.device)
        if q.ndim == 1:
            q = q[None, :]
        b = q.shape[0]
        b_pad = pow2_bucket(b)
        if b_pad != b:
            q = torch.cat([q, torch.zeros((b_pad - b, q.shape[1]), dtype=q.dtype, device=q.device)])
        return q.contiguous(), b

    @staticmethod
    def _to_host(*tensors):
        """Enqueue device -> pinned host copies and an event; returns
        (host tensors, event or None). The event, not the stream, is
        synchronized later, so later batches keep running."""
        if tensors[0].device.type != "cuda":
            return tensors, None
        out = []
        for t in tensors:
            h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            h.copy_(t, non_blocking=True)
            out.append(h)
        done = torch.cuda.Event()
        done.record()
        return tuple(out), done

    def search_vectors_async(self, query_vecs, k: int | None = None, filters=None,
                             _force_masked: bool = False):
        """Dispatch a batched search without waiting; returns
        ``finalize() -> (scores, ids)``, which waits on this batch's CUDA
        event only and reads the host copies. `filters` is one
        SearchFilters (or None) for the batch, or a list with one per
        query row (a grouped dispatch)."""
        if isinstance(filters, (list, tuple)):
            return self._dispatch_grouped(query_vecs, k, list(filters))
        k = k or self.config.top_k
        do_rescore = self.rescore_vectors is not None
        rescore_src = self._rescore_src()

        # a BROAD user filter stays on the fast unfiltered route: fetch
        # k + margin, drop non-passing ids on the host in finalize()
        drop_mask = None
        margin = 0
        k_q = k
        mask, dev, pass_rate = self._combined_mask_inputs(filters)
        if (not _force_masked and self.n_valid > k and mask is not None
                and pass_rate >= _OVERFETCH_MIN_PASS):
            margin = min(self._overfetch_margin(k, 1.0 - pass_rate), self.n_valid - k)
            drop_mask = mask
            k_q = k + margin
            mask = dev = None
        k_fetch = self._candidate_width(k_q, k) if do_rescore else k_q
        k_dev = min(max(k_fetch, 1), self.padded_rows)
        q, b = self._pad_queries(query_vecs)

        on_device = self._speed_ok
        s = i = None
        if mask is not None and pass_rate == 0.0:
            route = "empty"     # nothing passes: every slot is empty
        elif mask is None and drop_mask is None and self.ivf is not None and b <= self.ivf_max_batch:
            route = "ivf"       # rescored on the device; doc ids already
            s, i = self._ivf_fn(k_q)(q)
            on_device = True
        elif mask is None:
            route = ("overfetch" if drop_mask is not None
                     else "speed" if self._speed_ok else "exact")
            s, i = self._speed_search(q, k_q, k) if self._speed_ok else self._exact_search(q, k_dev)
        elif self._speed_ok:
            route = "masked"
            s, i = self._speed_search(q, k, k, mask=dev)
        else:
            route = "exact_masked"
            s, i = self._exact_search(q, k_dev, dev)
        self._count_route(route)
        if s is None:
            host, done = None, None
        elif do_rescore and not on_device:
            host, done = self._to_host(s, i, q)
        else:
            host, done = self._to_host(s, i)

        def finalize() -> tuple[np.ndarray, np.ndarray]:
            if host is None:
                return (np.full((b, k), NEG_INF, np.float32), np.full((b, k), PAD_ID, np.int32))
            if done is not None:
                done.synchronize()
            s_h, i_h = host[0].numpy()[:b], host[1].numpy()[:b]
            if do_rescore and not on_device:
                s_h, i_h = self._rescore(host[2].numpy()[:b], s_h, i_h, k_q, src=rescore_src)
            if drop_mask is not None:
                idsw = i_h[:, :k_q]
                safe = np.clip(idsw, 0, drop_mask.shape[0] - 1)
                dead = ~drop_mask[safe] & (idsw >= 0)
                if dead.any():
                    if int(dead.sum(axis=1).max()) > margin:
                        # some query's window holds more failing docs
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
            # -inf scores mean "fewer than k docs pass the filter"
            return s2, np.where(np.isfinite(s2), i2, PAD_ID)

        return finalize

    def _dispatch_grouped(self, query_vecs, k: int | None, filters_list: list):
        """One dispatch for a batch whose queries carry DIFFERENT filters
        (one SearchFilters-or-None per query row): per-query mask rows in
        a single scan; more than `max_filter_groups` signatures split and
        stitch by row, and engines without the grouped scan dispatch per
        signature. Rows of the query matrix beyond the list are scanned as
        don't-cares and never returned."""
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
            return self.search_vectors_async(qv, k, reps[0])
        if len(ordered) > self.max_filter_groups or not self.supports_grouped_filters:
            budget = self.max_filter_groups if self.supports_grouped_filters else 1
            parts = []
            for lo in range(0, len(ordered), budget):
                sigs = set(ordered[lo : lo + budget])
                rows = np.array([r for r, fk in enumerate(keys) if fk in sigs], np.int64)
                sub_q = qv[rows] if isinstance(qv, np.ndarray) else qv[upload(rows, qv.device)]
                sub_f = [filters_list[r] for r in rows]
                fin = (self.search_vectors_async(sub_q, k, sub_f[0]) if budget == 1
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

        if self.meta is not None:
            self._require_arange_for_filters()
        gm_dev = self._grouped_device_masks(ordered, reps)
        q, b = self._pad_queries(qv)
        mid = np.zeros(q.shape[0], np.int32)
        mid[:n_rows] = [gid[fk] for fk in keys]
        mid_dev = upload(mid, self.device)
        self._count_route("grouped")
        s, i = self._speed_search(q, k, k, gmasks=gm_dev, mask_ids=mid_dev)
        (s_h, i_h), done = self._to_host(s, i)

        def finalize() -> tuple[np.ndarray, np.ndarray]:
            if done is not None:
                done.synchronize()
            s2, i2 = s_h.numpy()[:n_rows, :k], i_h.numpy()[:n_rows, :k]
            return s2, np.where(np.isfinite(s2), i2, PAD_ID)

        return finalize

    def search_vectors(self, query_vecs, k: int | None = None, filters=None):
        """Batched vector search: (scores (B, k), doc_ids (B, k)); PAD_ID
        (-1) marks slots beyond the number of matching docs."""
        return self.search_vectors_async(query_vecs, k, filters)()

    # ------------------------------------------------------------------
    # host rescore (exact route)
    # ------------------------------------------------------------------

    def _rescore_src(self) -> tuple:
        """The host arrays `_rescore` reads, taken at dispatch. The
        residual capacity mode's fields are not ported."""
        return (self.rescore_vectors, self._rescore_sorted_ids, self._rescore_order)

    def _rescore(self, q: np.ndarray, s: np.ndarray, ids: np.ndarray, k: int,
                 src: tuple | None = None):
        """Exact fp32 rescoring of the oversampled candidates on the host:
        gather the original rows for each (query, candidate) and re-rank
        (stable, so ties keep the scan's order)."""
        rescore_vectors, sorted_ids, order = src if src is not None else self._rescore_src()
        if rescore_vectors is None:
            raise NotImplementedError("the residual rescore mode is not ported yet")
        if sorted_ids is not None:
            # doc id -> index row via the sorted-id map (custom ids)
            pos = np.searchsorted(sorted_ids, np.maximum(ids, 0))
            pos = np.clip(pos, 0, order.shape[0] - 1)
            safe = order[pos]
        else:
            safe = np.clip(ids, 0, rescore_vectors.shape[0] - 1)
        cand = rescore_vectors[torch.from_numpy(safe.astype(np.int64))].float().numpy()
        re_s = np.einsum("bcd,bd->bc", cand, q.astype(np.float32))
        re_s = np.where((ids >= 0) & np.isfinite(s), re_s, -np.inf)
        sel = np.argsort(-re_s, axis=1, kind="stable")[:, :k]
        return np.take_along_axis(re_s, sel, 1), np.take_along_axis(ids, sel, 1)

    # ------------------------------------------------------------------
    # live updates (not ported yet)
    # ------------------------------------------------------------------

    def add_documents(self, vectors, meta_rows=None):
        raise NotImplementedError("live updates are not ported yet")

    def delete_documents(self, doc_ids):
        raise NotImplementedError("live updates are not ported yet")

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
