"""The query engine's single-device speed path (port of
theoremsearch_tpu/search/engine.py).

Queries -> packed lane-maxima scan of the global-scale int8 index
(`kernels/mips.py:fused_mips_topk_g`, CUDA kernel on the card) -> exact
rescore of the oversampled candidates against the bf16 copy ->
row -> doc-id map -> optional citation-weighted rerank -> metadata join.

This is the only route ported so far. A configuration the speed path
does not cover (no global-scale int8 index, no bf16 rescore copy, custom
doc ids, a mesh), a filter that excludes rows, and live updates raise
NotImplementedError; they come with later slices of the port.
"""

from __future__ import annotations

import math
from typing import Any

import numpy as np
import torch

from ..core.config import SearchConfig
from ..index.flat import PAD_ID, FlatIndex
from ..kernels.mips import device_rescore, fused_mips_topk_g
from ..utils.shapes import pow2_bucket, round_up as _round_up
from .filters import SearchFilters, compile_filter_mask, filter_key, infer_type
from .metadata import CorpusMetadata


class SearchEngine:
    """Owns the device-resident index and runs batched queries.

    index: FlatIndex with dtype int8, int8_scale "global".
    rescore_vectors: (num_rows, D) originals (numpy f32 or a tensor, any
        float dtype), held on the device as bf16 for the exact rescore.
    device: where the index lives and the scan runs ("cuda" on the card;
        "cpu" runs the kernels' plain versions).
    """

    def __init__(
        self,
        index: FlatIndex,
        meta: CorpusMetadata | None = None,
        config: SearchConfig | None = None,
        row_block: int | None = None,
        rescore_vectors=None,
        rescore_factor: int = 4,
        device="cpu",
        mesh=None,
    ):
        if mesh is not None:
            raise NotImplementedError("multi-device search is not ported yet")
        self.meta = meta
        self.config = config or SearchConfig()
        self.device = torch.device(device)
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

        vecs, ids = index.vectors, index.ids
        target = _round_up(vecs.shape[0], row_block)
        extra = target - vecs.shape[0]
        if extra:
            vecs = torch.cat([vecs, torch.zeros((extra, vecs.shape[1]), dtype=vecs.dtype)])
            ids = torch.cat([ids, torch.full((extra,), PAD_ID, dtype=ids.dtype)])
        self.n_valid = index.num_rows
        self.padded_rows = target
        self.dim = vecs.shape[1]
        ids_h = ids[: self.n_valid].numpy()
        ids_arange = bool(np.array_equal(ids_h, np.arange(self.n_valid, dtype=ids_h.dtype)))

        if rescore_vectors is not None and rescore_vectors.shape[0] != index.num_rows:
            raise ValueError(
                f"rescore_vectors has {rescore_vectors.shape[0]} rows, index has {index.num_rows}"
            )
        rb_ok = not (row_block % 128 or (row_block // 128) & (row_block // 128 - 1))
        self._speed_ok = (
            self._global_scale > 0
            and vecs.dtype == torch.int8
            and rescore_vectors is not None
            and ids_arange                       # rescore rows == doc ids
            and self.padded_rows % max(row_block, 128) == 0
            and rb_ok
        )
        if not self._speed_ok:
            raise NotImplementedError(
                "only the single-device speed path is ported: a global-scale "
                "int8 index with row-order doc ids, a bf16 rescore copy and a "
                "power-of-two multiple of 128 as row_block"
            )
        self.vectors = vecs.to(self.device).contiguous()
        self.ids = ids.to(torch.int32).to(self.device)
        rv = rescore_vectors
        if isinstance(rv, np.ndarray):
            rv = torch.from_numpy(np.ascontiguousarray(rv, dtype=np.float32))
        # bf16 copy filled in row chunks: a whole f32 upload would double
        # the device footprint while it converts
        self._rescore_device = torch.empty(tuple(rv.shape), dtype=torch.bfloat16, device=self.device)
        for i in range(0, rv.shape[0], 65_536):
            self._rescore_device[i : i + 65_536] = rv[i : i + 65_536].to(self.device)

    # ------------------------------------------------------------------
    # device search
    # ------------------------------------------------------------------

    @property
    def num_live(self) -> int:
        return self.n_valid

    def _candidate_width(self, k_q: int, base_k: int) -> int:
        """Rescore-candidate width: the window plus the plain path's
        absolute oversampling tail, (rescore_factor - 1) * base_k."""
        return k_q + (self.rescore_factor - 1) * base_k

    def _speed_search(self, q: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
        """The speed branch of the reference's `_build_search_fn`: queries
        (B_pad, D) f32 on the device -> (scores, doc ids) (B_pad, k).
        Retrieves kr candidates (quasi-exact int32 scan), rescores them
        exactly against the bf16 copy and maps rows -> doc ids."""
        kr = min(self._candidate_width(k, k), self.padded_rows)
        _, li = fused_mips_topk_g(q, self.vectors, self._global_scale, self.n_valid,
                                  k=kr, row_block=self.row_block)
        s, li = device_rescore(q, li, self._rescore_device, self.n_valid, k=k)
        return s, torch.where(li >= 0, self.ids[li.clamp(min=0).long()], PAD_ID)

    def _pad_queries(self, query_vecs) -> tuple[torch.Tensor, int]:
        """(padded device queries, real batch): batches pad to the next
        power of two (min 8), so a serving mix sees few distinct shapes."""
        if isinstance(query_vecs, torch.Tensor):
            q = query_vecs.to(self.device, torch.float32)
        else:
            q = torch.from_numpy(np.asarray(query_vecs, dtype=np.float32))
            if self.device.type == "cuda":   # enqueue the upload, do not wait
                q = q.pin_memory().to(self.device, non_blocking=True)
        if q.ndim == 1:
            q = q[None, :]
        b = q.shape[0]
        b_pad = pow2_bucket(b)
        if b_pad != b:
            q = torch.cat([q, torch.zeros((b_pad - b, q.shape[1]), dtype=q.dtype, device=q.device)])
        return q.contiguous(), b

    def _check_filters(self, filters) -> None:
        """Trivial filters (nothing excluded) take the unfiltered path;
        filters that exclude rows are not ported yet."""
        if isinstance(filters, (list, tuple)):
            for f in filters:
                self._check_filters(f)
            return
        if filters is None or filter_key(filters) == ():
            return
        if self.meta is None:
            raise ValueError("filters require CorpusMetadata")
        if compile_filter_mask(filters, self.meta) is not None:
            raise NotImplementedError("filtered search is not ported yet")

    def search_vectors_async(self, query_vecs, k: int | None = None, filters=None):
        """Dispatch a batched search without waiting. The device work and
        a device->host copy into pinned buffers are enqueued, then a CUDA
        event; the returned ``finalize() -> (scores, ids)`` synchronizes
        that event only (not the whole stream, so later batches keep
        running) and reads the host copies."""
        self._check_filters(filters)
        k = k or self.config.top_k
        q, b = self._pad_queries(query_vecs)
        s, i = self._speed_search(q, k)
        if q.device.type == "cuda":
            s_h = torch.empty(s.shape, dtype=s.dtype, pin_memory=True)
            i_h = torch.empty(i.shape, dtype=i.dtype, pin_memory=True)
            s_h.copy_(s, non_blocking=True)
            i_h.copy_(i, non_blocking=True)
            done = torch.cuda.Event()
            done.record()
        else:
            s_h, i_h, done = s, i, None

        def finalize() -> tuple[np.ndarray, np.ndarray]:
            if done is not None:
                done.synchronize()
            s2 = s_h.numpy()[:b, :k]
            i2 = i_h.numpy()[:b, :k]
            # -inf scores mean "fewer than k docs"
            return s2, np.where(np.isfinite(s2), i2, PAD_ID)

        return finalize

    def search_vectors(self, query_vecs, k: int | None = None, filters=None):
        """Batched vector search: (scores (B, k), doc_ids (B, k)); PAD_ID
        (-1) marks slots beyond the number of docs."""
        return self.search_vectors_async(query_vecs, k, filters)()

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
