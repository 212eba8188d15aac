"""Micro-batching query scheduler for concurrent serving (port of
theoremsearch_tpu/serve/scheduler.py: the same batching, admission
control, resolver pool and stats; the device row gather/scatter of
mixed text + vector groups is torch indexing on the device).

Batching is what makes the scan pay: the corpus is read once per batch,
so throughput grows with the number of queries each scan carries. This
scheduler collects concurrently-submitted queries into batches of up to
``max_batch`` (or whatever arrives within ``max_wait_ms``), runs ONE
engine dispatch per batch on a dedicated dispatch thread, and resolves
per-caller futures from a pool of resolver threads. Filtered queries
batch only with queries sharing the same filter signature (the engine
port serves only filters that exclude nothing so far).
"""

from __future__ import annotations

import collections
import queue
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch

from ..search.engine import SearchEngine
from ..search.filters import SearchFilters, filter_key as _filter_key
from ..utils.shapes import pow2_bucket


class SchedulerOverloaded(RuntimeError):
    """Raised by submit()/submit_text() when the pending queue exceeds
    max_pending — admission control for saturated serving (without it,
    latency at saturation is unbounded queueing). HTTP surfaces map this
    to 429."""


@dataclass
class _Request:
    vec: np.ndarray | None
    k: int
    filters: SearchFilters | None
    text: str | None = None
    future: Future = field(default_factory=Future)
    t_submit: float = field(default_factory=time.monotonic)


@dataclass
class _BatchTrace:
    """Per-dispatched-batch stage timestamps (p99 attribution). All
    monotonic seconds; one record per engine dispatch, shared by every
    request in it."""

    n: int                    # queries in the batch
    queue_ms: float           # oldest request's submit -> drain
    encode_ms: float          # batched encoder dispatch (0 if no text)
    scan_ms: float            # engine.search_vectors_async dispatch
    resolve_wait_ms: float = 0.0   # dispatched -> a resolver picks it up
    sync_ms: float = 0.0           # finalize(): device->host sync + host drops
    total_ms: float = 0.0          # oldest submit -> futures resolved
    g: int = 0                     # filter signatures in the batch (0 or 1)


class BatchScheduler:
    def __init__(
        self,
        engine: SearchEngine,
        max_batch: int = 256,
        max_wait_ms: float = 2.0,
        encode_fn=None,
        pipeline_depth: int = 4,
        max_pending: int | None = None,
        filter_coalesce_ms: float = 30.0,
        filter_coalesce_min: int = 32,
    ):
        """max_pending: admission-control bound on queued-but-undispatched
        requests; beyond it submit() raises SchedulerOverloaded instead
        of letting tail latency grow without bound.

        filter_coalesce_ms/_min: filtered requests are HELD until their
        filter signature has _min requests or _ms elapsed, then batch
        into one scan. Each filtered group costs a full corpus scan +
        host round trip regardless of its size, so dispatching 2-query
        groups every cycle round-trip-binds mixed traffic; coalescing
        amortizes the scan over the signature's arrivals at a bounded
        latency cost. Held TEXT requests encode in the batch where their
        group fires (their vectors are never materialized early).

        encode_fn: optional ``list[str] -> (B, D) array``; enables
        submit_text(), which micro-batches the ENCODER as well as the scan
        (one encoder forward + one corpus scan per dispatched batch — the
        full text->top-k serving path). Pass BatchedEncoder.encode_device
        to keep embeddings on device: the whole encode->scan->top-k batch
        then syncs to the host exactly once, in the resolver thread."""
        self.engine = engine
        self.encode_fn = encode_fn
        self.max_batch = max_batch
        self.max_wait_s = max_wait_ms / 1000.0
        self.max_pending = max_pending
        self.filter_coalesce_s = filter_coalesce_ms / 1000.0
        self.filter_coalesce_min = filter_coalesce_min
        self._held: dict[tuple, list[_Request]] = {}
        self._held_deadline: dict[tuple, float] = {}
        self._inflight = 0
        self._inflight_lock = threading.Lock()
        self._q: "queue.Queue[_Request | None]" = queue.Queue()
        self._stats = {"batches": 0, "queries": 0, "shed": 0, "errors": 0}
        # bounded ring of recent end-to-end latencies (submit -> future
        # resolved), sampled for the stats()/metrics percentiles
        self._latencies: collections.deque[float] = collections.deque(maxlen=4096)
        # bounded ring of per-batch stage traces (p99 attribution)
        self._traces: collections.deque[_BatchTrace] = collections.deque(maxlen=4096)
        self._stats_lock = threading.Lock()
        # pipelined resolution: the dispatch thread enqueues device work
        # and a finalizer; a POOL of resolver threads performs the host
        # syncs, each waiting on one batch's CUDA event, so concurrent
        # syncs overlap instead of serializing. The bounded queue applies
        # backpressure if the device outruns the host side.
        self._rq: "queue.Queue" = queue.Queue(maxsize=2 * pipeline_depth)
        self._resolvers = [
            threading.Thread(target=self._resolve_loop, daemon=True)
            for _ in range(max(1, pipeline_depth))
        ]
        for t in self._resolvers:
            t.start()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    # ------------- client API -------------

    def submit(
        self, query_vec: np.ndarray, k: int = 10, filters: SearchFilters | None = None
    ) -> Future:
        """Returns a Future resolving to (scores (k,), doc_ids (k,))."""
        req = _Request(np.asarray(query_vec, np.float32), k, filters)
        self._admit(req)
        self._q.put(req)
        return req.future

    def _admit(self, req: _Request) -> None:
        """Admission control on IN-FLIGHT requests (submitted, not yet
        resolved — queue depth alone misses work already drained into a
        dispatch batch)."""
        if self.max_pending is None:
            return
        with self._inflight_lock:
            if self._inflight >= self.max_pending:
                with self._stats_lock:
                    self._stats["shed"] += 1
                raise SchedulerOverloaded(
                    f"{self._inflight} requests in flight "
                    f"(max_pending={self.max_pending})"
                )
            self._inflight += 1

        def _done(_f):
            with self._inflight_lock:
                self._inflight -= 1

        req.future.add_done_callback(_done)

    def submit_text(
        self, query: str, k: int = 10, filters: SearchFilters | None = None
    ) -> Future:
        """Text-in variant: the dispatch thread encodes every queued text
        in one batched encoder call before the batched scan."""
        if self.encode_fn is None:
            raise ValueError("submit_text requires an encode_fn")
        req = _Request(None, k, filters, text=query)
        self._admit(req)
        self._q.put(req)
        return req.future

    def search(self, query_vec, k: int = 10, filters=None, timeout: float = 30.0):
        return self.submit(query_vec, k, filters).result(timeout)

    def stats(self) -> dict[str, Any]:
        with self._stats_lock:
            s = dict(self._stats)
            lat = sorted(self._latencies)
            traces = list(self._traces)
        s["avg_batch"] = s["queries"] / s["batches"] if s["batches"] else 0.0
        with self._inflight_lock:
            s["inflight"] = self._inflight
        s["held"] = sum(len(v) for v in list(self._held.values()))
        if lat:
            s["latency_ms"] = {
                q: 1000.0 * lat[min(len(lat) - 1, int(q * len(lat)))]
                for q in (0.5, 0.95, 0.99)
            }
        if traces:
            s["stages_ms"] = self._stage_percentiles(traces)
        return s

    @staticmethod
    def _stage_percentiles(traces: list[_BatchTrace]) -> dict[str, dict]:
        """Per-stage p50/p99/max over the recent batch traces, plus the
        stage mix of the WORST batches — the attribution a p99
        investigation needs (which stage do tail batches spend in?)."""
        fields = ("queue_ms", "encode_ms", "scan_ms", "resolve_wait_ms",
                  "sync_ms", "total_ms")
        out: dict[str, Any] = {}
        for f in fields:
            v = sorted(getattr(t, f) for t in traces)
            out[f] = {
                "p50": round(v[len(v) // 2], 2),
                "p99": round(v[min(len(v) - 1, int(0.99 * len(v)))], 2),
                "max": round(v[-1], 2),
            }
        worst = sorted(traces, key=lambda t: -t.total_ms)[: max(3, len(traces) // 100)]
        out["worst_batches"] = [
            {f: round(getattr(t, f), 1) for f in fields} | {"n": t.n, "g": t.g}
            for t in worst[:5]
        ]
        return out

    def reset_traces(self) -> None:
        """Clear the stage-trace and latency rings (per-measurement-window
        attribution in benches)."""
        with self._stats_lock:
            self._traces.clear()
            self._latencies.clear()

    def shutdown(self) -> None:
        self._q.put(None)
        self._thread.join(timeout=10)
        for _ in self._resolvers:
            self._rq.put(None)
        for t in self._resolvers:
            t.join(timeout=10)

    # ------------- dispatch loop -------------

    def _flush_all_held(self) -> None:
        for k in self._held_deadline:
            self._held_deadline[k] = 0.0
        self._run_groups([])

    def _loop(self) -> None:
        while True:
            timeout = None
            if self._held_deadline:
                timeout = max(
                    0.0, min(self._held_deadline.values()) - time.time()
                )
            try:
                first = self._q.get(timeout=timeout)
            except queue.Empty:
                self._run_groups([])  # flush expired filter holds
                continue
            if first is None:
                self._flush_all_held()
                return
            batch = [first]
            # drain for up to max_wait or until max_batch
            deadline = time.time() + self.max_wait_s
            while len(batch) < self.max_batch:
                remaining = deadline - time.time()
                if remaining <= 0:
                    break
                try:
                    nxt = self._q.get(timeout=remaining)
                except queue.Empty:
                    break
                if nxt is None:
                    self._run_groups(batch)
                    self._flush_all_held()
                    return
                batch.append(nxt)
            # pipeline backpressure as batch growth: while every resolver
            # slot is busy, dispatching another small batch only queues —
            # keep draining so saturation produces FEWER, LARGER batches
            # (amortizing the per-batch device->host round trip) instead
            # of many round-trip-bound small ones
            while len(batch) < self.max_batch and self._rq.full():
                try:
                    nxt = self._q.get(timeout=0.002)
                except queue.Empty:
                    break
                if nxt is None:
                    self._run_groups(batch)
                    self._flush_all_held()
                    return
                batch.append(nxt)
            self._run_groups(batch)

    def _run_groups(self, batch: list[_Request]) -> None:
        # filtered requests coalesce by signature: each group costs a
        # full corpus scan + round trip regardless of size, so hold them
        # until the signature has filter_coalesce_min requests or its
        # deadline passes; unfiltered requests dispatch immediately
        now = time.time()
        immediate: list[_Request] = []
        for r in batch:
            key = _filter_key(r.filters)
            if key == ():
                immediate.append(r)
            else:
                if key not in self._held:
                    self._held_deadline[key] = now + self.filter_coalesce_s
                self._held.setdefault(key, []).append(r)
        groups: list[tuple[tuple, list[_Request]]] = []
        total = 0
        if immediate:
            groups.append(((), immediate))
            total = len(immediate)
        for key in [
            k for k in self._held
            if len(self._held[k]) >= self.filter_coalesce_min
            or now >= self._held_deadline[k]
        ]:
            # cap a cycle's dispatch at max_batch total queries: larger
            # composites would hit un-warmed device shapes (a release
            # deferred past the cap goes out next cycle, ~ms later)
            if (
                total
                and total + len(self._held[key]) > self.max_batch
                and now < self._held_deadline[key] + 4 * self.filter_coalesce_s
            ):
                continue  # defer (bounded: force-release past 4x deadline)
            reqs = self._held.pop(key)
            self._held_deadline.pop(key)
            groups.append((key, reqs))
            total += len(reqs)
        if not groups:
            return

        # encode ALL text requests (across every dispatching group) in
        # ONE batched forward. The result may be a DEVICE array
        # (encode_device): groups consume it without a host sync.
        t_drain = time.monotonic()
        dispatching = [r for _, reqs in groups for r in reqs]
        text_reqs = [r for r in dispatching if r.vec is None]
        enc = None
        encode_ms = 0.0
        if text_reqs:
            try:
                enc = self.encode_fn([r.text for r in text_reqs])
                encode_ms = 1000.0 * (time.monotonic() - t_drain)
            except Exception as e:  # noqa: BLE001
                with self._stats_lock:
                    self._stats["errors"] += len(text_reqs)
                for r in text_reqs:
                    if not r.future.done():
                        r.future.set_exception(e)
                groups = [
                    (key, [r for r in reqs if r.vec is not None])
                    for key, reqs in groups
                ]
                groups = [(key, reqs) for key, reqs in groups if reqs]
                text_reqs = []
        text_pos = {id(r): i for i, r in enumerate(text_reqs)}

        # one ASYNC dispatch per filter group
        n_groups = 0
        n_queries = 0
        for key, reqs in groups:
            treqs = [r for r in reqs if r.vec is None]
            vreqs = [r for r in reqs if r.vec is not None]
            reqs_ord = treqs + vreqs
            try:
                t_g = time.monotonic()
                q = self._group_queries(
                    enc,
                    [text_pos[id(r)] for r in treqs],
                    len(text_reqs),
                    np.stack([r.vec for r in vreqs]) if vreqs else None,
                )
                k_max = max(r.k for r in reqs_ord)
                filters_arg = reqs_ord[0].filters if key else None
                fin = self.engine.search_vectors_async(
                    q, k=k_max, filters=filters_arg
                )
                t_put = time.monotonic()
                trace = _BatchTrace(
                    n=len(reqs_ord),
                    queue_ms=1000.0 * (t_drain - min(r.t_submit for r in reqs_ord)),
                    encode_ms=encode_ms,
                    scan_ms=1000.0 * (t_put - t_g),
                    g=1 if key else 0,
                )
                self._rq.put((reqs_ord, fin, trace, t_put))
                n_groups += 1
                n_queries += len(reqs_ord)
            except Exception as e:  # noqa: BLE001
                with self._stats_lock:
                    self._stats["errors"] += len(reqs_ord)
                for r in reqs_ord:
                    if not r.future.done():
                        r.future.set_exception(e)
        with self._stats_lock:
            self._stats["batches"] += n_groups
            self._stats["queries"] += n_queries

    @staticmethod
    def _group_queries(enc, rows: list[int], n_text_total: int, vecs):
        """Query matrix for one filter group: rows `rows` of the batched
        encode output followed by the host vectors `vecs`, without syncing
        a device `enc` to the host. Device shapes are pow2-bucketed."""
        if not rows:
            return vecs
        on_device = isinstance(enc, torch.Tensor)
        if vecs is None and rows == list(range(n_text_total)):
            # single all-text group: a device encode output is already the
            # batch (its junk pow2 tail beyond n_text_total is never read)
            return enc if on_device else np.asarray(enc)[:n_text_total]
        if not on_device:
            g = np.asarray(enc)[rows]
            return g if vecs is None else np.concatenate([g, vecs])
        idx = np.zeros(pow2_bucket(len(rows)), np.int64)
        idx[: len(rows)] = rows
        g = enc[torch.as_tensor(idx, device=enc.device)]   # junk beyond len(rows)
        if vecs is None:
            return g
        return BatchScheduler._assemble_mixed(g, len(rows), vecs)

    @staticmethod
    def _assemble_mixed(enc, n_text: int, vecs: np.ndarray):
        """(n_pad, D) batch = enc rows [0, n_text) followed by the host
        `vecs` rows; a device `enc` stays on the device and the result is
        padded to a power of two."""
        if not isinstance(enc, torch.Tensor):
            return np.concatenate([np.asarray(enc)[:n_text], vecs])
        total = n_text + vecs.shape[0]
        out = torch.zeros((pow2_bucket(total), enc.shape[1]), dtype=enc.dtype, device=enc.device)
        out[:n_text] = enc[:n_text]
        out[n_text:total] = torch.as_tensor(vecs, dtype=enc.dtype).to(enc.device)
        return out

    # ------------- resolver -------------

    def _resolve_loop(self) -> None:
        while True:
            item = self._rq.get()
            if item is None:
                return
            reqs, fin, trace, t_put = item
            try:
                t_pick = time.monotonic()
                scores, ids = fin()
                now = time.monotonic()
                trace.resolve_wait_ms = 1000.0 * (t_pick - t_put)
                trace.sync_ms = 1000.0 * (now - t_pick)
                for i, r in enumerate(reqs):
                    r.future.set_result((scores[i, : r.k], ids[i, : r.k]))
                trace.total_ms = 1000.0 * (
                    now - min(r.t_submit for r in reqs)
                )
                with self._stats_lock:
                    self._latencies.extend(now - r.t_submit for r in reqs)
                    self._traces.append(trace)
            except Exception as e:  # noqa: BLE001
                with self._stats_lock:
                    self._stats["errors"] += len(reqs)
                for r in reqs:
                    if not r.future.done():
                        r.future.set_exception(e)
