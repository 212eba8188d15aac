"""Live-update delta buffer: new documents are searchable by the next query
(port of theoremsearch_tpu/search/delta.py). The buffer lives on one
device: under a mesh the engine keeps it on the mesh's first device and
merges it after the shard gather (the reference replicates it, P()).

New vectors land in a small append-only buffer beside the packed index,
with a power-of-two capacity; every query runs the main scan and an exact
f32 top-k over the buffer, merged on the host. Deletes give a delta row a
-inf bias; `SearchEngine.compact()` folds the buffer into the index.

Host f32 copies are canonical (compaction and the swap reconcile read
them); the device mirror holds the rows in bf16, as the reference's does,
and is updated in place: every read of it is enqueued on the same stream
before a later update, so a dispatched query sees the rows of its
dispatch. The delta scores are exact f32 products of the f32 query and
the bf16 rows with TF32 off, so they rank against the main route's
rescored scores without a rounding of their own.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..utils.device import tf32_off, upload

NEG_INF = float("-inf")
PAD_ID = -1
_MIN_CAP = 1024


def _pow2_at_least(n: int, floor: int = 8) -> int:
    p = floor
    while p < n:
        p *= 2
    return p


def _delta_topk(q: torch.Tensor, vecs: torch.Tensor, ids: torch.Tensor, bias: torch.Tensor,
                kd: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact top-kd over the delta buffer: q (B, D) f32, vecs (cap, D)
    bf16, ids (cap,) int32, bias (cap,) or (B, cap) f32 (0 = live, -inf =
    empty, deleted or filtered). Ties go to the lower row, as lax.top_k's
    do. Returns (B, kd) scores and doc ids."""
    with tf32_off():
        s = q.float() @ vecs.float().T
    s = s + (bias if bias.ndim == 2 else bias[None, :])
    # one top-k over int64 keys (score's order-preserving int32 bits, then
    # the row reversed): the lower row wins a tie without a full sort
    bits = s.view(torch.int32)
    bits = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits).to(torch.int64)
    rows = torch.arange(s.shape[1], device=s.device, dtype=torch.int64)
    keys = torch.topk((bits << 32) | (0xFFFFFFFF - rows), kd, dim=1).values
    sel = 0xFFFFFFFF - (keys & 0xFFFFFFFF)
    return torch.gather(s, 1, sel), ids[sel]


class DeltaBuffer:
    """Append-only buffer of (vector, doc_id) rows with tombstones. All
    mutation goes through the owning engine's lock; this class is not
    itself thread-safe."""

    def __init__(self, dim: int, device):
        self.dim = dim
        self.device = torch.device(device)
        self.cap = 0
        self.n = 0                      # next free row
        self.n_live = 0
        self.vecs = np.zeros((0, dim), np.float32)      # host canonical
        self.ids = np.full(0, PAD_ID, np.int64)
        self.live = np.zeros(0, bool)
        self.dev_vecs = None            # (cap, D) bf16
        self.dev_ids = None             # (cap,) int32
        self.dev_bias = None            # (cap,) f32: 0 live, -inf dead
        # row of each live doc id (host-side upsert/delete lookup)
        self._row_of: dict[int, int] = {}

    # ------------- mutation -------------

    def _grow(self, need: int) -> None:
        new_cap = _pow2_at_least(need, _MIN_CAP)
        vecs = np.zeros((new_cap, self.dim), np.float32)
        ids = np.full(new_cap, PAD_ID, np.int64)
        live = np.zeros(new_cap, bool)
        vecs[: self.n] = self.vecs[: self.n]
        ids[: self.n] = self.ids[: self.n]
        live[: self.n] = self.live[: self.n]
        self.vecs, self.ids, self.live, self.cap = vecs, ids, live, new_cap
        self._push_full()

    def _push_full(self) -> None:
        """Place the whole buffer on the device (growth)."""
        self.dev_vecs = upload(torch.from_numpy(self.vecs).to(torch.bfloat16), self.device)
        self.dev_ids = upload(np.where(self.live, self.ids, PAD_ID).astype(np.int32), self.device)
        self.dev_bias = upload(np.where(self.live, 0.0, NEG_INF).astype(np.float32), self.device)

    def add(self, embeddings: np.ndarray, ids: np.ndarray) -> None:
        m = embeddings.shape[0]
        start = self.n
        self._append_host(embeddings, ids, start)
        if self.n > self.cap:
            self._grow(self.n)          # growth places everything anew
            return
        rows = torch.arange(start, start + m, device=self.device)
        self.dev_vecs[rows] = upload(torch.from_numpy(
            np.ascontiguousarray(embeddings, np.float32)).to(torch.bfloat16), self.device)
        self.dev_ids[rows] = upload(np.asarray(ids, np.int64).astype(np.int32), self.device)
        self.dev_bias[rows] = 0.0

    def _append_host(self, embeddings, ids, start) -> None:
        m = embeddings.shape[0]
        if start + m > self.vecs.shape[0]:
            pad = start + m - self.vecs.shape[0]
            self.vecs = np.concatenate([self.vecs, np.zeros((pad, self.dim), np.float32)])
            self.ids = np.concatenate([self.ids, np.full(pad, PAD_ID, np.int64)])
            self.live = np.concatenate([self.live, np.zeros(pad, bool)])
        self.vecs[start : start + m] = embeddings
        self.ids[start : start + m] = ids
        self.live[start : start + m] = True
        for j, d in enumerate(ids):
            self._row_of[int(d)] = start + j
        self.n = start + m
        self.n_live += m

    def kill_rows(self, rows: list[int]) -> None:
        if not rows:
            return
        for r in rows:
            if self.live[r]:
                self.live[r] = False
                self.n_live -= 1
                self._row_of.pop(int(self.ids[r]), None)
        idx = upload(np.asarray(rows, np.int64), self.device)
        self.dev_bias[idx] = NEG_INF
        self.dev_ids[idx] = PAD_ID

    def row_of(self, doc_id: int) -> int | None:
        return self._row_of.get(int(doc_id))

    def rebuild_row_of(self) -> None:
        """Recompute the id -> row map from the live flags. kill_rows pops
        by id, which aliases when a dead row shares its id with a later
        live row (a replayed update history)."""
        self._row_of = {int(self.ids[r]): r for r in range(self.n) if self.live[r]}

    # ------------- query -------------

    def searcher(self, kd: int) -> Callable:
        """(q, extra_bias | None) -> (scores (B, kd), ids (B, kd)) device
        tensors over the buffer's present device arrays (a growth swaps
        them; a dispatched query keeps its view)."""
        vecs, ids, bias = self.dev_vecs, self.dev_ids, self.dev_bias

        def run(q, extra_bias=None):
            b = bias if extra_bias is None else bias + extra_bias
            return _delta_topk(q, vecs, ids, b, kd)

        return run

    def live_rows(self) -> tuple[np.ndarray, np.ndarray]:
        """(live embeddings f32, live doc ids) in insertion order."""
        sel = self.live[: self.n]
        return self.vecs[: self.n][sel], self.ids[: self.n][sel]

    def reset(self) -> None:
        self.__init__(self.dim, self.device)
