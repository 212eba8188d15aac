"""IVF (inverted-file) index with a spherical k-means coarse quantizer
(port of theoremsearch_tpu/index/ivf.py, its single-device half).

- **Training**: spherical k-means on the device from a seeded
  `torch.Generator`: assignment is one (N, D) x (D, L) f32 product (TF32
  off) and an argmax per round, the centroid update a scatter-add, the
  centroids re-normalized each round; empty clusters are re-seeded from
  the rows worst served by their centroid. k-means++ seeds are drawn with
  the Gumbel-max trick, so they differ from the reference's
  `jax.random.categorical` draws; `init="random"` draws its rows with
  numpy and picks the same rows in both packages.
- **Layout**: rows sorted by cluster (best affinity first) and packed
  into fixed-size slabs of `slab_rows`; a cut row moves to its second-
  best cluster's slack, else to a spill segment that every query scans.
  int8 slabs hold ONE corpus-wide scale and round their rows up to a
  power-of-two multiple of 128 (the probe-major scan's tile). Optional
  bf16 rescore copy, or the two-level residual codes (capacity mode).
- **Query, probe-major** (`device_searcher`, int8 + rescore data + slab
  rows a multiple of 128): coarse scores -> nprobe lists per query ->
  the batch's unique probed chunks plus every spill chunk -> kernel B6
  (`kernels/mips.py:ivf_probe_scores`) scores each unique chunk once for
  the whole batch -> exact selection -> dual-assignment dedupe -> rescore
  on the device. **Query, gather** (any other index): per-query slab
  gather, f32 scores, the spill scan, optional rescore, all torch ops.

Arrays are held as CPU tensors (bf16 as torch.bfloat16); `device` is
where the index's searches run and its device copies live. The on-disk
format is the reference's (`ivf.npz` with `raw_flat` as uint16, and
`manifest.json`), so an index saved by either package loads in the other.
Live updates: `with_updates` places added rows in their nearest existing
lists and kills removed ones, `remap_ids` renumbers (the engine's compact
and reclaim); both return a new index whose device copies are uploaded
afresh, through a side stream.

Under a mesh (`sharded_searcher`, the reference's `ivf.py:830-960`): shard
s owns lists [s * L_per, (s + 1) * L_per) and spill chunks s::n_shards,
re-indexed into a local chunk space of L_per + sp_per + 1 chunks (the
last one empty), on its device. A batch's probes are computed once; each
shard scans the probed lists it owns and its spill chunks (kernel B6),
selects and rescores locally; the per-shard top-k lists are merged on
the mesh's first device with a cross-shard dedupe (a dual-assignment copy
and its primary can live on different shards). On a row split over
processes each process places and scans its own shards, and the lists
are all-gathered over the mesh's row group before the merge.
"""

from __future__ import annotations

import hashlib
import json
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch

from ..core.config import IndexConfig
from ..eval.metrics import recall_vs_exact
from ..eval.oracle import exact_topk
from ..kernels.mips import NEG_INF, ivf_probe_scores, residual_rows
from ..utils.device import resolve_device, tf32_off, upload_into
from .flat import PAD_ID, l2_normalize_rows
from .quant import quantize_global_int8, quantize_residual_int8

_CHUNK_ROWS = 262_144


def _fingerprint(x: np.ndarray, sample: int = 4096) -> str:
    """Content fingerprint of an embedding matrix: blake2s over a
    deterministic row sample (+ shape). Checkpoint keys include it, so a
    same-shape corpus with other contents never reuses a stale k-means or
    assignment checkpoint."""
    step = max(1, x.shape[0] // sample)
    h = hashlib.blake2s(np.ascontiguousarray(x[::step]).tobytes(), digest_size=12)
    return f"{x.shape[0]}x{x.shape[1]}-{h.hexdigest()}"


def _topk_stable(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """`jax.lax.top_k` order: the k largest along dim 1, descending, the
    lower index first among equals (a stable descending sort)."""
    s, i = torch.sort(x, dim=1, descending=True, stable=True)
    return s[:, :k], i[:, :k]


def unique_fixed(flat: torch.Tensor, size: int, fill_value: int) -> torch.Tensor:
    """`jnp.unique(flat, size=size, fill_value=fill_value)` for a fill
    value >= every element, with a fixed output size and no host sync:
    sort, turn each element equal to its predecessor into the fill value,
    sort again, keep the first `size`."""
    s = torch.sort(flat.reshape(-1)).values
    dup = torch.zeros_like(s, dtype=torch.bool)
    dup[1:] = s[1:] == s[:-1]
    s = torch.sort(torch.where(dup, torch.full_like(s, fill_value), s)).values
    if s.shape[0] < size:
        s = torch.cat([s, torch.full((size - s.shape[0],), fill_value, dtype=s.dtype, device=s.device)])
    return s[:size]


# ---------------------------------------------------------------------------
# spherical k-means (device)
# ---------------------------------------------------------------------------


def _kmeanspp_init(x: torch.Tensor, generator: torch.Generator, *, nlist: int) -> torch.Tensor:
    """k-means++ (D^2-weighted) seeding on the device: one (N,) product
    and one draw per seed, with no host sync. Each draw is Gumbel-max
    over the logits 2 log(cosine distance to the nearest seed)."""
    n = x.shape[0]
    dev = x.device
    out = torch.empty(nlist, dtype=torch.long, device=dev)
    idx = torch.randint(0, n, (1,), generator=generator, device=dev)
    out[:1] = idx
    with tf32_off():
        mind = 1.0 - (x @ x[idx].T)[:, 0]
        for j in range(1, nlist):
            u = torch.rand(n, generator=generator, device=dev)
            logits = 2.0 * torch.log(torch.clamp(mind, min=1e-12)) - torch.log(-torch.log(u))
            idx = torch.argmax(logits).view(1)
            out[j : j + 1] = idx
            mind = torch.minimum(mind, 1.0 - (x @ x[idx].T)[:, 0])
    return out


def _kmeans_device(x: torch.Tensor, cents: torch.Tensor, *, nlist: int, iters: int) -> torch.Tensor:
    """x: (N, D) L2-normalized f32; cents: (nlist, D). Returns the
    normalized centroids after `iters` Lloyd rounds. The scatter-add sums
    on CUDA run in an order that changes from run to run, so centroids
    agree with the reference to a tolerance, not bit for bit."""
    n, d = x.shape
    ones = torch.ones(n, device=x.device)
    with tf32_off():
        for _ in range(iters):
            best, assign = (x @ cents.T).max(dim=1)          # first max, as jnp.argmax
            sums = torch.zeros((nlist, d), device=x.device).index_add_(0, assign, x)
            counts = torch.zeros(nlist, device=x.device).index_add_(0, assign, ones)
            new = sums / torch.clamp(counts, min=1.0)[:, None]
            new = new / torch.clamp(new.norm(dim=1, keepdim=True), min=1e-12)
            # re-seed empty clusters with the rows least well represented
            worst = torch.argsort(best, stable=True)[:nlist]
            cents = torch.where((counts < 0.5)[:, None], x[worst], new)
    return cents


def train_kmeans(
    embeddings,
    nlist: int,
    iters: int = 25,
    seed: int = 0,
    sample: int | None = 262_144,
    init: str = "kmeans++",
    checkpoint_dir: str | Path | None = None,
    ckpt_every: int = 5,
    device=None,
) -> np.ndarray:
    """Train on a sample (k-means quality saturates well below full N),
    on `device` (default: the card). Returns (nlist, D) f32 centroids.

    init: "kmeans++" (D^2 seeding) or "random" (uniform rows).
    checkpoint_dir: centroids persist every `ckpt_every` rounds to
    `kmeans_ckpt.npz` (the reference's file and key) and a restarted
    build resumes from the last saved round; a different corpus or config
    ignores a stale file."""
    dev = resolve_device(device)
    x = np.asarray(embeddings, np.float32)
    rng = np.random.default_rng(seed)
    if sample is not None and x.shape[0] > sample:
        x = x[rng.choice(x.shape[0], sample, replace=False)]
    ckpt_path = None
    ckpt_key = (
        f"n{x.shape[0]}_d{x.shape[1]}_l{nlist}_i{iters}_s{seed}_{init}"
        f"_{_fingerprint(x)}"
    )
    iters_done = 0
    cents = None
    if checkpoint_dir is not None:
        ckpt_path = Path(checkpoint_dir) / "kmeans_ckpt.npz"
        if ckpt_path.exists():
            try:
                z = np.load(ckpt_path, allow_pickle=False)
                if str(z["key"]) == ckpt_key:
                    cents = torch.from_numpy(np.asarray(z["centroids"], np.float32)).to(dev)
                    iters_done = int(z["iters_done"])
            except Exception:  # noqa: BLE001 - corrupt checkpoint = cold start
                pass
    xd = torch.tensor(x, device=dev)
    if cents is None:
        if init == "kmeans++":
            gen = torch.Generator(device=dev).manual_seed(seed)
            init_idx = _kmeanspp_init(xd, gen, nlist=nlist)
        else:
            init_idx = torch.from_numpy(rng.choice(x.shape[0], nlist, replace=False)).to(dev)
        cents = xd[init_idx]
    while iters_done < iters:
        step_iters = min(ckpt_every if ckpt_path is not None else iters, iters - iters_done)
        cents = _kmeans_device(xd, cents, nlist=nlist, iters=step_iters)
        iters_done += step_iters
        if ckpt_path is not None:
            ckpt_path.parent.mkdir(parents=True, exist_ok=True)
            tmp = ckpt_path.with_suffix(".tmp.npz")
            np.savez(tmp, key=ckpt_key, centroids=cents.cpu().numpy(), iters_done=iters_done)
            tmp.replace(ckpt_path)
    return cents.cpu().numpy()


def _assign_top2(emb: torch.Tensor, cents: np.ndarray, margin: float, dev):
    """Top-2 centroid of every row, on the device in row chunks (f32, TF32
    off): (assign, assign2, v1, margin_ok) numpy. Ties go to the lower
    centroid, as `jax.lax.top_k`."""
    n = emb.shape[0]
    nlist = cents.shape[0]
    assign = np.empty(n, np.int32)
    assign2 = np.full(n, -1, np.int32)
    v1 = np.zeros(n, np.float32)
    margin_ok = np.zeros(n, bool)
    cents_d = torch.from_numpy(cents).to(dev)
    with tf32_off():
        for i in range(0, n, _CHUNK_ROWS):
            sc = emb[i : i + _CHUNK_ROWS].to(dev) @ cents_d.T
            b1, i1 = sc.max(dim=1)
            assign[i : i + _CHUNK_ROWS] = i1.cpu().numpy()
            if nlist > 1:
                sc.scatter_(1, i1[:, None], NEG_INF)
                b2, i2 = sc.max(dim=1)
                v1[i : i + _CHUNK_ROWS] = b1.cpu().numpy()
                assign2[i : i + _CHUNK_ROWS] = i2.cpu().numpy()
                margin_ok[i : i + _CHUNK_ROWS] = (b2 >= b1 - margin).cpu().numpy()
    return assign, assign2, v1, margin_ok


def _to_tensor(x) -> torch.Tensor | None:
    return None if x is None else torch.from_numpy(np.ascontiguousarray(x))


# ---------------------------------------------------------------------------
# index
# ---------------------------------------------------------------------------


@dataclass
class IVFIndex:
    centroids: torch.Tensor        # (L, D) f32, unit rows
    slabs: torch.Tensor            # (L, slab_rows, D) int8 (or f32) packed clusters
    slab_scales: torch.Tensor      # (L, slab_rows) f32 (int8: the global scale; ones otherwise)
    slab_ids: torch.Tensor         # (L, slab_rows) int32 doc ids, PAD_ID padding
    spill: torch.Tensor            # (S, D) overflow rows (always scanned), S % slab_rows == 0
    spill_scales: torch.Tensor     # (S,)
    spill_ids: torch.Tensor        # (S,) int32
    num_rows: int
    config: IndexConfig
    # optional bf16 rescore copy at flat positions [slabs.reshape(-1), spill]
    raw_flat: torch.Tensor | None = None          # (L*R + S, D) bf16
    # capacity mode (config.residual): per-row int8 codes of the residual
    # x - gscale*codes at the same flat positions
    res_flat: torch.Tensor | None = None          # (L*R + S, D) int8
    res_scales_flat: torch.Tensor | None = None   # (L*R + S,) f32
    # int8 slabs use ONE corpus-wide scale: raw int32 scores rank directly
    global_scale: float = 0.0
    # where searches run and the device copies live (None: the card)
    device: torch.device | None = None
    _dev_cache: dict | None = field(default=None, repr=False, compare=False)
    _sharded_cache: tuple | None = field(default=None, repr=False, compare=False)

    def __post_init__(self) -> None:
        self.device = resolve_device(self.device)

    # ---------------- build ----------------

    @classmethod
    def build(
        cls,
        embeddings,
        ids=None,
        config: IndexConfig | None = None,
        slab_rows: int | None = None,
        normalize: bool = True,
        rescore: bool | None = None,
        checkpoint_dir: str | Path | None = None,
        device=None,
    ) -> "IVFIndex":
        """k-means and the top-2 assignment run on `device` (default: the
        card; "cpu" for a CPU run), the packing on the host.
        checkpoint_dir: the two device stages persist their outputs there
        (`kmeans_ckpt.npz`, `assign_ckpt.npz`) and a restarted build
        resumes past them; the packing always re-runs."""
        dev = resolve_device(device)
        emb = embeddings
        if isinstance(emb, np.ndarray):
            emb = np.ascontiguousarray(emb, dtype=np.float32)
            emb = torch.from_numpy(emb if emb.flags.writeable else emb.copy())
        emb = emb.cpu().float()
        n, d = emb.shape
        cfg = (config or IndexConfig(ivf_nlist=max(1, n // 256))).replace(dim=d)
        if cfg.ivf_nlist <= 0:
            raise ValueError("IndexConfig.ivf_nlist must be > 0 for IVF")
        ids = np.arange(n, dtype=np.int64) if ids is None else np.asarray(ids, np.int64)
        ids = ids.astype(np.int32)
        if normalize:
            emb = l2_normalize_rows(emb, dev)
        emb_np = emb.numpy()

        nlist = min(cfg.ivf_nlist, n)
        cents = train_kmeans(
            emb_np, nlist, iters=cfg.kmeans_iters, seed=cfg.seed, init=cfg.kmeans_init,
            checkpoint_dir=checkpoint_dir, device=dev,
        )

        # top-2 assignment: the 2nd-best cluster is the overflow
        # relocation target; the margin also gates dual-assignment copies
        margin = float(cfg.ivf_assign2_margin)
        assign_key = f"n{n}_d{d}_l{nlist}_m{margin}_{_fingerprint(emb_np)}_{_fingerprint(cents)}"
        assign_path = Path(checkpoint_dir) / "assign_ckpt.npz" if checkpoint_dir else None
        assign = None
        if assign_path is not None and assign_path.exists():
            try:
                z = np.load(assign_path, allow_pickle=False)
                if str(z["key"]) == assign_key:
                    assign, assign2, v1, margin_ok = z["assign"], z["assign2"], z["v1"], z["margin_ok"]
            except Exception:  # noqa: BLE001
                assign = None
        if assign is None:
            assign, assign2, v1, margin_ok = _assign_top2(emb, cents, margin, dev)
            if assign_path is not None:
                tmp = assign_path.with_suffix(".tmp.npz")
                np.savez(tmp, key=assign_key, assign=assign, assign2=assign2, v1=v1,
                         margin_ok=margin_ok)
                tmp.replace(assign_path)

        sizes = np.bincount(assign, minlength=nlist)
        int8 = cfg.dtype == "int8"
        if slab_rows is None:
            # p99 cluster size; int8 slabs round UP to a power-of-two
            # multiple of 128 (the probe-major scan's tile)
            slab_rows = int(np.percentile(sizes, 99))
            if int8:
                r = 128
                while r < slab_rows:
                    r *= 2
                slab_rows = r
            else:
                slab_rows = max(32, ((slab_rows + 31) // 32) * 32)
        if rescore is None:
            rescore = int8
        residual = bool(cfg.residual)
        if residual and not int8:
            raise ValueError("config.residual requires dtype='int8' for IVF")
        global_scale = 0.0
        rc = rs = None
        if int8:
            codes_d, global_scale = quantize_global_int8(emb, device=dev)
            if residual:
                rc, rs = quantize_residual_int8(emb, codes_d, global_scale)
                rc, rs = rc.cpu().numpy(), rs.cpu().numpy()
            codes = codes_d.cpu().numpy()
            del codes_d
            scales = np.full(n, global_scale, np.float32)
        else:
            codes, scales = emb_np, np.ones(n, np.float32)

        slab_lists, spill_rows = _pack_lists(assign, assign2, v1, margin_ok, nlist, slab_rows, margin)

        # flat source row of every slab and spill position (-1 = padding);
        # the spill pads to a multiple of slab_rows, or one empty chunk
        src = np.full(nlist * slab_rows, -1, np.int64)
        for c, members in enumerate(slab_lists):
            src[c * slab_rows : c * slab_rows + len(members)] = members
        sp = np.asarray(spill_rows, np.int64)
        s_pad = (-len(sp)) % slab_rows if len(sp) else slab_rows
        src = np.concatenate([src, sp, np.full(s_pad, -1, np.int64)])
        fill = src >= 0
        pos, rows = np.nonzero(fill)[0], src[fill]

        flat_codes = np.zeros((src.shape[0], d), codes.dtype)
        flat_codes[pos] = codes[rows]
        flat_scales = np.zeros(src.shape[0], np.float32)
        flat_scales[pos] = scales[rows]
        flat_ids = np.full(src.shape[0], PAD_ID, np.int32)
        flat_ids[pos] = ids[rows]
        n_slab = nlist * slab_rows

        raw_flat = res_flat = res_scales_flat = None
        if residual:
            res_flat = np.zeros((src.shape[0], d), np.int8)
            res_flat[pos] = rc[rows]
            res_scales_flat = np.zeros(src.shape[0], np.float32)
            res_scales_flat[pos] = rs[rows]
            res_flat, res_scales_flat = _to_tensor(res_flat), _to_tensor(res_scales_flat)
        elif rescore:
            # residual replaces the bf16 copy; bf16 rounds to nearest even
            raw_flat = torch.zeros((src.shape[0], d), dtype=torch.bfloat16)
            for j in range(0, len(pos), _CHUNK_ROWS):
                p_ = torch.from_numpy(pos[j : j + _CHUNK_ROWS])
                raw_flat[p_] = emb[torch.from_numpy(rows[j : j + _CHUNK_ROWS])].to(torch.bfloat16)

        return cls(
            centroids=_to_tensor(cents),
            slabs=_to_tensor(flat_codes[:n_slab].reshape(nlist, slab_rows, d)),
            slab_scales=_to_tensor(flat_scales[:n_slab].reshape(nlist, slab_rows)),
            slab_ids=_to_tensor(flat_ids[:n_slab].reshape(nlist, slab_rows)),
            spill=_to_tensor(flat_codes[n_slab:]),
            spill_scales=_to_tensor(flat_scales[n_slab:]),
            spill_ids=_to_tensor(flat_ids[n_slab:]),
            num_rows=n,
            config=cfg.replace(ivf_nlist=nlist),
            raw_flat=raw_flat,
            res_flat=res_flat,
            res_scales_flat=res_scales_flat,
            global_scale=global_scale,
            device=dev,
        )

    # ---------------- incremental updates ----------------

    def _host_arrays(self) -> dict:
        """Writable numpy copies of the packed arrays; bf16 rescore rows
        as their uint16 bit patterns."""
        out = {name: getattr(self, name).numpy().copy() for name in (
            "slabs", "slab_scales", "slab_ids", "spill", "spill_scales", "spill_ids")}
        if self.raw_flat is not None:
            out["raw_flat"] = self.raw_flat.view(torch.int16).numpy().view(np.uint16).copy()
        if self.res_flat is not None:
            out["res_flat"] = self.res_flat.numpy().copy()
            out["res_scales_flat"] = self.res_scales_flat.numpy().copy()
        return out

    def _from_host_arrays(self, a: dict, num_rows: int) -> "IVFIndex":
        raw = a.get("raw_flat")
        return IVFIndex(
            centroids=self.centroids,
            slabs=_to_tensor(a["slabs"]), slab_scales=_to_tensor(a["slab_scales"]),
            slab_ids=_to_tensor(a["slab_ids"]), spill=_to_tensor(a["spill"]),
            spill_scales=_to_tensor(a["spill_scales"]), spill_ids=_to_tensor(a["spill_ids"]),
            num_rows=num_rows, config=self.config,
            raw_flat=None if raw is None else torch.from_numpy(raw.view(np.int16)).view(torch.bfloat16),
            res_flat=_to_tensor(a.get("res_flat")), res_scales_flat=_to_tensor(a.get("res_scales_flat")),
            global_scale=self.global_scale, device=self.device,
        )

    def with_updates(self, add_emb=None, add_ids=None, remove_ids=None) -> "IVFIndex":
        """A new index with `remove_ids` rows dead (every copy, dual
        assignments included: ids -> PAD_ID, codes zeroed) and `add_emb`
        rows assigned to their nearest existing centroids: the best
        list's slack first, then the second best's, then the spill that
        every query scans. Centroids are not retrained (the engine's
        compact fold). add_emb: L2-normalized f32 rows; int8 indexes
        quantize them with the existing global scale (an f32 divide,
        round half to even, as the build does)."""
        int8 = self.config.dtype == "int8"
        a = self._host_arrays()
        L, R, D = a["slabs"].shape
        flat_names = [n for n in ("raw_flat", "res_flat", "res_scales_flat") if n in a]
        # slab and spill views of the flat rescore arrays ([slabs, spill])
        slab_v = {n: a[n][: L * R].reshape(L, R, *a[n].shape[1:]) for n in flat_names}
        spill_v = {n: a[n][L * R :] for n in flat_names}
        slab_ids, spill_ids = a["slab_ids"], a["spill_ids"]

        n_removed = 0
        if remove_ids is not None and len(np.atleast_1d(remove_ids)):
            rm_ids = np.asarray(remove_ids, np.int64).astype(np.int32)
            present = set(slab_ids[np.isin(slab_ids, rm_ids)].tolist())
            present |= set(spill_ids[np.isin(spill_ids, rm_ids)].tolist())
            n_removed = len(present)
            rm = np.isin(slab_ids, rm_ids)
            rms = np.isin(spill_ids, rm_ids)
            slab_ids[rm] = PAD_ID
            spill_ids[rms] = PAD_ID
            for n in ("slabs", "slab_scales"):
                a[n][rm] = 0
            for n in ("spill", "spill_scales"):
                a[n][rms] = 0
            for n in flat_names:
                slab_v[n][rm] = 0
                spill_v[n][rms] = 0

        m = 0 if add_emb is None else int(np.asarray(add_emb).shape[0])
        if m:
            emb = np.array(add_emb, np.float32)
            ids_new = np.asarray(add_ids, np.int64).astype(np.int32)
            if ids_new.shape != (m,):
                raise ValueError("add_ids must be (m,)")
            rows = {}
            if int8:
                g = np.float32(self.global_scale)
                rows["codes"] = np.clip(np.round(emb / g), -127, 127).astype(np.int8)
                rows["scales"] = np.full(m, g, np.float32)
                if "res_flat" in a:
                    rc, rs = quantize_residual_int8(torch.from_numpy(emb),
                                                    torch.from_numpy(rows["codes"]), float(g))
                    rows["res_flat"], rows["res_scales_flat"] = rc.numpy(), rs.numpy()
            else:
                rows["codes"] = emb.astype(a["slabs"].dtype)
                rows["scales"] = np.ones(m, np.float32)
            if "raw_flat" in a:
                rows["raw_flat"] = torch.from_numpy(emb).to(torch.bfloat16).view(
                    torch.int16).numpy().view(np.uint16)
            cents = self.centroids.numpy()
            sc = emb @ cents.T
            if cents.shape[0] > 1:
                top2 = np.argpartition(-sc, 1, axis=1)[:, :2]
                swap = (np.take_along_axis(sc, top2[:, :1], 1)[:, 0]
                        < np.take_along_axis(sc, top2[:, 1:2], 1)[:, 0])
                top2[swap] = top2[swap][:, ::-1]
            else:
                top2 = np.zeros((m, 2), np.int64)
            # free-slot cursors per involved list (slack = PAD rows,
            # rows freed by the removal above included)
            free: dict[int, list[int]] = {}
            spill_add: list[int] = []
            for j in range(m):
                for c in (int(top2[j, 0]), int(top2[j, 1])):
                    if c not in free:
                        free[c] = np.nonzero(slab_ids[c] == PAD_ID)[0].tolist()[::-1]
                    if free[c]:
                        r = free[c].pop()
                        a["slabs"][c, r] = rows["codes"][j]
                        a["slab_scales"][c, r] = rows["scales"][j]
                        slab_ids[c, r] = ids_new[j]
                        for n in flat_names:
                            slab_v[n][c, r] = rows[n][j]
                        break
                else:
                    spill_add.append(j)
            if spill_add:
                # append after the spill's last real row, reusing its PAD
                # tail first, then growing in R-row chunks
                sa = np.asarray(spill_add, np.int64)
                tail = np.nonzero(spill_ids != PAD_ID)[0]
                start = int(tail[-1]) + 1 if tail.size else 0
                need = start + len(sa)
                grow = max(len(spill_ids), -(-need // R) * R) - len(spill_ids)
                if grow:
                    for n in ("spill", "spill_scales", "spill_ids") + tuple(flat_names):
                        src = a[n] if n in ("spill", "spill_scales", "spill_ids") else spill_v[n]
                        fill = PAD_ID if n == "spill_ids" else 0
                        grown = np.concatenate(
                            [src, np.full((grow, *src.shape[1:]), fill, src.dtype)])
                        if n in flat_names:
                            spill_v[n] = grown
                        else:
                            a[n] = grown
                    spill_ids = a["spill_ids"]
                a["spill"][start:need] = rows["codes"][sa]
                a["spill_scales"][start:need] = rows["scales"][sa]
                spill_ids[start:need] = ids_new[sa]
                for n in flat_names:
                    spill_v[n][start:need] = rows[n][sa]
        for n in flat_names:
            a[n] = np.concatenate([slab_v[n].reshape(L * R, *slab_v[n].shape[2:]), spill_v[n]])
        return self._from_host_arrays(a, self.num_rows - n_removed + m)

    def remap_ids(self, id_map) -> "IVFIndex":
        """A new index with every doc id translated through `id_map` (old
        id -> new id, -1 = dropped; ids beyond the map are dropped).
        Dropped rows become PAD slack with zeroed codes (the engine's
        compact(reclaim=True) renumbering)."""
        id_map = np.asarray(id_map, np.int64)
        a = self._host_arrays()

        def _remap(ids: np.ndarray) -> np.ndarray:
            safe = np.clip(ids, 0, len(id_map) - 1)
            return np.where((ids >= 0) & (ids < len(id_map)), id_map[safe], PAD_ID).astype(np.int32)

        slab_ids, spill_ids = _remap(a["slab_ids"]), _remap(a["spill_ids"])
        dead_s = (slab_ids == PAD_ID) & (a["slab_ids"] != PAD_ID)
        dead_p = (spill_ids == PAD_ID) & (a["spill_ids"] != PAD_ID)
        a["slab_ids"], a["spill_ids"] = slab_ids, spill_ids
        a["slabs"][dead_s] = 0
        a["slab_scales"][dead_s] = 0
        a["spill"][dead_p] = 0
        a["spill_scales"][dead_p] = 0
        dead_flat = np.concatenate([dead_s.reshape(-1), dead_p])
        for n in ("raw_flat", "res_flat", "res_scales_flat"):
            if n in a:
                a[n][dead_flat] = 0
        # distinct live docs (dual-assignment copies collapse)
        all_ids = np.concatenate([slab_ids.ravel(), spill_ids])
        return self._from_host_arrays(a, int(np.unique(all_ids[all_ids != PAD_ID]).size))

    # ---------------- search ----------------

    @property
    def has_rescore(self) -> bool:
        """True when exact rescoring data exists (bf16 copy or two-level
        residual codes)."""
        return self.raw_flat is not None or self.res_flat is not None

    @property
    def probe_major_ok(self) -> bool:
        """The probe-major route's conditions: int8 slabs, rescore data,
        slab rows a multiple of 128."""
        return self.config.dtype == "int8" and self.has_rescore and self.slabs.shape[1] % 128 == 0

    def _device_arrays(self) -> dict:
        """The index on its device, once: slabs + spill as chunks + one
        empty fill chunk, the flat id table, the rescore data, the
        centroids, and the gather route's per-row tables."""
        if self._dev_cache is None:
            dev = self.device
            L, R, D = self.slabs.shape
            n_sp = self.spill.shape[0] // R
            slabs_all = torch.zeros((L + n_sp + 1, R, D), dtype=self.slabs.dtype, device=dev)
            upload_into(slabs_all[:L], self.slabs)
            upload_into(slabs_all[L : L + n_sp], self.spill.reshape(n_sp, R, D))
            ids_flat = torch.cat([self.slab_ids.reshape(-1), self.spill_ids,
                                  torch.full((R,), PAD_ID, dtype=torch.int32)])

            def put(t):
                if t is None:
                    return None
                return upload_into(torch.empty(tuple(t.shape), dtype=t.dtype, device=dev), t)

            self._dev_cache = {
                "slabs": slabs_all,
                "ids_flat": ids_flat.to(dev),
                "raw": put(self.raw_flat),
                "res": put(self.res_flat),
                "res_scales": put(self.res_scales_flat),
                "cents": put(self.centroids.float()),
                "slab_scales": put(self.slab_scales),
                "slab_ids": put(self.slab_ids),
                "spill_scales": put(self.spill_scales),
                "spill_ids": put(self.spill_ids),
                "n_spill_chunks": n_sp,
            }
        return self._dev_cache

    def _queries(self, queries) -> torch.Tensor:
        q = queries if isinstance(queries, torch.Tensor) else torch.tensor(
            np.asarray(queries, np.float32))
        q = q.to(self.device, torch.float32)
        return q[None] if q.ndim == 1 else q

    def search(
        self,
        queries,
        k: int = 10,
        nprobe: int | None = None,
        query_chunk: int = 64,
        rescore_factor: int = 4,
        probe_major: bool | None = None,
    ) -> tuple[np.ndarray, np.ndarray]:
        """(scores, doc_ids) numpy, each (B, k). nprobe trades recall for
        speed. With rescore data, `rescore_factor * k` candidates are
        rescored exactly.

        probe_major: the kernel route (`device_searcher`); None picks it
        for every index that qualifies (`probe_major_ok`), on any device:
        the plain B6 on the CPU, the kernel on the card. False takes the
        gather route. Queries run in chunks of `query_chunk`, the tail
        padded with zero rows, as the reference does (a zero query probes
        lists 0..nprobe-1, which every query of its chunk then sees)."""
        nprobe = min(int(nprobe or self.config.ivf_nprobe), self.centroids.shape[0])
        q = self._queries(queries)
        if probe_major is None:
            probe_major = self.probe_major_ok
        if probe_major:
            fn = self.device_searcher(k=k, nprobe=nprobe, rescore_factor=rescore_factor)
        else:
            pa = self._device_arrays()
            L, R, D = self.slabs.shape
            c_rescore = min(rescore_factor * k, nprobe * R)
            slabs_all = pa["slabs"]
            args = (pa["cents"], slabs_all[:L], pa["slab_scales"], pa["slab_ids"],
                    slabs_all[L:-1].reshape(-1, D), pa["spill_scales"], pa["spill_ids"],
                    pa["raw"], pa["res"], pa["res_scales"])

            def fn(chunk):
                return _ivf_search_gather(chunk, *args, k=k, nprobe=nprobe, c_rescore=c_rescore)

        out_s, out_i = [], []
        for i in range(0, q.shape[0], query_chunk):
            chunk = q[i : i + query_chunk]
            pad = query_chunk - chunk.shape[0]
            if pad:
                chunk = torch.cat([chunk, torch.zeros((pad, q.shape[1]), device=q.device)])
            s, d_ = fn(chunk)
            out_s.append(s[: query_chunk - pad].cpu().numpy())
            out_i.append(d_[: query_chunk - pad].cpu().numpy())
        return np.concatenate(out_s), np.concatenate(out_i)

    def device_searcher(self, k: int = 10, nprobe: int | None = None, rescore_factor: int = 4):
        """Device-level search closure over the cached device arrays:
        ``(B, D) f32 -> (scores (B, k), doc_ids (B, k))`` tensors on the
        index's device, no host round trip: what the engine calls
        (`search` wraps it with numpy in and out)."""
        if not self.probe_major_ok:
            raise ValueError(
                "the probe-major IVF route needs int8 + rescore data (bf16 copy or "
                "residual codes) + slab_rows a multiple of 128"
            )
        R = self.slabs.shape[1]
        nprobe = min(int(nprobe or self.config.ivf_nprobe), self.centroids.shape[0])
        pa = self._device_arrays()
        gscale = self.global_scale
        n_lists = self.slabs.shape[0]
        c_rescore = max(k, min(rescore_factor * k, nprobe * R))

        def fn(q):
            return _ivf_search_probe_major(
                self._queries(q), pa["cents"], pa["slabs"], pa["ids_flat"], pa["raw"],
                pa["res"], pa["res_scales"], gscale,
                k=k, nprobe=nprobe, c_rescore=c_rescore, n_lists=n_lists,
                n_spill_chunks=pa["n_spill_chunks"],
            )

        return fn

    # ---------------- multi-device ----------------

    def _sharded_arrays(self, n_shards: int) -> dict:
        """Partition the lists and spill chunks over shards (host side):
        shard s owns lists [s * L_per, (s + 1) * L_per) and spill chunks
        s::n_shards, re-indexed into a local chunk space of C_local =
        L_per + sp_per + 1 chunks (the last one empty). Global list g maps
        to (owner g // L_per, local g % L_per) with no lookup table. Per
        shard: slabs (C_local, R, D), flat ids (C_local * R,) and the
        rescore rows at the same flat positions."""
        L, R, D = self.slabs.shape
        L_per = (L + n_shards - 1) // n_shards
        spill_chunks = self.spill.reshape(-1, R, D)
        spill_ids_c = self.spill_ids.reshape(-1, R)
        n_sp = spill_chunks.shape[0]
        sp_per = (n_sp + n_shards - 1) // n_shards
        C_local = L_per + sp_per + 1
        flat_rows = {"raw": self.raw_flat, "res": self.res_flat, "res_scales": self.res_scales_flat}
        shards = []
        for s in range(n_shards):
            lists = torch.arange(L)[s * L_per : (s + 1) * L_per]
            spills = torch.arange(n_sp)[s::n_shards]
            slabs = torch.zeros((C_local, R, D), dtype=self.slabs.dtype)
            ids = torch.full((C_local, R), PAD_ID, dtype=torch.int32)
            slabs[: len(lists)] = self.slabs[lists]
            ids[: len(lists)] = self.slab_ids[lists]
            slabs[L_per : L_per + len(spills)] = spill_chunks[spills]
            ids[L_per : L_per + len(spills)] = spill_ids_c[spills]
            # flat positions of the owned chunks in the global [slabs, spill] order
            src = torch.cat([lists, L + spills])
            dst = torch.cat([torch.arange(len(lists)), L_per + torch.arange(len(spills))])
            src_rows = (src[:, None] * R + torch.arange(R)).reshape(-1)
            dst_rows = (dst[:, None] * R + torch.arange(R)).reshape(-1)
            sh = {"slabs": slabs, "ids": ids.reshape(-1)}
            for name, t in flat_rows.items():
                if t is not None:
                    out = torch.zeros((C_local * R, *t.shape[1:]), dtype=t.dtype)
                    out[dst_rows] = t[src_rows]
                    sh[name] = out
                else:
                    sh[name] = None
            shards.append(sh)
        return {"shards": shards, "L_per": L_per, "sp_per": sp_per, "C_local": C_local}

    def sharded_searcher(self, mesh, k: int = 10, nprobe: int | None = None,
                         rescore_factor: int = 4):
        """Search closure over a mesh's shard axis: ``(B, D) f32 ->
        (scores (B, k), doc_ids (B, k))`` tensors on the mesh's first
        device. The probes are computed once; every shard scans the probed
        lists it owns plus its spill chunks with kernel B6, selects its
        c_rescore best candidates exactly, rescores them against its own
        rescore rows and keeps its k best; the per-shard lists are merged
        with a cross-shard dedupe. The device arrays are placed once per
        mesh layout and shared by the searchers of every k."""
        if not self.probe_major_ok:
            raise ValueError("sharded IVF needs int8 + rescore data + slab_rows % 128 == 0")
        from ..core.meshes import gather_shard_lists
        from ..kernels.mips import merge_topk

        R = self.slabs.shape[1]
        mine = mesh.local_shards
        dev0 = mesh.first_device
        nprobe = min(int(nprobe or self.config.ivf_nprobe), self.centroids.shape[0])
        key = (tuple(str(d) for d in mesh.devices.flat), tuple(mesh.shape.items()),
               mesh.process_index)
        if self._sharded_cache is None or self._sharded_cache[0] != key:
            sa = self._sharded_arrays(mesh.shape[mesh.axis_names[1]])

            def put(t, dev):
                if t is None:
                    return None
                return upload_into(torch.empty(tuple(t.shape), dtype=t.dtype, device=dev), t)

            placed = [{name: put(t, dev) for name, t in sa["shards"][s].items()}
                      for s, dev in mine]
            cents = upload_into(torch.empty(tuple(self.centroids.shape), device=dev0),
                                self.centroids.float())
            self._sharded_cache = (key, {"shards": placed, "cents": cents, "L_per": sa["L_per"],
                                         "sp_per": sa["sp_per"], "C_local": sa["C_local"]})
        dc = self._sharded_cache[1]
        L_per, sp_per, C_local = dc["L_per"], dc["sp_per"], dc["C_local"]
        gscale = self.global_scale
        c_rescore = max(k, min(rescore_factor * k, nprobe * R))

        def fn(q):
            q = self._queries(q).to(dev0)
            b = q.shape[0]
            with tf32_off():
                _, probe = _topk_stable(q @ dc["cents"].T, nprobe)            # global list ids
            owner, local = probe // L_per, probe % L_per
            p_max = min(b * nprobe, L_per) + sp_per + 1                       # +1: the empty chunk
            lists = []
            for (s, dev), sh in zip(mine, dc["shards"]):
                flat = torch.where(owner == s, local, C_local - 1).reshape(-1)
                always = torch.arange(L_per, L_per + sp_per, device=dev0)
                uids = unique_fixed(torch.cat([flat, always]), p_max, C_local - 1).to(torch.int32)
                top_s, top_i = _probe_major_tail(
                    q.to(dev, non_blocking=True), uids.to(dev, non_blocking=True), sh["slabs"],
                    sh["ids"], sh["raw"], sh["res"], sh["res_scales"], gscale,
                    k=k, c_rescore=c_rescore)
                lists.append((top_s.to(dev0, non_blocking=True), top_i.to(dev0, non_blocking=True)))
            # every shard's list in global order (over the mesh's row group
            # when the row spans processes), then the merge, with the
            # cross-shard dedupe of dual-assignment copies
            lists = gather_shard_lists(mesh, lists, b, k, dev0)
            all_s = torch.cat([e[0] for e in lists], dim=1)
            all_i = torch.cat([e[1] for e in lists], dim=1)
            s2, sel = _topk_stable(all_s, all_s.shape[1])
            i2 = torch.gather(all_i, 1, sel)
            s2 = torch.where((i2 >= 0) & ~_first_dup(i2), s2, NEG_INF)
            top_s, top_i = merge_topk(s2, torch.where(torch.isfinite(s2), i2, PAD_ID), k)
            return top_s, torch.where(torch.isfinite(top_s), top_i, PAD_ID)

        return fn

    # ---------------- persistence ----------------

    def save(self, path: str | Path) -> None:
        path = Path(path)
        path.mkdir(parents=True, exist_ok=True)
        arrays = dict(
            centroids=self.centroids.numpy(),
            slabs=self.slabs.numpy(),
            slab_scales=self.slab_scales.numpy(),
            slab_ids=self.slab_ids.numpy(),
            spill=self.spill.numpy(),
            spill_scales=self.spill_scales.numpy(),
            spill_ids=self.spill_ids.numpy(),
        )
        if self.raw_flat is not None:
            arrays["raw_flat"] = self.raw_flat.view(torch.int16).numpy().view(np.uint16)
        if self.res_flat is not None:
            arrays["res_flat"] = self.res_flat.numpy()
            arrays["res_scales_flat"] = self.res_scales_flat.numpy()
        np.savez_compressed(path / "ivf.npz", **arrays)
        manifest = {
            "format": "ivf",
            "num_rows": self.num_rows,
            "config": self.config.to_dict(),
            "global_scale": self.global_scale,
        }
        (path / "manifest.json").write_text(json.dumps(manifest, indent=2))

    @classmethod
    def load(cls, path: str | Path, device=None) -> "IVFIndex":
        """An index saved by either package; `device` as in `build`."""
        path = Path(path)
        manifest = json.loads((path / "manifest.json").read_text())
        z = np.load(path / "ivf.npz")

        def opt(name):
            return _to_tensor(z[name]) if name in z else None

        raw = None
        if "raw_flat" in z:
            raw = torch.from_numpy(z["raw_flat"].view(np.int16)).view(torch.bfloat16)
        return cls(
            centroids=_to_tensor(z["centroids"]),
            slabs=_to_tensor(z["slabs"]),
            slab_scales=_to_tensor(z["slab_scales"]),
            slab_ids=_to_tensor(z["slab_ids"]),
            spill=_to_tensor(z["spill"]),
            spill_scales=_to_tensor(z["spill_scales"]),
            spill_ids=_to_tensor(z["spill_ids"]),
            num_rows=manifest["num_rows"],
            config=IndexConfig.from_dict(manifest["config"]),
            raw_flat=raw,
            res_flat=opt("res_flat"),
            res_scales_flat=opt("res_scales_flat"),
            global_scale=float(manifest.get("global_scale", 0.0)),
            device=resolve_device(device),
        )

    def memory_bytes(self) -> int:
        arrays = [
            self.centroids, self.slabs, self.slab_scales, self.slab_ids,
            self.spill, self.spill_scales, self.spill_ids,
        ]
        arrays += [a for a in (self.raw_flat, self.res_flat, self.res_scales_flat) if a is not None]
        return sum(a.numel() * a.element_size() for a in arrays)


def _pack_lists(assign, assign2, v1, margin_ok, nlist: int, slab_rows: int, margin: float):
    """Per-cluster member lists and the spill rows (host, the reference's
    packing verbatim). Cluster-major, best affinity first, so an
    overflowing cluster cuts its most marginal members; a cut row moves
    into its 2nd-best cluster's slack, else to the spill; with a margin,
    dual-assignment copies of boundary rows fill the remaining slack."""
    n = assign.shape[0]
    order = np.lexsort((-v1, assign))
    row_of_cluster = np.searchsorted(assign[order], np.arange(nlist))
    bounds = np.append(row_of_cluster, n)
    slab_lists: list[list[int]] = []
    overflow: list[int] = []
    for c in range(nlist):
        members = order[bounds[c] : bounds[c + 1]]
        slab_lists.append(members[:slab_rows].tolist())
        overflow.extend(members[slab_rows:].tolist())
    spill_rows: list[int] = []
    for r in overflow:
        c2 = int(assign2[r])
        if 0 <= c2 < nlist and len(slab_lists[c2]) < slab_rows:
            slab_lists[c2].append(r)
        else:
            spill_rows.append(r)
    if margin > 0:
        sec_rows = np.nonzero(margin_ok & (assign2 >= 0))[0]
        order2 = sec_rows[np.argsort(assign2[sec_rows], kind="stable")]
        row2 = np.searchsorted(assign2[order2], np.arange(nlist))
        bounds2 = np.append(row2, len(order2))
        for c in range(nlist):
            space = slab_rows - len(slab_lists[c])
            if space <= 0:
                continue
            present = set(slab_lists[c])
            for r in order2[bounds2[c] : bounds2[c + 1]]:
                if space <= 0:
                    break
                if int(r) not in present:
                    slab_lists[c].append(int(r))
                    space -= 1
    return slab_lists, spill_rows


def calibrate_nprobe(
    index: IVFIndex,
    embeddings,
    gate: float = 0.99,
    k: int = 10,
    n_queries: int = 256,
    n_draws: int = 3,
    candidates: tuple[int, ...] = (4, 8, 16, 32, 64, 128),
    perturb: float = 0.25,
    seed: int = 0,
    ids: np.ndarray | None = None,
    normalize: bool = True,
    query_batch: int = 64,
) -> tuple[int, float]:
    """Smallest nprobe whose MIN recall@k over `n_draws` query draws
    clears `gate` against the exact fp32 oracle (`eval/oracle.py:
    exact_topk`, TF32 off) on the index's device.

    The draws are searched in batches of `query_batch` queries. The
    probe-major search's recall depends on its batch (each query sees the
    lists any query of its batch probed), so calibrate at the batch the
    caller serves: `IndexBuilder.finalize_ivf` passes the engine's IVF
    batch (16). The default, 64, is the reference's chunk.

    Queries are corpus rows plus gaussian noise of relative scale
    `perturb`, re-normalized (numpy, from `seed`: the reference's draws).
    `embeddings` is numpy or a tensor (a tensor on the card keeps the
    oracle's corpus there). Returns (nprobe, min_recall); if no candidate
    clears the gate, the best candidate with its recall."""
    dev = index.device
    if isinstance(embeddings, torch.Tensor):
        emb = embeddings.float()
        if normalize:
            emb = emb / torch.clamp(emb.norm(dim=1, keepdim=True), min=1e-12)
    else:
        emb = np.asarray(embeddings, np.float32)
        if normalize:
            # must match what the index packed
            emb = emb / np.maximum(np.linalg.norm(emb, axis=1, keepdims=True), 1e-12)
    n, dim = emb.shape
    rng = np.random.default_rng(seed)

    draws = []
    for _ in range(n_draws):
        rows = rng.choice(n, size=min(n_queries, n), replace=False)
        base = emb[torch.from_numpy(rows).to(emb.device)].cpu().numpy() if isinstance(
            emb, torch.Tensor) else emb[rows]
        q = base + perturb / np.sqrt(dim) * rng.standard_normal((len(rows), dim)).astype(np.float32)
        q /= np.maximum(np.linalg.norm(q, axis=1, keepdims=True), 1e-12)
        _, top_i = exact_topk(q, emb, k=k, device=dev)
        if ids is not None:  # embeddings row -> doc id (custom-id corpora)
            top_i = np.asarray(ids)[top_i]
        draws.append((q, top_i))

    # clamp candidates at nlist (probing every list is the exhaustive
    # setting), keeping ascending order unique
    nlist = index.centroids.shape[0]
    cand_list = sorted({min(c, nlist) for c in candidates})
    best = (cand_list[0], 0.0)
    for nprobe in cand_list:
        recs = []
        for q, ref in draws:
            _, got = index.search(q, k=k, nprobe=nprobe, query_chunk=query_batch)
            recs.append(recall_vs_exact(np.asarray(got), ref, k=k))
        rec_min = min(recs)
        if rec_min > best[1]:
            best = (nprobe, rec_min)
        if rec_min >= gate:
            return nprobe, rec_min
    return best


# ---------------------------------------------------------------------------
# the two search routes
# ---------------------------------------------------------------------------


def _first_dup(doc: torch.Tensor) -> torch.Tensor:
    """(B, C) -> (B, C) bool: the entry repeats an id earlier in its row
    (a doc has at most two copies; the first is kept)."""
    c = doc.shape[1]
    earlier = torch.tril(torch.ones((c, c), dtype=torch.bool, device=doc.device), diagonal=-1)
    return ((doc[:, :, None] == doc[:, None, :]) & earlier).any(dim=2)


def _ivf_search_gather(
    q, centroids, slabs, slab_scales, slab_ids, spill, spill_scales, spill_ids,
    raw_flat, res_flat, res_scales_flat, *, k, nprobe, c_rescore,
):
    """The general route (the reference's `_ivf_search_jit`): per-query
    slab gather (B, nprobe, R, D), f32 scores, the spill scan, then either
    a dedupe over a 2k over-fetch or the exact rescore of the candidates."""
    b, d = q.shape
    L, R = slabs.shape[:2]
    with tf32_off():
        # 1. coarse quantizer, full f32: a TF32 near-tie flips the probes
        _, probe = _topk_stable(q @ centroids.T, nprobe)                    # (B, P)
        # 2. slab gather + candidate scores
        cand_sc = slab_scales[probe]                                         # (B, P, R)
        cand_id = slab_ids[probe]
        scores = torch.einsum("bprd,bd->bpr", slabs[probe].float(), q) * cand_sc
        scores = torch.where(cand_id >= 0, scores, NEG_INF)
        flat_s = scores.reshape(b, -1)
        flat_i = cand_id.reshape(b, -1)
        rr = torch.arange(R, device=q.device)
        flat_p = (probe[:, :, None] * R + rr).reshape(b, -1)
        # 3. spill scan (always exact over the overflow segment)
        n_spill = spill_ids.shape[0]
        sp_scores = (q @ spill.float().T) * spill_scales[None, :]
        sp_scores = torch.where(spill_ids[None, :] >= 0, sp_scores, NEG_INF)
        sp_pos = torch.arange(n_spill, device=q.device) + L * R
        all_s = torch.cat([flat_s, sp_scores], dim=1)
        all_i = torch.cat([flat_i, spill_ids[None, :].expand(b, -1)], dim=1)
        all_p = torch.cat([flat_p, sp_pos[None, :].expand(b, -1)], dim=1)

        if raw_flat is None and res_flat is None:
            # dual-assignment copies score identically: dedupe on a 2k
            # over-fetch (a doc has at most two copies)
            m = min(2 * k, all_s.shape[1])
            top_s, sel = _topk_stable(all_s, m)
            top_i = torch.gather(all_i, 1, sel)
            top_s = torch.where((top_i >= 0) & ~_first_dup(top_i), top_s, NEG_INF)
            top_s, sel2 = _topk_stable(top_s, k)
            top_i = torch.gather(top_i, 1, sel2)
            return top_s, torch.where(torch.isfinite(top_s), top_i, PAD_ID)

        # 4. exact rescoring of the oversampled candidates: the bf16 copy
        # (f32 query), or the two-level int8 reconstruction
        c = max(c_rescore, k)
        cand_s, sel = _topk_stable(all_s, c)
        cand_i = torch.gather(all_i, 1, sel)
        cand_p = torch.gather(all_p, 1, sel)
        cand_s = torch.where(_first_dup(cand_i), NEG_INF, cand_s)
        if raw_flat is not None:
            re_s = torch.bmm(raw_flat[cand_p].float(), q.unsqueeze(2)).squeeze(2)
        else:
            codes_flat = torch.cat([slabs.reshape(-1, d), spill.to(slabs.dtype)])
            cp = torch.clamp(cand_p, 0, res_flat.shape[0] - 1)
            recon = (codes_flat[cp].float() * slab_scales.max()
                     + res_scales_flat[cp][..., None] * res_flat[cp].float())
            re_s = torch.bmm(recon, q.unsqueeze(2)).squeeze(2)
        re_s = torch.where(torch.isfinite(cand_s), re_s, NEG_INF)
        top_s, sel2 = _topk_stable(re_s, k)
        top_i = torch.gather(cand_i, 1, sel2)
        return top_s, torch.where(torch.isfinite(top_s), top_i, PAD_ID)


def _ivf_search_probe_major(
    q, centroids, slabs_all, ids_flat, raw_flat, res_flat, res_scales_flat, global_scale,
    *, k, nprobe, c_rescore, n_lists, n_spill_chunks,
):
    """Probe-major search (the reference's `_ivf_search_pallas`): coarse ->
    the batch's unique chunks -> kernel B6 -> exact selection -> dedupe
    -> rescore. Scoring a unique chunk serves every query of the batch (a
    query can receive candidates from chunks it did not probe itself)."""
    b = q.shape[0]
    empty_idx = slabs_all.shape[0] - 1

    # 1. coarse quantizer (full f32) + always-probed spill chunks
    with tf32_off():
        _, probe = _topk_stable(q @ centroids.T, nprobe)                    # (B, P)
    always = torch.arange(n_lists, n_lists + n_spill_chunks, device=q.device)
    flat = torch.cat([probe.reshape(-1), always])

    # 2. batch dedupe to a fixed-size sorted unique set (fills -> the
    # empty chunk, the largest index)
    p_max = min(b * nprobe, n_lists) + n_spill_chunks
    uids = unique_fixed(flat, p_max, empty_idx).to(torch.int32)

    return _probe_major_tail(q, uids, slabs_all, ids_flat, raw_flat, res_flat, res_scales_flat,
                             global_scale, k=k, c_rescore=c_rescore)


def _probe_major_tail(q, uids, slabs_all, ids_flat, raw_flat, res_flat, res_scales_flat,
                      global_scale, *, k, c_rescore):
    """Steps 3-6 of the probe-major search, on the chunks `uids` of one
    chunk space (the whole index, or one shard's): B6, exact selection,
    dedupe, rescore -> (scores (B, k), doc ids (B, k))."""
    r = slabs_all.shape[1]
    # 3. stream each unique chunk once: raw int32 scores (lossless)
    cand, _ = ivf_probe_scores(q, slabs_all, uids)

    # 4. exact selection, ties to the lower position (int64 keys of score
    # and position: int8 products tie often, padding rows all score 0)
    kr = min(c_rescore, cand.shape[1])
    posn = torch.arange(cand.shape[1], device=q.device, dtype=torch.int64)
    keys = (cand.to(torch.int64) << 32) | (0x7FFFFFFF - posn)
    pos = 0x7FFFFFFF - (torch.topk(keys, kr, dim=1).values & 0xFFFFFFFF)
    slot = uids.long()[pos // r] * r + pos % r
    doc = ids_flat[torch.clamp(slot, 0, ids_flat.shape[0] - 1)]
    # padding slots hold zero codes and PAD ids: mask by id; 5. drop
    # dual-assignment duplicates (keep the first copy)
    valid = (doc >= 0) & ~_first_dup(doc)

    # 6. exact rescore of the surviving candidates
    re_s = _ivf_rescore(q, slot, slabs_all, raw_flat, res_flat, res_scales_flat, global_scale)
    re_s = torch.where(valid, re_s, NEG_INF)
    top_s, sel = _topk_stable(re_s, k)
    top_i = torch.gather(doc, 1, sel)
    return top_s, torch.where(torch.isfinite(top_s), top_i, PAD_ID)


def _ivf_rescore(q, slot, slabs_all, raw_flat, res_flat, res_scales_flat, gscale):
    """Rescore at flat slab-major positions `slot`: against the bf16 copy
    with the query cast to bf16 (products exact in f32, f32 sums), or the
    two-level reconstruction gscale*cg + s_r*cr in full f32."""
    with tf32_off():
        if raw_flat is not None:
            cvec = raw_flat[torch.clamp(slot, 0, raw_flat.shape[0] - 1)]           # (B, kr, D)
            qb = q.to(raw_flat.dtype).float()
            return torch.bmm(cvec.float(), qb.unsqueeze(2)).squeeze(2)
        rows = torch.clamp(slot, 0, res_flat.shape[0] - 1)
        d = slabs_all.shape[-1]
        recon = residual_rows(slabs_all.reshape(-1, d)[rows], gscale, res_flat[rows],
                              res_scales_flat[rows])
        return torch.bmm(recon, q.float().unsqueeze(2)).squeeze(2)
