"""Flat (exact) index: a packed, padded embedding matrix (port of
theoremsearch_tpu/index/flat.py).

Reads and writes the reference's disk layout, so an index saved by
either package loads in the other:

    manifest.json                {num_rows, padded_rows, dim, config, global_scale}
    shard_0000.vecs.npy          (padded_rows, dim) bf16-as-uint16, int8 or f32
    shard_0000.scales.npy        (padded_rows,) f32      [int8 only]
    shard_0000.ids.npy           (padded_rows,) int64 doc ids, -1 for padding
    shard_0000.rescodes.npy      (num_rows, dim) int8    [config.residual only]
    shard_0000.resscales.npy     (num_rows,) f32         [config.residual only]

Arrays are held as tensors, on the CPU unless built otherwise; bf16 goes
to disk as its uint16 bit pattern (torch.bfloat16 viewed as int16), with
no ml_dtypes.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from ..core.config import IndexConfig
from ..utils.device import resolve_device
from ..utils.shapes import round_up as _round_up

PAD_ID = -1


def l2_normalize_rows(x: torch.Tensor, device=None, chunk_rows: int = 65_536) -> torch.Tensor:
    """Row L2 normalization as the reference's native builder does it:
    sum of squares in f64, one f32 reciprocal norm per row (0 for a zero
    row), rows multiplied by it. Computes chunk by chunk on `device`
    (default: x's); returns a new f32 tensor on x's device."""
    dev = torch.device(device) if device is not None else x.device
    out = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    for i in range(0, x.shape[0], chunk_rows):
        xc = x[i : i + chunk_rows].to(dev).float()
        acc = (xc.double() ** 2).sum(dim=1, keepdim=True)
        inv = torch.where(acc > 1e-24, 1.0 / torch.sqrt(acc), torch.zeros_like(acc)).float()
        out[i : i + chunk_rows] = (xc * inv).to(x.device)
    return out


@dataclass
class FlatIndex:
    """Host view of a packed index; the search engine places it on the device."""

    vectors: torch.Tensor          # (padded_rows, dim) bf16, int8 or f32, CPU
    ids: torch.Tensor              # (padded_rows,) int64, PAD_ID for padding
    scales: torch.Tensor | None    # (padded_rows,) f32 for int8, else None
    num_rows: int                  # real (unpadded) rows
    config: IndexConfig
    # int8 with ONE corpus-wide scale (config.int8_scale == "global"):
    # unlocks the engine's speed path; scales repeat it for per-row paths
    global_scale: float = 0.0
    # capacity mode (config.residual): (res_codes int8 (N, D), res_scales
    # f32 (N,)), per-row int8 codes of x - gscale*codes; the engine adopts
    # them for the two-level rescore (2 bytes/dim in all)
    rescore_residual: tuple[torch.Tensor, torch.Tensor] | None = None

    @property
    def padded_rows(self) -> int:
        return int(self.vectors.shape[0])

    @property
    def dim(self) -> int:
        return int(self.vectors.shape[1])

    def device_arrays(self, device=None) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor | None]:
        """(vectors, ids int32, scales or None) on `device` (default: the
        card; "cpu" for a CPU run)."""
        dev = resolve_device(device)
        scales = None if self.scales is None else self.scales.to(dev)
        return self.vectors.to(dev), self.ids.to(device=dev, dtype=torch.int32), scales

    def memory_bytes(self) -> int:
        """Bytes of the packed arrays: vectors, ids, scales and, unlike the
        reference's flat index (which stops at the scales), the residual
        sidecars, as both packages' IVFIndex.memory_bytes count them."""
        arrays = [self.vectors, self.ids, self.scales, *(self.rescore_residual or ())]
        return sum(a.numel() * a.element_size() for a in arrays if a is not None)

    @classmethod
    def build(
        cls,
        embeddings,
        ids=None,
        config: IndexConfig | None = None,
        normalize: bool = True,
        device=None,
    ) -> "FlatIndex":
        """Normalize, quantize and pad, computing chunk by chunk on
        `device` (default: the card; pass "cpu" for a CPU run); the
        result lives on the CPU. config.residual (global-scale int8 only)
        adds the residual codes, quantized on `device` too."""
        from .quant import quantize_global_int8, quantize_int8, quantize_residual_int8

        device = resolve_device(device)
        emb = embeddings
        if isinstance(emb, np.ndarray):
            emb = torch.from_numpy(np.ascontiguousarray(emb, dtype=np.float32))
        emb = emb.cpu()
        n, d = emb.shape
        cfg = (config or IndexConfig()).replace(dim=d)
        if cfg.residual and not (cfg.dtype == "int8" and cfg.int8_scale == "global"):
            raise ValueError("config.residual requires dtype='int8', int8_scale='global'")
        ids = torch.arange(n, dtype=torch.int64) if ids is None else torch.as_tensor(
            np.asarray(ids, dtype=np.int64))
        emb = l2_normalize_rows(emb, device) if normalize else emb.float()
        padded = _round_up(max(n, 1), cfg.pad_multiple)
        pad_rows = padded - n

        scales = None
        global_scale = 0.0
        rescore_residual = None
        if cfg.dtype == "int8":
            if cfg.int8_scale == "global":
                codes, global_scale = quantize_global_int8(emb, device=device)
                sc = torch.full((n,), np.float32(global_scale), dtype=torch.float32)
                if cfg.residual:
                    rc, rs = quantize_residual_int8(emb, codes, global_scale)
                    rescore_residual = (rc.cpu(), rs.cpu())
            else:
                codes, sc = quantize_int8(emb, device=device)
            vecs = torch.cat([codes.cpu(), torch.zeros((pad_rows, d), dtype=torch.int8)])
            scales = torch.cat([sc.cpu(), torch.zeros(pad_rows, dtype=torch.float32)])
        elif cfg.dtype in ("bfloat16", "float32"):
            dt = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
            vecs = torch.cat([emb.to(dt).cpu(), torch.zeros((pad_rows, d), dtype=dt)])
        else:
            raise ValueError(f"unsupported index dtype {cfg.dtype}")
        all_ids = torch.cat([ids, torch.full((pad_rows,), PAD_ID, dtype=torch.int64)])
        return cls(vectors=vecs, ids=all_ids, scales=scales, num_rows=n, config=cfg,
                   global_scale=global_scale, rescore_residual=rescore_residual)

    def save(self, path: str | Path) -> None:
        path = Path(path)
        path.mkdir(parents=True, exist_ok=True)
        vecs = self.vectors
        if vecs.dtype == torch.bfloat16:
            np.save(path / "shard_0000.vecs.npy", vecs.view(torch.int16).numpy().view(np.uint16))
        else:
            np.save(path / "shard_0000.vecs.npy", vecs.numpy())
        np.save(path / "shard_0000.ids.npy", self.ids.numpy())
        # sidecars this index does not carry must not survive from an
        # earlier save: load() infers them from file existence
        if self.scales is not None:
            np.save(path / "shard_0000.scales.npy", self.scales.numpy())
        else:
            (path / "shard_0000.scales.npy").unlink(missing_ok=True)
        if self.rescore_residual is not None:
            np.save(path / "shard_0000.rescodes.npy", self.rescore_residual[0].cpu().numpy())
            np.save(path / "shard_0000.resscales.npy", self.rescore_residual[1].cpu().numpy())
        else:
            (path / "shard_0000.rescodes.npy").unlink(missing_ok=True)
            (path / "shard_0000.resscales.npy").unlink(missing_ok=True)
        manifest = {
            "format": "flat",
            "num_rows": self.num_rows,
            "padded_rows": int(vecs.shape[0]),
            "dim": int(vecs.shape[1]),
            "config": self.config.to_dict(),
            "global_scale": self.global_scale,
        }
        tmp = path / "manifest.json.tmp"
        tmp.write_text(json.dumps(manifest, indent=2))
        tmp.replace(path / "manifest.json")

    @classmethod
    def load(cls, path: str | Path) -> "FlatIndex":
        path = Path(path)
        manifest = json.loads((path / "manifest.json").read_text())
        cfg = IndexConfig.from_dict(manifest["config"])
        vecs = np.load(path / "shard_0000.vecs.npy")
        if cfg.dtype == "bfloat16":
            vecs_t = torch.from_numpy(vecs.view(np.int16)).view(torch.bfloat16)
        else:
            vecs_t = torch.from_numpy(vecs)
        scales_path = path / "shard_0000.scales.npy"
        scales = torch.from_numpy(np.load(scales_path)) if scales_path.exists() else None
        rescore_residual = None
        rc_path = path / "shard_0000.rescodes.npy"
        if rc_path.exists():
            rescore_residual = (torch.from_numpy(np.load(rc_path)),
                                torch.from_numpy(np.load(path / "shard_0000.resscales.npy")))
        return cls(
            vectors=vecs_t, ids=torch.from_numpy(np.load(path / "shard_0000.ids.npy")),
            scales=scales, num_rows=manifest["num_rows"], config=cfg,
            global_scale=float(manifest.get("global_scale", 0.0)),
            rescore_residual=rescore_residual,
        )
