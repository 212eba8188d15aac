"""Flat (exact) index: a packed, padded embedding matrix (port of
theoremsearch_tpu/index/flat.py).

Reads and writes the reference's disk layout, so an index saved by
either package loads in the other:

    manifest.json                {num_rows, padded_rows, dim, config, global_scale}
    shard_0000.vecs.npy          (padded_rows, dim) bf16-as-uint16, int8 or f32
    shard_0000.scales.npy        (padded_rows,) f32      [int8 only]
    shard_0000.ids.npy           (padded_rows,) int64 doc ids, -1 for padding

Arrays are held as CPU tensors; bf16 goes to disk as its uint16 bit
pattern (torch.bfloat16 viewed as int16), with no ml_dtypes. The
residual capacity mode is not ported yet.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from ..core.config import IndexConfig
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

    @classmethod
    def build(
        cls,
        embeddings,
        ids=None,
        config: IndexConfig | None = None,
        normalize: bool = True,
        device="cpu",
    ) -> "FlatIndex":
        """Normalize, quantize and pad, computing chunk by chunk on
        `device`; the result lives on the CPU."""
        from .quant import quantize_global_int8, quantize_int8

        emb = embeddings
        if isinstance(emb, np.ndarray):
            emb = torch.from_numpy(np.ascontiguousarray(emb, dtype=np.float32))
        emb = emb.cpu()
        n, d = emb.shape
        cfg = (config or IndexConfig()).replace(dim=d)
        if cfg.residual:
            raise NotImplementedError("the residual capacity mode is not ported yet")
        ids = torch.arange(n, dtype=torch.int64) if ids is None else torch.as_tensor(
            np.asarray(ids, dtype=np.int64))
        emb = l2_normalize_rows(emb, device) if normalize else emb.float()
        padded = _round_up(max(n, 1), cfg.pad_multiple)
        pad_rows = padded - n

        scales = None
        global_scale = 0.0
        if cfg.dtype == "int8":
            if cfg.int8_scale == "global":
                codes, global_scale = quantize_global_int8(emb, device=device)
                sc = torch.full((n,), np.float32(global_scale), dtype=torch.float32)
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
                   global_scale=global_scale)

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
        if cfg.residual or (path / "shard_0000.rescodes.npy").exists():
            raise NotImplementedError("the residual capacity mode is not ported yet")
        vecs = np.load(path / "shard_0000.vecs.npy")
        if cfg.dtype == "bfloat16":
            vecs_t = torch.from_numpy(vecs.view(np.int16)).view(torch.bfloat16)
        else:
            vecs_t = torch.from_numpy(vecs)
        scales_path = path / "shard_0000.scales.npy"
        scales = torch.from_numpy(np.load(scales_path)) if scales_path.exists() else None
        return cls(
            vectors=vecs_t, ids=torch.from_numpy(np.load(path / "shard_0000.ids.npy")),
            scales=scales, num_rows=manifest["num_rows"], config=cfg,
            global_scale=float(manifest.get("global_scale", 0.0)),
        )
