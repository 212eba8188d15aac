"""Port of theoremsearch_tpu.kernels (see the package docstring)."""

from .mips import (
    device_rescore,
    device_rescore_residual,
    fused_mips_topk,
    fused_mips_topk_g,
    merge_topk,
    xla_mips_topk,
    xla_mips_topk_scan,
)

__all__ = [
    "device_rescore",
    "device_rescore_residual",
    "fused_mips_topk",
    "fused_mips_topk_g",
    "merge_topk",
    "xla_mips_topk",
    "xla_mips_topk_scan",
]
