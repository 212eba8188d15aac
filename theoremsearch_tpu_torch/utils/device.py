"""Device helpers: the CUDA requirement, the TF32 guard and the card's
name and power limit.

Every timed or checked number of the port names the card it ran on and
its power limit (an H100 set below 700 W runs slower under load), so the
`nvidia-smi` query lives here, once.
"""

from __future__ import annotations

import contextlib
import subprocess

import torch


def require_cuda() -> torch.device:
    """The CUDA device, or a RuntimeError: measurement paths never fall
    back to the CPU."""
    if not torch.cuda.is_available():
        raise RuntimeError("a CUDA device is required (torch.cuda.is_available() is False)")
    return torch.device("cuda", torch.cuda.current_device())


def gpu_name_power() -> str:
    """`name, power.limit` of the first card, as nvidia-smi prints it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=30,
    ).stdout
    return out.strip().splitlines()[0].strip()


@contextlib.contextmanager
def tf32_off():
    """fp32 matmuls at full fp32 inside the block (the reference's
    Precision.HIGHEST): the exact oracle, the rescore and the plain
    kernel versions must not run on TF32, which keeps ~3 decimal digits."""
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev
