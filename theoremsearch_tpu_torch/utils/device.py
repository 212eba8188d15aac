"""Device helpers: the CUDA requirement, the TF32 guard and the card's
name and power limit.

Every timed or checked number of the port names the card it ran on and
its power limit (an H100 set below 700 W runs slower under load), so the
`nvidia-smi` query lives here, once.
"""

from __future__ import annotations

import contextlib
import subprocess
import threading

import torch


def require_cuda() -> torch.device:
    """The CUDA device, or a RuntimeError: entry points run on the card
    unless the caller passes a device, and never fall back to the CPU."""
    if not torch.cuda.is_available():
        raise RuntimeError("a CUDA device is required (torch.cuda.is_available() is False)")
    return torch.device("cuda", torch.cuda.current_device())


def resolve_device(device) -> torch.device:
    """`device` as a torch.device; None means the card (`require_cuda`).
    A bare "cuda" gets the current card's index, so devices compare
    equal however the caller named them."""
    if device is None:
        return require_cuda()
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def gpu_name_power() -> str:
    """`name, power.limit` of the first card, as nvidia-smi prints it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=30,
    ).stdout
    return out.strip().splitlines()[0].strip()


_tf32_lock = threading.Lock()
_tf32_depth = 0
_tf32_saved: tuple[bool, bool] | None = None


@contextlib.contextmanager
def tf32_off():
    """fp32 matmuls at full fp32 inside the block (the reference's
    Precision.HIGHEST): the exact oracle, the rescore and the plain
    kernel versions must not run on TF32, which keeps ~3 decimal digits.

    The flags are process-wide, so the guard is reference-counted: the
    first thread in saves them and turns TF32 off, the last thread out
    restores them, and no thread inside ever sees TF32 back on."""
    global _tf32_depth, _tf32_saved
    with _tf32_lock:
        if _tf32_depth == 0:
            _tf32_saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        _tf32_depth += 1
    try:
        yield
    finally:
        with _tf32_lock:
            _tf32_depth -= 1
            if _tf32_depth == 0:
                torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = _tf32_saved
                _tf32_saved = None
