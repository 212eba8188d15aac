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

import numpy as np
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


def upload(a, device) -> torch.Tensor:
    """A host array (numpy or a CPU tensor) on `device`. On the card the
    copy goes through pinned memory with non_blocking=True: a pageable
    host -> device copy waits for all device work already queued, a
    pinned one is enqueued behind it and the host goes on."""
    t = a if isinstance(a, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(a))
    if torch.device(device).type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


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


_side_lock = threading.Lock()
_side_streams: dict = {}


def upload_into(dst: torch.Tensor, src) -> torch.Tensor:
    """Copy a host array (numpy or a CPU tensor) into `dst`, on a side
    stream when `dst` is on the card, and wait for it; returns `dst`.

    A multi-GB host copy on the default stream would hold every query
    queued behind it for the whole transfer. The side stream first waits
    for the work already queued on the current stream (`dst` may be
    memory that queued kernels were still reading when it was freed), so
    `dst` keeps the current stream's allocation and needs no
    record_stream; later queries do not wait for the copy."""
    t = src if isinstance(src, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(src))
    if dst.device.type != "cuda":
        dst.copy_(t)
        return dst
    with _side_lock:
        side = _side_streams.setdefault(dst.device, torch.cuda.Stream(dst.device))
    side.wait_stream(torch.cuda.current_stream(dst.device))
    with torch.cuda.stream(side):
        dst.copy_(t)
    side.synchronize()
    return dst
