"""Build and load the port's CUDA kernels.

All sources under `csrc/` compile with nvcc, one process per source,
all started together, into ONE shared library with a plain C interface,
loaded through ctypes. The library is built at first use into
`theoremsearch_tpu_torch/_build/`, named by a hash of the sources and the
flags, so an edited source rebuilds and an unchanged one loads the
existing file. Nothing here runs at import time: the CPU test
environment has no nvcc.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (
    *ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-fmad=false", "-Xptxas", "-v",
)

_lib = None
_lock = threading.Lock()
build_seconds: float | None = None   # wall time of the nvcc run, None if loaded
ptxas_log = ""                        # nvcc/ptxas output of the last build


def _sources() -> list[Path]:
    return sorted(p for p in CSRC.iterdir() if p.suffix in (".cu", ".cuh"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is installed")


def _declare(lib: ctypes.CDLL) -> None:
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.ts_mips_g_scan.argtypes = [p, p, p, i, i, i, i, i, i, p, p, i, p, p, i, p]
    lib.ts_mips_g_scan.restype = i
    lib.ts_mips_topk.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, i, i, p]
    lib.ts_mips_topk.restype = i
    lib.ts_qknorm_rope_attention.argtypes = [
        p, p, p, p, p, p, p, p, p, i, i, i, i, i, f, f, i, p,
    ]
    lib.ts_qknorm_rope_attention.restype = i
    lib.ts_qknorm_rope_attention_bwd.argtypes = [*[p] * 15, i, i, i, i, i, f, f, i, p]
    lib.ts_qknorm_rope_attention_bwd.restype = i
    lib.ts_mlp_int8_layer.argtypes = [*[p] * 16, i, i, i, i, f, p]
    lib.ts_mlp_int8_layer.restype = i
    lib.ts_attn_int8_qkv.argtypes = [*[p] * 13, i, i, i, i, f, p]
    lib.ts_attn_int8_qkv.restype = i
    lib.ts_attn_int8_out.argtypes = [*[p] * 9, i, i, i, f, p]
    lib.ts_attn_int8_out.restype = i
    lib.ts_ivf_scores.argtypes = [p, p, p, p, i, i, i, i, i, p]
    lib.ts_ivf_scores.restype = i
    lib.ts_error_string.argtypes = [i]
    lib.ts_error_string.restype = ctypes.c_char_p


def _compile(srcs: list[Path], so: Path) -> None:
    """One nvcc per source, run in parallel, then one link."""
    global build_seconds, ptxas_log
    tag = f"{os.getpid()}.tmp"
    objs = [so.with_name(f"{s.stem}.{tag}.o") for s in srcs]
    t0 = time.perf_counter()
    procs = [
        subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-c", "-o", str(o), str(s)],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for s, o in zip(srcs, objs)
    ]
    logs, failed = [], []
    for s, pr in zip(srcs, procs):
        out, _ = pr.communicate(timeout=900)
        logs.append(f"== {s.name}\n{out}")
        if pr.returncode != 0:
            failed.append(logs[-1])
    ptxas_log = "".join(logs)
    if failed:
        # the failing sources' own output, their errors first
        errs = "".join(ln for log in failed for ln in log.splitlines(keepends=True)
                       if "error" in ln)
        raise RuntimeError(f"nvcc failed:\n{errs[:4000]}\n{''.join(failed)[-4000:]}")
    tmp = so.with_suffix(f".{tag}")
    res = subprocess.run([_nvcc(), *ARCH, "-shared", "-o", str(tmp), *map(str, objs)],
                         capture_output=True, text=True, timeout=300)
    for o in objs:
        o.unlink(missing_ok=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{(res.stdout + res.stderr)[-6000:]}")
    build_seconds = time.perf_counter() - t0
    tmp.replace(so)


def load() -> ctypes.CDLL:
    """The kernels' library, built from `csrc/` on first use."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is not None:
            return _lib
        srcs = _sources()
        h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        for s in srcs:
            h.update(s.name.encode())
            h.update(s.read_bytes())
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        so = BUILD_DIR / f"libts_kernels_{h.hexdigest()[:16]}.so"
        # a file lock keeps concurrent processes from racing one build
        with open(BUILD_DIR / "build.lock", "w") as lk:
            fcntl.flock(lk, fcntl.LOCK_EX)
            if not so.exists():
                _compile([s for s in srcs if s.suffix == ".cu"], so)
        lib = ctypes.CDLL(str(so))
        _declare(lib)
        _lib = lib
        return lib


class LaunchCounter:
    """Plain count of a wrapper's kernel launches: a run that resets it,
    drives the main path and reads it shows the kernel really ran."""

    def __init__(self) -> None:
        self.n = 0
        self._lock = threading.Lock()

    def bump(self) -> None:
        with self._lock:
            self.n += 1

    def reset(self) -> None:
        with self._lock:
            self.n = 0


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a launch."""
    if err:
        raise RuntimeError(f"{what}: CUDA error {err} ({lib.ts_error_string(err).decode()})")
