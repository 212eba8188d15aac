"""Helpers shared by the port's test modules (tests/test_torch_*.py).

Importing this module imports nothing of jax or the reference package:
the card's machine runs tests/test_torch_cuda.py without jax.

- `serialize_reference_native()`: the reference's host library
  (theoremsearch_tpu/utils/native.py) builds itself with `make -B` at
  first use whenever the .so is missing or older than its source, under a
  lock that covers one process only. Under pytest-xdist every worker is a
  process of its own: two workers can rebuild at once, and a worker that
  opens a half-written library stays on the numpy fallback for its whole
  life. The fallback normalizes rows with an f32 divide, the library (and
  the port) with one f32 reciprocal of an f64 sum, so such a worker's
  reference index codes differ from the port's. Each port test module
  that reaches the reference's normalization calls this at import, under
  an exclusive `fcntl.flock`: the first load in every worker happens one
  at a time, before any test runs (every xdist worker collects every
  module).
- `cpu_mesh(shard, data=1)`: a port mesh over repeated "cpu" devices
  (torch has no virtual CPU devices), the counterpart of the reference's
  8-device CPU mesh of tests/conftest.py.
- `run_processes(cmds, logdir, timeout)`: the processes of a
  multi-process test, started together; on a timeout every one is killed
  and the test fails.
"""

from __future__ import annotations

import fcntl
import os
import tempfile

_LOCK_NAME = "theoremsearch_tpu_native_load.lock"


def serialize_reference_native() -> bool:
    """Load the reference's native library in this process, holding a
    cross-process lock while it builds or opens; returns whether it
    loaded (False without a C++ toolchain: the numpy fallback is then
    what every process uses)."""
    from theoremsearch_tpu.utils import native

    with open(os.path.join(tempfile.gettempdir(), _LOCK_NAME), "w") as fh:
        fcntl.flock(fh, fcntl.LOCK_EX)
        try:
            return native.available()
        finally:
            fcntl.flock(fh, fcntl.LOCK_UN)


def cpu_mesh(shard: int, data: int = 1):
    """The port's (data, shard) mesh over data * shard "cpu" devices."""
    from theoremsearch_tpu_torch.core.config import MeshConfig
    from theoremsearch_tpu_torch.core.meshes import make_mesh

    return make_mesh(MeshConfig(data=data, shard=shard), devices=["cpu"] * (data * shard))


def ids_agree(s_want, i_want, s_got, i_got, tol: float = 1e-5, where: str = "") -> None:
    """Two (B, k) top-k results agree: the same finite slots, scores
    within `tol`, ids equal wherever the score is unique (no neighbouring
    score within `tol`)."""
    import numpy as np

    sw, iw, sg, ig = (np.asarray(x.cpu() if hasattr(x, "cpu") else x) for x in (s_want, i_want, s_got, i_got))
    assert iw.shape == ig.shape, where
    fin = np.isfinite(sw)
    np.testing.assert_array_equal(fin, np.isfinite(sg), err_msg=where)
    np.testing.assert_allclose(sg[fin], sw[fin], atol=tol, err_msg=where)
    near = np.zeros(sw.shape, bool)
    gap = np.abs(np.diff(np.where(fin, sw, -9.0), axis=1)) <= tol
    near[:, 1:] |= gap
    near[:, :-1] |= gap
    np.testing.assert_array_equal(ig[~near], iw[~near], err_msg=where)


def run_processes(cmds: list[list[str]], logdir, timeout: float = 180.0) -> list[str]:
    """`torch_multihost_worker.launch` (every command at once, one deadline
    of `timeout` seconds, each output into `logdir`); a process that exits
    nonzero or outlives the deadline fails the test."""
    import pytest

    import torch_multihost_worker

    try:
        return torch_multihost_worker.launch(cmds, str(logdir), timeout)
    except RuntimeError as e:
        pytest.fail(str(e))
