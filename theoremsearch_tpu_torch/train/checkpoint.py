"""Training checkpoint/resume (port of theoremsearch_tpu/train/checkpoint.py).

One format, the reference's npz fallback: `step_{n}.npz` holding
`leaf_{i}` in the reference's leaf order (params, then adamw's count,
first and second moments, then the step; `contrastive.tree_leaves`).
bf16 leaves are stored as their int16 bit pattern, as `FlatIndex` stores
bf16 rows, since numpy has no bf16 of its own. There is no orbax.

A state on a mesh (`contrastive.init_sharded_train_state`) is saved as
its full logical leaves, the file a single-device run writes; restoring
into a sharded template splits each leaf as the template's (the pieces
this process holds). So a checkpoint moves between a mesh and one device
either way. In a process group (`core/distributed.py:initialize`) every
process holds the same state, or its block of a row's pieces where a
data row spans processes: every process gathers those leaves over its
row group (a collective every process of the row must join), process 0
writes the file and the others wait for it at a barrier; every process
can restore.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from ..core.config import EncoderConfig, TrainConfig
from ..core.distributed import barrier, current
from ..encoder.sharding import ShardedTensor
from .contrastive import AdamWState, TrainState, tree_leaves, tree_unflatten


def _state_leaves(state: TrainState) -> list:
    opt = state.opt_state
    return [*tree_leaves(state.params), opt.count, *tree_leaves(opt.mu), *tree_leaves(opt.nu),
            state.step]


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, ShardedTensor):
        leaf = leaf.full()
    if not isinstance(leaf, torch.Tensor):
        return np.asarray(leaf, np.int32)
    t = leaf.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy()


def save_checkpoint(state: TrainState, path: str | Path) -> None:
    """Write `step_{state.step}.npz` under `path`. In a process group,
    every process gathers the leaves split over its row, process 0 writes
    and every process returns once the file is complete."""
    group = current()
    writer = group is None or group.rank == 0
    leaves = []
    for leaf in _state_leaves(state):
        if isinstance(leaf, ShardedTensor) and leaf.split_over_processes:
            leaf = leaf.full()              # the row's collective: every process joins
        leaves.append(_to_numpy(leaf) if writer else None)
    if writer:
        path = Path(path).resolve()
        path.mkdir(parents=True, exist_ok=True)
        np.savez(path / f"step_{int(state.step)}.npz",
                 **{f"leaf_{i}": a for i, a in enumerate(leaves)})
    if group is not None:
        barrier(group)


def latest_step(path: str | Path) -> int | None:
    path = Path(path)
    if not path.exists():
        return None
    steps = []
    for p in path.iterdir():
        if p.name.startswith("step_"):
            try:
                steps.append(int(p.name.split("_")[1].split(".")[0]))
            except ValueError:
                continue
    return max(steps) if steps else None


def restore_checkpoint(
    path: str | Path,
    enc_cfg: EncoderConfig,
    train_cfg: TrainConfig,
    step: int | None = None,
    template: TrainState | None = None,
) -> TrainState | None:
    """Restore the given (or latest) step; None when nothing is saved.

    `template` supplies the structure, dtypes and devices (a LoRA adapter
    state from init_lora_train_state, any full state, or a sharded one,
    whose leaves are split as its own); without it the
    default full-fine-tune state (`init_train_state`, on the card)."""
    from .contrastive import init_train_state

    path = Path(path).resolve()
    step = step if step is not None else latest_step(path)
    if step is None:
        return None
    npz = path / f"step_{step}.npz"
    if not npz.exists():
        return None
    if template is None:
        template = init_train_state(enc_cfg, train_cfg)
    data = np.load(npz)
    tl = _state_leaves(template)
    leaves = []
    for i, l in enumerate(tl):
        a = data[f"leaf_{i}"]
        if not isinstance(l, (torch.Tensor, ShardedTensor)):
            leaves.append(int(a))
            continue
        t = torch.from_numpy(np.array(a))
        if l.dtype == torch.bfloat16:
            t = t.view(torch.bfloat16)
        if t.dtype != l.dtype or t.shape != l.shape:
            raise ValueError(f"checkpoint leaf {i}: {t.dtype} {tuple(t.shape)} does not fit "
                             f"the template's {l.dtype} {tuple(l.shape)}")
        leaves.append(l.split(t) if isinstance(l, ShardedTensor) else t.to(l.device))
    n = len(tree_leaves(template.params))
    params = tree_unflatten(template.params, leaves[:n])
    mu = tree_unflatten(template.opt_state.mu, leaves[n + 1 : 2 * n + 1])
    nu = tree_unflatten(template.opt_state.nu, leaves[2 * n + 1 : 3 * n + 1])
    return TrainState(params, AdamWState(leaves[n], mu, nu), leaves[-1])
