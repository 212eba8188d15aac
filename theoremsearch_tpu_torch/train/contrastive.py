"""Contrastive fine-tuning of the embedding encoder (InfoNCE), port of
theoremsearch_tpu/train/contrastive.py.

- in-batch-negatives InfoNCE: queries x positives similarity matrix,
  symmetric cross-entropy at temperature tau, optional explicit hard
  negatives;
- the encoder forward and backward through autograd, for any of the three
  towers (`encoder/families.py` picks the model module from the config's
  type); with fused="on" the qwen attention core is kernel B2 forward and
  kernel B7 backward on the card (`kernels/attention.py:QKNormRopeAttention`),
  the gemma core kernel B2's gemma form forward and autograd through the
  reference composition backward (`encoder/gemma.py:GemmaAttentionCore`);
  BERT has no kernel;
- optax's `chain(clip_by_global_norm(1.0), adamw(lr, weight_decay=wd))`,
  written out in optax's order and dtypes (`AdamW`): bf16 parameters keep
  bf16 moments, and every constant is rounded to the leaf's dtype as JAX
  rounds a Python scalar, so one update agrees with optax's on the CPU.

Parameters and moments are updated in place: the port's counterpart of
the reference's donated train state (`jax.jit(step, donate_argnums=(0,))`).
Trees (params, LoRA adapters, moments) are nested dicts and lists of
tensors, flattened in JAX's order (dict keys sorted, lists in order), so
checkpoints and `train_state_from_jax` line up leaf for leaf with the
reference's pytrees.

On a (data, shard) mesh (`make_train_step(mesh=)`, ROADMAP A.10 items
1-5) the params follow the tower's tp rules (`init_sharded_train_state`,
`shard_train_state`; a sharded leaf is an `encoder.sharding.ShardedTensor`
and its moments are split alike), the batch is split over `data`, each
data row runs the tp forward over its shard devices, and the pooled
embeddings of every row are gathered on the mesh's first device, where
the InfoNCE loss is taken over the global batch as the reference's GSPMD
program takes it. Every copy between devices is a differentiable `.to`,
so autograd builds the backward collectives: the gradient sum over
`data` and over the shards that read a replicated leaf. Two orders of
leaves stay apart: `tree_leaves` yields logical leaves in JAX's order
(checkpoints, `train_state_from_jax`), `piece_leaves` their tensors, a
sharded leaf's pieces in shard order (autograd and the optimizer).

Across processes (item 6 and A.12: a mesh from `make_mesh` after
`core/distributed.py:initialize`) each process encodes the data rows it
runs: rows it holds whole, or, where a row spans processes, the row's
slice through the SPMD tp forward that every process of the row runs
(`encoder/sharding.py:TP`), whose backward sums the gradient of every
replicated input over the row. The global batch is gathered over the
mesh's column group through `distributed.gather_rows`, whose backward
hands each process its own slice of the gradient; every process then
takes the same global loss. The piece gradients are summed over the
column group only, in one flat buffer a dtype
(`distributed.all_reduce_flat`), before the clip and the update: a
replicated leaf's gradient is already whole on every process of a row,
and a sum over the row would count it once a process. The clip's norm
adds every piece's sum of squares in global piece order (gathered over
the row group), each replicated leaf once, so every process reads the
same norm and the params stay identical across processes. The explicit
negatives carry gradient from the first data row only (column-group rank
0), as they come from the first data row alone in one process.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from ..core.config import EncoderConfig, TrainConfig
from ..encoder.families import family_module
from ..encoder.model import Params, params_from_jax
from ..core.distributed import all_gather, all_reduce_flat, gather_rows
from ..encoder.sharding import ShardedTensor, row_params
from ..utils.device import resolve_device, tf32_off


def tree_leaves(tree) -> list:
    """Leaves in JAX's flatten order: dict keys sorted, sequences in order."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for x in tree for leaf in tree_leaves(x)]
    return [tree]


def piece_leaves(tree) -> list:
    """The tensors of `tree_leaves(tree)`, each ShardedTensor replaced by
    its pieces in shard order: what autograd and the optimizer iterate."""
    out = []
    for leaf in tree_leaves(tree):
        out.extend(leaf.pieces if isinstance(leaf, ShardedTensor) else [leaf])
    return out


def logical_grads(params, grads: list) -> list:
    """Per-piece gradients (in `piece_leaves(params)` order) joined into one
    tensor a logical leaf (in `tree_leaves` order), a sharded leaf's pieces
    concatenated on its first shard's device."""
    it = iter(grads)
    out = []
    for leaf in tree_leaves(params):
        if isinstance(leaf, ShardedTensor):
            out.append(leaf.with_pieces([next(it) for _ in leaf.pieces]).full())
        else:
            out.append(next(it))
    return out


def norm_order(params, mesh) -> tuple | None:
    """Where the clip's norm finds each piece's sum of squares when the
    mesh's data row spans processes: (the row group, one (rank in the row,
    position in that process's `piece_leaves`) a piece in the one-process
    order: the logical leaves in JAX's order, a sharded leaf's pieces in
    global piece order, a replicated leaf once, from the row's first
    process). None when this process holds every piece of its row."""
    leaves = tree_leaves(params)
    if mesh is None or not any(isinstance(x, ShardedTensor) and x.split_over_processes
                               for x in leaves):
        return None
    order, pos = [], 0
    for leaf in leaves:
        if isinstance(leaf, ShardedTensor):
            n = len(leaf.pieces)
            order.extend((g // n, pos + g % n) for g in range(leaf.count))
            pos += n
        else:
            order.append((0, pos))
            pos += 1
    return mesh.row_group, order


def tree_unflatten(template, leaves):
    """`template`'s structure filled with `leaves` (in tree_leaves order)."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            out = {k: None for k in t}
            for k in sorted(t):
                out[k] = build(t[k])
            return out
        if isinstance(t, (list, tuple)):
            return type(t)(build(x) for x in t)
        return next(it)

    out = build(template)
    if next(it, None) is not None:
        raise ValueError("more leaves than the template holds")
    return out


class AdamWState(NamedTuple):
    """The state of optax's adamw (its ScaleByAdamState): the step count
    and the two moments, shaped and typed as the parameters."""

    count: int
    mu: Any
    nu: Any


class TrainState(NamedTuple):
    params: Params
    opt_state: AdamWState
    step: int


def _round_to(x: float, dtype: torch.dtype) -> float:
    """A Python scalar as JAX applies it to an array of `dtype`: rounded
    to that dtype first (a weakly typed scalar takes the array's type)."""
    return float(torch.tensor(x, dtype=torch.float64).to(dtype))


class AdamW:
    """optax.chain(clip_by_global_norm(max_norm), adamw(lr, b1, b2, eps,
    weight_decay)) in optax 0.2.6's arithmetic, leaf by leaf in each
    leaf's dtype:

        norm = sqrt(sum over leaves of sum(g * g))    (each leaf's sum in its
                                                       dtype, then f32)
        g    = g if norm < max_norm else (g / norm) * max_norm
        mu   = (1 - b1) g + b1 mu;   nu = (1 - b2) g^2 + b2 nu
        u    = (mu / (1 - b1^t)) / (sqrt(nu / (1 - b2^t)) + eps)
        u    = -lr (u + wd p);       p  = p + u

    with t the incremented count and each bias correction 1 - b^t computed
    in f32 and cast to the leaf's dtype (optax's tree_bias_correction).
    Every operation rounds to the leaf's dtype, as optax run op by op
    does: one update agrees with it within one ulp, f32 and bf16. Under
    jit, XLA fuses the chain (one rounding for bf16, fused multiply-adds
    in f32), which moves a moment that nearly cancels by more than an ulp
    of its own small value. torch.optim.AdamW with clip_grad_norm_ is
    another function (another clip rule, lerp moments, f32 constants).

    `update` changes the params and the moments in place; the multi-tensor
    `torch._foreach_*` ops keep it to a few launches per dtype and device.
    It takes the tensors of a tree (`piece_leaves`): a sharded leaf's
    pieces are updated where they live, each by the same elementwise rule,
    and the clip reads the norm of the whole gradient tree, every piece's
    sum of squares added before the square root."""

    def __init__(self, learning_rate: float, weight_decay: float, max_norm: float = 1.0,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.lr, self.wd, self.max_norm = learning_rate, weight_decay, max_norm
        self.b1, self.b2, self.eps = b1, b2, eps

    def init(self, params) -> AdamWState:
        def zeros(t):
            return t.map(torch.zeros_like) if isinstance(t, ShardedTensor) else torch.zeros_like(t)
        return AdamWState(0, tree_unflatten(params, [zeros(t) for t in tree_leaves(params)]),
                          tree_unflatten(params, [zeros(t) for t in tree_leaves(params)]))

    def _bias_correction(self, decay: float, count: int) -> float:
        """1 - decay^count in f32, from the f32 decay (optax computes
        decay**count in f32; this agrees bit for bit on all but a few
        counts in thousands, by one f32 ulp)."""
        d = float(np.float32(decay))
        return float(np.float32(1.0) - np.float32(d ** count))

    def global_norm(self, grads: list, row: tuple | None = None) -> torch.Tensor:
        """optax.global_norm: each leaf's sum of squares in its own dtype,
        added in leaf order (the first leaf's bf16 sum promoted to f32 at
        the first f32 leaf, as Python's `sum` over JAX arrays does), sqrt. A
        sharded leaf adds its pieces' sums, each in the leaf's dtype, in f32
        (they round apart from the whole leaf's sum). On the first
        gradient's device. row: `norm_order`'s (group, order) where the
        pieces are spread over a row's processes: every process's sums are
        gathered over the row and added in the one-process order."""
        dev = grads[0].device
        sums = [(g * g).sum().float().to(dev) for g in grads]
        if row is not None:
            group, order = row
            every = all_gather(torch.stack(sums), group)
            sums = [every[r][i] for r, i in order]
        return torch.stack(sums).cumsum(0)[-1].sqrt()

    @torch.no_grad()
    def update(self, grads: list, state: AdamWState, params: list,
               row: tuple | None = None) -> AdamWState:
        """One step on matching tensor lists (`piece_leaves` order); params
        and the moments change in place. `row` as `global_norm`'s. Returns
        the new state."""
        count = state.count + 1
        mus, nus = piece_leaves(state.mu), piece_leaves(state.nu)
        norm_all = self.global_norm(grads, row)
        bc1 = self._bias_correction(self.b1, count)
        bc2 = self._bias_correction(self.b2, count)
        groups: dict[tuple, list[int]] = {}
        for i, p in enumerate(params):
            groups.setdefault((p.dtype, p.device), []).append(i)
        for (dtype, dev), idx in groups.items():
            r = lambda x: _round_to(x, dtype)  # noqa: E731
            norm = norm_all.to(dev)
            clip = ~(norm < self.max_norm)   # optax: select(norm < max_norm, g, clipped)
            g = [grads[i].to(dtype) for i in idx]
            p = [params[i] for i in idx]
            mu = [mus[i] for i in idx]
            nu = [nus[i] for i in idx]
            # clip: t / norm.astype(t.dtype) * max_norm where norm >= max_norm
            div = torch.where(clip, norm, torch.ones_like(norm)).to(dtype)
            mul = torch.where(clip, torch.full_like(norm, self.max_norm), torch.ones_like(norm)).to(dtype)
            g = torch._foreach_mul(torch._foreach_div(g, div), mul)
            # moments: (1 - b) * g^k + b * m, each product rounded
            torch._foreach_mul_(mu, r(self.b1))
            torch._foreach_add_(mu, torch._foreach_mul(g, r(1.0 - self.b1)))
            g2 = torch._foreach_mul(g, g)
            torch._foreach_mul_(nu, r(self.b2))
            torch._foreach_add_(nu, torch._foreach_mul(g2, r(1.0 - self.b2)))
            # u = mu_hat / (sqrt(nu_hat + eps_root) + eps), eps_root = 0
            den = torch._foreach_sqrt(torch._foreach_div(nu, r(bc2)))
            torch._foreach_add_(den, r(self.eps))
            u = torch._foreach_div(torch._foreach_div(mu, r(bc1)), den)
            # decoupled decay, then -lr, then p + u
            torch._foreach_add_(u, torch._foreach_mul(p, r(self.wd)))
            torch._foreach_mul_(u, r(-self.lr))
            torch._foreach_add_(p, u)
        return AdamWState(count, state.mu, state.nu)


def make_optimizer(cfg: TrainConfig) -> AdamW:
    """The reference's optax.chain(clip_by_global_norm(1.0),
    adamw(cfg.learning_rate, weight_decay=cfg.weight_decay))."""
    return AdamW(cfg.learning_rate, cfg.weight_decay, max_norm=1.0)


def init_train_state(enc_cfg: EncoderConfig, train_cfg: TrainConfig,
                     generator: torch.Generator | None = None, device=None) -> TrainState:
    """Random params (the tower's `init_params`, seeded by train_cfg.seed
    unless a generator is given) and zero moments on `device` (default:
    the card; pass "cpu" for a CPU run)."""
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(train_cfg.seed)
    params = family_module(enc_cfg).init_params(enc_cfg, generator, device=device)
    return TrainState(params, make_optimizer(train_cfg).init(params), 0)


def init_sharded_train_state(enc_cfg: EncoderConfig, train_cfg: TrainConfig, mesh,
                             generator: torch.Generator | None = None) -> TrainState:
    """The reference's init_sharded_train_state: the tower's random params
    (drawn on the mesh's first device, seeded by train_cfg.seed unless a
    generator is given, so every process of a mesh across processes draws
    the same numbers) placed by its tp rules (`shard_params`), and zero
    moments split as their params."""
    device = mesh.first_device
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(train_cfg.seed)
    mod = family_module(enc_cfg)
    params = mod.shard_params(mod.init_params(enc_cfg, generator, device=device), mesh)
    return TrainState(params, make_optimizer(train_cfg).init(params), 0)


def shard_train_state(state: TrainState, mesh, enc_cfg: EncoderConfig) -> TrainState:
    """A full-params state (`init_train_state`, `train_state_from_jax`)
    placed on the mesh: the params by the tower's tp rules, each moment
    split as its param (a replicated one copied to the mesh's first
    device), the count and step kept. The input state is left as it was."""
    params = family_module(enc_cfg).shard_params(state.params, mesh)
    first = mesh.first_device

    def like(tree):
        return tree_unflatten(params, [
            p.split(m) if isinstance(p, ShardedTensor) else m.detach().to(first, copy=True)
            for p, m in zip(tree_leaves(params), tree_leaves(tree))])

    opt = state.opt_state
    return TrainState(params, AdamWState(opt.count, like(opt.mu), like(opt.nu)), state.step)


def train_state_from_jax(np_state, device=None) -> TrainState:
    """A JAX TrainState as numpy leaves (`jax.device_get(state)`, full or
    LoRA) -> the port's TrainState on `device` (default: the card): the
    params, adamw's count and moments with their dtypes, and the step.
    Mid-training JAX state resumes here."""
    device = resolve_device(device)
    adam = np_state.opt_state[1][0]     # chain(clip, adamw=(scale_by_adam, decay, lr))
    return TrainState(
        params_from_jax(np_state.params, device),
        AdamWState(int(adam.count), params_from_jax(adam.mu, device), params_from_jax(adam.nu, device)),
        int(np_state.step),
    )


def info_nce_loss(
    params: Params,
    q_ids: torch.Tensor,
    q_mask: torch.Tensor,
    p_ids: torch.Tensor,
    p_mask: torch.Tensor,
    enc_cfg: EncoderConfig,
    temperature: float,
    fused: str = "on",
    n_ids: torch.Tensor | None = None,
    n_mask: torch.Tensor | None = None,
    mesh=None,
) -> torch.Tensor:
    """In-batch-negatives InfoNCE, symmetric; optional explicit hard
    negatives (n_ids/n_mask, (M, S)) are appended as extra columns of the
    query -> positive direction, shared by every query. The f32 logits
    product runs with TF32 off.

    mesh: the batch is split over its data axis (`_encode_rows`) and the
    loss taken over the gathered global batch on the first device; the
    negatives, replicated in the reference, are encoded once, by the first
    data row (across processes every process encodes them, and they carry
    gradient on the processes of the first data row only: column-group
    rank 0)."""
    encode_pooled = family_module(enc_cfg).encode_pooled
    if mesh is None:
        q = encode_pooled(params, q_ids, q_mask, enc_cfg, fused=fused)   # (B, D) f32, normalized
        p = encode_pooled(params, p_ids, p_mask, enc_cfg, fused=fused)
    else:
        q = _encode_rows(params, q_ids, q_mask, enc_cfg, fused, mesh)
        p = _encode_rows(params, p_ids, p_mask, enc_cfg, fused, mesh)
    labels = torch.arange(q.shape[0], device=q.device)
    with tf32_off():
        logits = (q @ p.T) / temperature
        logits_qp = logits
        if n_ids is not None:
            neg = encode_pooled(params, n_ids, n_mask, enc_cfg, fused=fused)
            group = mesh.column_group if mesh is not None else None
            if group is not None and group.rank != 0:
                neg = neg.detach()
            logits_qp = torch.cat([logits, (q @ neg.T) / temperature], dim=1)
    return 0.5 * (F.cross_entropy(logits_qp, labels) + F.cross_entropy(logits.T, labels))


def _encode_rows(params, ids: torch.Tensor, mask: torch.Tensor, enc_cfg, fused: str,
                 mesh) -> torch.Tensor:
    """Pooled embeddings of a batch split over the mesh's data axis: row r
    encodes its slice with the params as it reads them
    (`sharding.row_params`: tp over its shard devices for sharded params),
    and the rows are gathered in order on the first device; across
    processes each process encodes the rows it runs (a row split over
    processes: every process of the row the same slice) and the global
    batch is gathered over the column group (`distributed.gather_rows`)."""
    n = mesh.shape[mesh.axis_names[0]]
    if ids.shape[0] % n:
        raise ValueError(f"a batch of {ids.shape[0]} does not split over the {n}-way data axis")
    encode_pooled = family_module(enc_cfg).encode_pooled
    ids_rows, mask_rows = torch.tensor_split(ids, n), torch.tensor_split(mask, n)
    outs = []
    for r, dev in zip(mesh.local_rows, mesh.data_devices):
        outs.append(encode_pooled(row_params(params, mesh, r), ids_rows[r].to(dev),
                                  mask_rows[r].to(dev), enc_cfg, fused=fused).to(mesh.first_device))
    out = torch.cat(outs)
    return out if mesh.column_group is None else gather_rows(out, mesh.column_group)


def _on(x, device) -> torch.Tensor | None:
    """A token array (numpy or tensor) on `device`."""
    if x is None:
        return None
    return (x if isinstance(x, torch.Tensor) else torch.from_numpy(np.asarray(x))).to(device)


def _check_fused(fused) -> None:
    if fused not in ("on", "plain", "off"):
        raise ValueError(f"fused must be 'on', 'plain' or 'off', got {fused!r}")


def _grad_step(opt: AdamW, state: TrainState, loss_fn, mesh=None) -> tuple[TrainState, torch.Tensor]:
    """loss and gradients of state.params, summed over the mesh's column
    group when it spans processes (never over a row: `bcast`'s backward
    already made a replicated leaf's gradient whole there), then the
    in-place update."""
    leaves = piece_leaves(state.params)
    for t in leaves:
        t.requires_grad_(True)
    try:
        loss = loss_fn(state.params)
        grads = list(torch.autograd.grad(loss, leaves))
    finally:
        for t in leaves:
            t.requires_grad_(False)
    group = mesh.column_group if mesh is not None else None
    if group is not None:
        grads = all_reduce_flat(grads, group)
    opt_state = opt.update(grads, state.opt_state, leaves, norm_order(state.params, mesh))
    return TrainState(state.params, opt_state, state.step + 1), loss.detach()


def make_train_step(
    enc_cfg: EncoderConfig,
    train_cfg: TrainConfig,
    mesh=None,
    fused: str = "on",
):
    """(state, q_ids, q_mask, p_ids, p_mask[, n_ids, n_mask]) -> (state,
    loss). The params and moments of `state` are updated in place (the
    counterpart of the reference's donated state); the loss comes back as
    a 0-d tensor on the params' device with no host sync (`float(loss)`
    syncs). Token arrays may be numpy or tensors on any device.

    fused: "on" = the attention core through the kernels on the card (qwen:
    B2 forward, B7 backward; gemma: B2's gemma form forward, autograd
    through the reference composition backward), their plain versions for
    CPU tensors;
    "plain" = the plain versions on any device; "off" = the reference's
    composition, through autograd. The port's default is "on"; the
    reference's is "off", chosen for its TPU (under a mesh the reference
    keeps XLA too: its Pallas kernels are opaque to GSPMD).

    mesh: the dp + tp step. `state` comes from `init_sharded_train_state`
    or `shard_train_state` (or holds full params on the mesh's first
    device: data parallel alone); the batch (a multiple of the data axis)
    is split over `data`, explicit negatives replicated; every piece is
    updated in place. With fused "on" the qwen core runs kernel B2 forward
    and B7 backward once a shard a layer (head-local) or on the gathered
    heads. On a mesh across processes every process passes the whole
    batch, runs its own data rows, and gets the same loss; the gradients
    are summed over the processes before the update."""
    _check_fused(fused)
    opt = make_optimizer(train_cfg)

    def step(state: TrainState, q_ids, q_mask, p_ids, p_mask, n_ids=None, n_mask=None):
        dev = mesh.first_device if mesh is not None else state.params["embed"].device
        batch = [_on(x, dev) for x in (q_ids, q_mask, p_ids, p_mask, n_ids, n_mask)]
        return _grad_step(opt, state, lambda params: info_nce_loss(
            params, *batch[:4], enc_cfg, train_cfg.temperature, fused, *batch[4:], mesh=mesh),
            mesh)

    return step


def make_lora_train_step(
    enc_cfg: EncoderConfig,
    train_cfg: TrainConfig,
    mesh=None,
    fused: str = "on",
):
    """(state, base_params, q_ids, q_mask, p_ids, p_mask[, n_ids, n_mask])
    -> (state, loss), where state.params is the LoRA adapter tree
    (train/lora.py) and base_params stay frozen: gradients flow only to
    the adapters, through the merged encoder built inside the step. The
    adapters and their moments are updated in place.

    mesh: as `make_train_step`'s; the adapters are replicated (one leaf on
    the mesh's first device, `init_lora_train_state` over the base params
    placed there or sharded) and the base may be full or sharded
    (`lora_merge` splits each delta as its matrix)."""
    from .lora import lora_merge

    _check_fused(fused)
    opt = make_optimizer(train_cfg)
    alpha = train_cfg.lora_alpha

    def step(state: TrainState, base_params, q_ids, q_mask, p_ids, p_mask,
             n_ids=None, n_mask=None):
        dev = mesh.first_device if mesh is not None else base_params["embed"].device
        batch = [_on(x, dev) for x in (q_ids, q_mask, p_ids, p_mask, n_ids, n_mask)]
        return _grad_step(opt, state, lambda lora: info_nce_loss(
            lora_merge(base_params, lora, alpha), *batch[:4], enc_cfg, train_cfg.temperature,
            fused, *batch[4:], mesh=mesh), mesh)

    return step


def init_lora_train_state(
    params: Params, train_cfg: TrainConfig, generator: torch.Generator | None = None,
) -> TrainState:
    """Adapter-only TrainState over frozen base params, on their device (a
    sharded base's first shard's: the mesh's first device): moments exist
    only for the LoRA leaves."""
    from .lora import DEFAULT_TARGETS, lora_init

    dev = params["embed"].device
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(train_cfg.seed)
    targets = train_cfg.lora_targets or DEFAULT_TARGETS
    lora = lora_init(params, generator, train_cfg.lora_rank, tuple(targets))
    return TrainState(lora, make_optimizer(train_cfg).init(lora), 0)
