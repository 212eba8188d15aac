"""The routed expert layer of the deepseek tower: the plan of a layer's
(token, expert) pairs sorted by expert, the grouped SwiGLU product of
the experts' gate and up matrices, the grouped product of their down
matrices, and the combine of each token's picks.

No TPU kernel stands behind these: the JAX package has no expert layer.
The CUDA kernels are in `csrc/moe.cu`; each function here has a plain
PyTorch version beside it with the kernel's casts, which a CPU tensor
takes. A CUDA tensor goes to the kernel, or raises.

The layout. A layer routes the T real tokens of a sub-batch, each to
k experts. The T * k pairs are sorted by expert, stably (pair t k + j
before t k + j' for j < j'), so expert e holds sorted pairs
offsets[e] .. offsets[e + 1] - 1; `rows[i]` is the token of sorted pair i,
`inv[t k + j]` the sorted position of pair (t, j). Expert weights are
stored (E, out, in), K-contiguous, the checkpoint's own layout:
`w_gate`, `w_up` (E, I, H) and `w_down` (E, H, I).

The arithmetic (HF `modeling_deepseek.py`'s, in the working type):
  - h = bf16(bf16(silu(bf16(x W_g^T))) * bf16(x W_u^T)), products summed
    in f32;
  - y = bf16(h W_d^T), summed in f32;
  - out = bf16(x + bf16(bf16(sum_j w_j y_j) + shared)), the sum over a
    token's picks in f32 in pick order, each product rounded before the
    add, so the plain version and the kernel agree bit for bit on it.
No atomics anywhere: equal inputs at an equal shape give equal bits.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ..utils.device import tf32_off
from ._build import LaunchCounter, check, load

BM = 128               # sorted pairs a tile of the grouped kernels
BN_SWIGLU = 64         # output columns a tile of the gate/up product (64 of gate and 64 of up)
BN_DOWN = 128          # output columns a tile of the down product
BK = 64                # the reduction's step

grouped_launches = LaunchCounter()    # the two grouped products
plan_launches = LaunchCounter()
combine_launches = LaunchCounter()


def _stream(dev) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)


def _need(cond: bool, what: str) -> None:
    if not cond:
        raise ValueError(what)


def _aligned(*ts: torch.Tensor) -> bool:
    return all(t.is_contiguous() and t.data_ptr() % 16 == 0 for t in ts)


# ---------------------------------------------------------------------------
# the plan: pairs sorted by expert, per-expert offsets, the counters
# ---------------------------------------------------------------------------


def route_plan(top: torch.Tensor, n_experts: int, acc: torch.Tensor | None = None):
    """(rows, offsets, inv), all int32, of the picks `top` (T, k): `rows`
    (T k,) the token of each pair sorted by expert (stably), `offsets`
    (E + 1,) each expert's first sorted pair, `inv` (T k,) the sorted
    position of pair t k + j. With `acc` (4,) int64 on the same device,
    adds the layer's pairs, real tokens, experts with at least one pair
    and the busiest expert's pairs to it (on the card inside the plan
    kernel: no host read)."""
    t, k = top.shape
    p = t * k
    keys, order = torch.sort(top.reshape(-1).to(torch.int32), stable=True)
    rows = torch.div(order, k, rounding_mode="floor").to(torch.int32)
    inv = torch.empty(p, dtype=torch.int32, device=top.device)
    inv.scatter_(0, order, torch.arange(p, dtype=torch.int32, device=top.device))
    if top.device.type == "cpu":
        return rows, route_offsets_plain(keys, n_experts, t, acc), inv
    _need(top.device.type == "cuda", f"route_plan: unsupported device {top.device}")
    _need(1 <= n_experts <= 256, "route_plan takes at most 256 experts")
    offsets = torch.empty(n_experts + 1, dtype=torch.int32, device=top.device)
    if acc is not None:
        _need(acc.dtype == torch.int64 and acc.shape == (4,) and acc.device == top.device,
              "acc must be (4,) int64 on the tokens' device")
    lib = load()
    with torch.cuda.device(top.device):
        err = lib.ts_moe_plan(keys.data_ptr(), p, n_experts, t, offsets.data_ptr(),
                              acc.data_ptr() if acc is not None else None, _stream(top.device))
    check(lib, err, "route_plan")
    plan_launches.bump()
    return rows, offsets, inv


def route_offsets_plain(keys: torch.Tensor, n_experts: int, n_tokens: int,
                        acc: torch.Tensor | None = None) -> torch.Tensor:
    """Plain version of the plan kernel: each expert's first position in
    the sorted keys, and the counters' update."""
    bounds = torch.arange(n_experts + 1, dtype=torch.int32, device=keys.device)
    offsets = torch.searchsorted(keys, bounds).to(torch.int32)
    if acc is not None:
        cnt = (offsets[1:] - offsets[:-1]).long()
        acc += torch.stack([torch.tensor(keys.numel(), device=keys.device),
                            torch.tensor(n_tokens, device=keys.device),
                            (cnt > 0).sum(), cnt.max()])
    return offsets


# ---------------------------------------------------------------------------
# the grouped products
# ---------------------------------------------------------------------------


def _slots(n_pairs: int, n_experts: int) -> int:
    """Row tiles the grid is sized for: at least every expert's
    ceil(rows / BM), whatever the split (host arithmetic, no read of the
    offsets)."""
    return -(-n_pairs // BM) + n_experts


def grouped_swiglu(x: torch.Tensor, rows: torch.Tensor, offsets: torch.Tensor,
                   w_gate: torch.Tensor, w_up: torch.Tensor) -> torch.Tensor:
    """h (P, I): sorted pair i's SwiGLU through its expert's gate and up
    matrices, x[rows[i]] the pair's token row (x (T, H)); one launch."""
    p = rows.numel()
    e, n, kdim = w_gate.shape
    if x.device.type == "cpu":
        return grouped_swiglu_plain(x, rows, offsets, w_gate, w_up)
    _need(x.device.type == "cuda", f"grouped_swiglu: unsupported device {x.device}")
    _need(x.dtype == w_gate.dtype == w_up.dtype == torch.bfloat16, "grouped_swiglu takes bf16")
    _need(w_up.shape == w_gate.shape and x.shape[1] == kdim, "shapes of x, w_gate, w_up")
    _need(n % BN_SWIGLU == 0 and kdim % BK == 0, f"grouped_swiglu takes I % {BN_SWIGLU} and H % {BK} == 0")
    _need(offsets.shape == (e + 1,) and rows.dtype == offsets.dtype == torch.int32, "rows/offsets")
    _need(_aligned(x, w_gate, w_up), "x, w_gate, w_up must be contiguous and 16-byte aligned")
    h = torch.empty((p, n), dtype=torch.bfloat16, device=x.device)
    if p == 0:
        return h
    lib = load()
    with torch.cuda.device(x.device):
        err = lib.ts_moe_grouped_swiglu(x.data_ptr(), rows.data_ptr(), offsets.data_ptr(),
                                        w_gate.data_ptr(), w_up.data_ptr(), h.data_ptr(), e, kdim,
                                        n, _slots(p, e), _stream(x.device))
    check(lib, err, "grouped_swiglu")
    grouped_launches.bump()
    return h


def grouped_down(h: torch.Tensor, offsets: torch.Tensor, w_down: torch.Tensor) -> torch.Tensor:
    """y (P, H): sorted pair i's row of h through its expert's down matrix;
    one launch."""
    p = h.shape[0]
    e, n, kdim = w_down.shape
    if h.device.type == "cpu":
        return grouped_down_plain(h, offsets, w_down)
    _need(h.device.type == "cuda", f"grouped_down: unsupported device {h.device}")
    _need(h.dtype == w_down.dtype == torch.bfloat16 and h.shape[1] == kdim, "grouped_down shapes")
    _need(n % BN_DOWN == 0 and kdim % BK == 0, f"grouped_down takes H % {BN_DOWN} and I % {BK} == 0")
    _need(offsets.shape == (e + 1,) and offsets.dtype == torch.int32, "offsets")
    _need(_aligned(h, w_down), "h, w_down must be contiguous and 16-byte aligned")
    y = torch.empty((p, n), dtype=torch.bfloat16, device=h.device)
    if p == 0:
        return y
    lib = load()
    with torch.cuda.device(h.device):
        err = lib.ts_moe_grouped_down(h.data_ptr(), offsets.data_ptr(), w_down.data_ptr(),
                                      y.data_ptr(), e, kdim, n, _slots(p, e), _stream(h.device))
    check(lib, err, "grouped_down")
    grouped_launches.bump()
    return y


def _expert_spans(offsets: torch.Tensor):
    off = offsets.tolist()
    return [(e, off[e], off[e + 1]) for e in range(len(off) - 1) if off[e + 1] > off[e]]


def grouped_swiglu_plain(x, rows, offsets, w_gate, w_up) -> torch.Tensor:
    """Plain version of the gate/up kernel: per expert, the products in
    f32 (TF32 off), each rounded to x's type, silu in f32 rounded, the
    product rounded."""
    h = torch.zeros((rows.numel(), w_gate.shape[1]), dtype=x.dtype, device=x.device)
    with tf32_off():
        for e, lo, hi in _expert_spans(offsets):
            xe = x.index_select(0, rows[lo:hi].long()).float()
            g = (xe @ w_gate[e].float().T).to(x.dtype)
            u = (xe @ w_up[e].float().T).to(x.dtype)
            h[lo:hi] = (F.silu(g.float()).to(x.dtype).float() * u.float()).to(x.dtype)
    return h


def grouped_down_plain(h, offsets, w_down) -> torch.Tensor:
    """Plain version of the down kernel: per expert, the product in f32
    (TF32 off), rounded to h's type."""
    y = torch.zeros((h.shape[0], w_down.shape[1]), dtype=h.dtype, device=h.device)
    with tf32_off():
        for e, lo, hi in _expert_spans(offsets):
            y[lo:hi] = (h[lo:hi].float() @ w_down[e].float().T).to(h.dtype)
    return y


# ---------------------------------------------------------------------------
# the combine
# ---------------------------------------------------------------------------


def combine_into(x: torch.Tensor, tokens: torch.Tensor, y: torch.Tensor, inv: torch.Tensor,
                 weights: torch.Tensor, shared: torch.Tensor) -> None:
    """x[tokens[t]] = x + (sum_j weights[t, j] y[inv[t k + j]] + shared[t]),
    in place, with the casts of the module's note; x (S, H), tokens (T,)
    the rows of x the real tokens hold, weights (T, k) f32, shared (T, H)."""
    t, k = weights.shape
    if x.device.type == "cpu":
        return combine_into_plain(x, tokens, y, inv, weights, shared)
    _need(x.device.type == "cuda", f"combine_into: unsupported device {x.device}")
    _need(x.dtype == y.dtype == shared.dtype == torch.bfloat16 and weights.dtype == torch.float32,
          "combine_into takes bf16 rows and f32 weights")
    _need(x.shape[1] == y.shape[1] == shared.shape[1] and x.shape[1] % 8 == 0, "widths")
    _need(tokens.dtype == inv.dtype == torch.int32 and tokens.numel() == t == shared.shape[0]
          and inv.numel() == t * k, "tokens/inv")
    _need(_aligned(x, y, shared) and weights.is_contiguous() and tokens.is_contiguous(),
          "combine_into's operands must be contiguous and 16-byte aligned")
    if t == 0:
        return None
    lib = load()
    with torch.cuda.device(x.device):
        err = lib.ts_moe_combine(x.data_ptr(), tokens.data_ptr(), y.data_ptr(), inv.data_ptr(),
                                 weights.data_ptr(), shared.data_ptr(), t, k, x.shape[1],
                                 _stream(x.device))
    check(lib, err, "combine_into")
    combine_launches.bump()
    return None


def combine_into_plain(x, tokens, y, inv, weights, shared) -> None:
    """Plain version of the combine kernel (the same products and adds in
    the same order)."""
    t, k = weights.shape
    yk = y.index_select(0, inv.long()).view(t, k, -1).float()
    acc = yk[:, 0] * weights[:, 0:1]
    for j in range(1, k):
        acc = acc + yk[:, j] * weights[:, j : j + 1]
    r = (acc.to(x.dtype).float() + shared.float()).to(x.dtype)
    idx = tokens.long()
    x.index_copy_(0, idx, (x.index_select(0, idx).float() + r.float()).to(x.dtype))
    return None
