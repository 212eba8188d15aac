"""Whole-layer int8 (w8a8) encoder blocks: the attention sub-block (B3)
and the MLP sub-block (B4) of the Qwen3-class tower.

Port of theoremsearch_tpu/kernels/layer_int8.py (the qwen form: pre-norm
only, SwiGLU, causal). Two TPU kernels become short fixed sequences of
hand-written CUDA kernels in `csrc/layer_int8.cu`:

- `_mlp_kernel` -> `fused_mlp_int8_layer` (plain version
  `fused_mlp_int8_layer_plain`): RMSNorm fused with the per-token int8
  quant -> gate/up int8 products with the SiLU(g)*u epilogue into bf16 h
  -> per-row requant of h -> down int8 product, dequant and the bf16
  residual add;
- `_attn_layer_kernel` -> `fused_attn_int8_layer` (plain version
  `fused_attn_int8_layer_plain`): RMSNorm + quant -> q/k/v int8 products
  dequantized to bf16 -> the fused attention core (`kernels/attention.py`,
  kernel B2) -> per-row requant -> o int8 product, dequant and the bf16
  residual add.

The TPU kernels kept every int8 weight resident in VMEM and streamed
128-token tiles past them. A Hopper block has at most 227 KB of shared
memory, so here the weights stay in the card's 50 MB L2 and the token
tiles are the blocks' work; intermediates go through device memory.

Numerics are the reference's: f32 norm statistics and scale arithmetic,
`m / 127` as `m * f32(1/127)` (what XLA compiles the jitted reference
to), round half to even clipped to +-127, exact int8 x int8 -> int32
products, `(float(acc) * row_scale) * column_scale`, the bf16 round trips
before each requant and a bf16 residual add. One deliberate difference:
the sum of squares of the RMSNorm is taken in f64 and rounded to f32,
so the kernel and its plain version agree on it whatever their summation
order, and their int8 codes are bit-equal; the reference sums in f32.
The plain versions compute the products exactly in f64 (every sum is an
integer below 2^53), never in f32: 127^2 * 3072 > 2^24.

A CPU tensor goes to the plain version, a CUDA tensor to the kernels.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch
import torch.nn.functional as F

from .attention import fused_qknorm_rope_attention, fused_qknorm_rope_attention_plain
from ._build import LaunchCounter, check, load

mlp_int8_launches = LaunchCounter()
attn_int8_launches = LaunchCounter()

_INV127 = 1.0 / 127.0   # exactly f32(1/127) once cast: 0x1.020408p-7
_MIN_SCALE = 1e-12

# The budget the reference's whole-layer kernels had for their resident
# int8 weights. It comes from the TPU's VMEM, not from this card; it is
# kept so that both packages route the same configurations to the
# whole-layer kernels and the rest to the op-chain.
_WEIGHT_VMEM_BUDGET = 48 * 1024 * 1024


def fused_layer_shapes_ok(d: int, i: int, hq_d: int, hk_d: int) -> bool:
    """Whether the whole-layer kernels take these model dims: every dim
    a multiple of 128, and the larger block's int8 weights (MLP 3*d*i,
    attention 2*d*(hq_d + hk_d) bytes) within the reference's 48 MB
    budget. The budget is the TPU's VMEM limit, inherited unchanged so
    both packages pick the same route; the CUDA kernels themselves need
    only the alignment."""
    if any(x % 128 for x in (d, i, hq_d, hk_d)):
        return False
    return max(3 * d * i, 2 * d * (hq_d + hk_d)) <= _WEIGHT_VMEM_BUDGET


# ---------------------------------------------------------------------------
# plain versions of the stages (shared with encoder/model.py's op-chain)
# ---------------------------------------------------------------------------


def rmsnorm_quant_plain(x: torch.Tensor, w: torch.Tensor, eps: float):
    """RMSNorm fused with the per-token int8 quant, the normed tensor
    never formed: (..., d) -> int8 codes and f32 (..., 1) scales. The
    row absmax of x*r*w is max|x*w| * r; codes are x * (r / s) * w."""
    xf = x.float()
    wf = w.float()
    ss = (xf * xf).double().sum(dim=-1, keepdim=True).float()
    r = torch.rsqrt(ss * (1.0 / xf.shape[-1]) + eps)
    m = (xf.abs() * wf.abs()).amax(dim=-1, keepdim=True) * r
    s = torch.clamp(m * _INV127, min=_MIN_SCALE)
    q = torch.clamp(torch.round(xf * (r / s) * wf), -127, 127).to(torch.int8)
    return q, s


def quant_rows_plain(x: torch.Tensor):
    """(..., d) -> int8 rows and f32 per-row (..., 1) scales."""
    xf = x.float()
    s = torch.clamp(xf.abs().amax(dim=-1, keepdim=True) * _INV127, min=_MIN_SCALE)
    q = torch.clamp(torch.round(xf / s), -127, 127).to(torch.int8)
    return q, s


def i8_matmul(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """Exact int8 x int8 product as integer-valued f64 (..., n): every
    partial sum is an integer below 2^53, so any order is exact, and
    `.float()` of it rounds as float(int32) does."""
    return torch.matmul(xq.double(), wq.double())


def dequant(acc: torch.Tensor, sx: torch.Tensor, ws: torch.Tensor) -> torch.Tensor:
    """(float(acc) * row scale) * column scale, in f32."""
    return acc.float() * sx * ws.float()


def fused_mlp_int8_layer_plain(x, norm_w, wg: dict, wu: dict, wd: dict, *, eps: float = 1e-6):
    """x + SwiGLU_int8(RMSNorm(x)), with the kernels' casts. `wg`, `wu`,
    `wd` are {"q": (in, out) int8, "s": (out,) f32} from
    `encoder/model.py:quantize_params_int8`."""
    shape = x.shape
    x2 = x.reshape(-1, shape[-1]).to(torch.bfloat16)
    xq, sx = rmsnorm_quant_plain(x2, norm_w, eps)
    g = dequant(i8_matmul(xq, wg["q"]), sx, wg["s"])
    u = dequant(i8_matmul(xq, wu["q"]), sx, wu["s"])
    h = (F.silu(g) * u).to(torch.bfloat16)
    hq, sh = quant_rows_plain(h)
    d = dequant(i8_matmul(hq, wd["q"]), sh, wd["s"]).to(torch.bfloat16)
    return (x2 + d).reshape(shape)


def fused_attn_int8_layer_plain(x, layer: dict, lq: dict, attention_mask, rope_cs, cfg):
    """x + o_proj(attention(qkv_proj(RMSNorm(x)))), with the kernels'
    casts: q/k/v dequantized to bf16, the attention core's plain version,
    the output requantized per token."""
    b, s, d = x.shape
    xb = x.to(torch.bfloat16)
    xq, sx = rmsnorm_quant_plain(xb, layer["attn_norm"], cfg.rms_norm_eps)
    q, k, v = (dequant(i8_matmul(xq, lq[n]["q"]), sx, lq[n]["s"]).to(torch.bfloat16)
               for n in ("wq", "wk", "wv"))
    ao = fused_qknorm_rope_attention_plain(
        q, k, v, layer["q_norm"], layer["k_norm"], rope_cs[0], rope_cs[1],
        attention_mask.to(torch.int32), num_heads=cfg.num_heads,
        num_kv_heads=cfg.num_kv_heads, head_dim=cfg.head_dim, eps=cfg.rms_norm_eps,
        causal=True, scale=1.0 / np.sqrt(cfg.head_dim))
    aq, sa = quant_rows_plain(ao)
    o = dequant(i8_matmul(aq, lq["wo"]["q"]), sa, lq["wo"]["s"]).to(torch.bfloat16)
    return xb + o


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def kernel_layout(qlayers: list) -> list:
    """The int8 layers with each weight's K-contiguous copy added as
    "t" ((out, in) int8), the layout the kernels' products read; "q" and
    "s" stay the reference's. A wrapper given a layer without "t" makes
    the copy on every call."""
    return [{name: {**w, "t": w["q"].t().contiguous()} for name, w in lq.items()}
            for lq in qlayers]


def _weight(w: dict, dev) -> tuple[torch.Tensor, torch.Tensor]:
    t = w.get("t")
    if t is None:
        t = w["q"].t().contiguous()
    s = w["s"].to(dev, torch.float32).contiguous()
    if t.dtype != torch.int8 or t.device != dev or not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"int8 weights must be contiguous, 16-byte aligned int8 on {dev}")
    return t, s


def _stream(dev) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)


def _inference_only(what: str, *tensors) -> None:
    """B3 and B4 have no backward: under grad, an input that requires
    grad would get none from the kernel, silently. Raise instead, on any
    device, so a CPU run fails where the card would."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise ValueError(f"{what}: int8 serving mode is inference-only (an input requires grad)")


def _check_x(x: torch.Tensor, what: str) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {x.device}")
    if x.dtype != torch.bfloat16 or not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError(f"{what}: x must be contiguous, 16-byte aligned bf16, got {x.dtype}")


def fused_mlp_int8_layer(
    x: torch.Tensor,          # (B, S, D) or (T, D) bf16, pre-norm residual stream
    norm_w: torch.Tensor,     # (D,) mlp pre-norm weight
    wg: dict,                 # {"q": (D, I) int8, "s": (I,) f32[, "t": (I, D) int8]}
    wu: dict,
    wd: dict,                 # {"q": (I, D) int8, "s": (D,) f32[, "t": (D, I) int8]}
    *,
    eps: float = 1e-6,
    stages: dict | None = None,
) -> torch.Tensor:
    """x + SwiGLU_int8(RMSNorm(x)), bf16 of x's shape. On the card one
    call runs four kernels: norm + quant, gate/up products with the GLU
    epilogue, requant, down product with the residual add. `stages`, if
    given, receives the intermediates ("xq", "sx", "h", "hq", "sh")."""
    _inference_only("fused_mlp_int8_layer", x, norm_w)
    if x.device.type == "cpu":
        return fused_mlp_int8_layer_plain(x, norm_w, wg, wu, wd, eps=eps)
    _check_x(x, "fused_mlp_int8_layer")
    dev = x.device
    shape = x.shape
    d = shape[-1]
    t = x.numel() // d
    wg_t, sg = _weight(wg, dev)
    wu_t, su = _weight(wu, dev)
    wd_t, sd = _weight(wd, dev)
    i = wg_t.shape[0]
    if (d % 128 or i % 128 or wg_t.shape != (i, d) or wu_t.shape != (i, d)
            or wd_t.shape != (d, i) or t < 1):
        raise ValueError(f"fused_mlp_int8_layer: want D, I multiples of 128; got D={d}, "
                         f"wg {tuple(wg_t.shape)}, wu {tuple(wu_t.shape)}, wd {tuple(wd_t.shape)}")
    nw = norm_w.to(dev, torch.float32).contiguous()
    out = torch.empty_like(x)
    xq = torch.empty((t, d), dtype=torch.int8, device=dev)
    sx = torch.empty((t,), dtype=torch.float32, device=dev)
    h = torch.empty((t, i), dtype=torch.bfloat16, device=dev)
    hq = torch.empty((t, i), dtype=torch.int8, device=dev)
    sh = torch.empty((t,), dtype=torch.float32, device=dev)
    lib = load()
    err = lib.ts_mlp_int8_layer(
        x.data_ptr(), nw.data_ptr(), wg_t.data_ptr(), wu_t.data_ptr(), wd_t.data_ptr(),
        sg.data_ptr(), su.data_ptr(), sd.data_ptr(), out.data_ptr(), xq.data_ptr(),
        sx.data_ptr(), h.data_ptr(), hq.data_ptr(), sh.data_ptr(), t, d, i, float(eps),
        _stream(dev))
    check(lib, err, "fused_mlp_int8_layer")
    mlp_int8_launches.bump()
    if stages is not None:
        stages.update(xq=xq, sx=sx, h=h, hq=hq, sh=sh)
    return out


def fused_attn_int8_layer(
    x: torch.Tensor,          # (B, S, D) bf16 residual stream
    layer: dict,              # bf16 layer params (the norm weights)
    lq: dict,                 # int8 weights from quantize_params_int8 (+ "t")
    attention_mask: torch.Tensor,   # (B, S)
    rope_cs: tuple,           # (cos, sin), each (B, S, Dh//2) f32
    cfg,                      # EncoderConfig
    *,
    stages: dict | None = None,
) -> torch.Tensor:
    """x + o_proj(attention(qkv_proj(RMSNorm(x)))), bf16 (B, S, D). On
    the card: norm + quant and the q/k/v products (one kernel each), the
    attention core (kernel B2, `fused_qknorm_rope_attention`), then the
    requant and the o product with the residual add. `stages`, if given,
    receives the intermediates ("xq", "sx", "q", "k", "v", "ao", "aq",
    "sa")."""
    _inference_only("fused_attn_int8_layer", x, layer["attn_norm"], layer["q_norm"], layer["k_norm"])
    if x.device.type == "cpu":
        return fused_attn_int8_layer_plain(x, layer, lq, attention_mask, rope_cs, cfg)
    _check_x(x, "fused_attn_int8_layer")
    dev = x.device
    b, s, d = x.shape
    t = b * s
    h, hk, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    hq_d, hk_d = h * dh, hk * dh
    wq_t, sq = _weight(lq["wq"], dev)
    wk_t, sk = _weight(lq["wk"], dev)
    wv_t, sv = _weight(lq["wv"], dev)
    wo_t, so = _weight(lq["wo"], dev)
    if (d % 128 or hq_d % 128 or hk_d % 128 or wq_t.shape != (hq_d, d)
            or wk_t.shape != (hk_d, d) or wv_t.shape != (hk_d, d) or wo_t.shape != (d, hq_d)):
        raise ValueError(f"fused_attn_int8_layer: weights do not fit D={d}, {h}/{hk} heads of {dh}")
    nw = layer["attn_norm"].to(dev, torch.float32).contiguous()
    xq = torch.empty((t, d), dtype=torch.int8, device=dev)
    sx = torch.empty((t,), dtype=torch.float32, device=dev)
    q = torch.empty((b, s, hq_d), dtype=torch.bfloat16, device=dev)
    k = torch.empty((b, s, hk_d), dtype=torch.bfloat16, device=dev)
    v = torch.empty((b, s, hk_d), dtype=torch.bfloat16, device=dev)
    lib = load()
    err = lib.ts_attn_int8_qkv(
        x.data_ptr(), nw.data_ptr(), wq_t.data_ptr(), wk_t.data_ptr(), wv_t.data_ptr(),
        sq.data_ptr(), sk.data_ptr(), sv.data_ptr(), q.data_ptr(), k.data_ptr(), v.data_ptr(),
        xq.data_ptr(), sx.data_ptr(), t, d, hq_d, hk_d, float(cfg.rms_norm_eps), _stream(dev))
    check(lib, err, "fused_attn_int8_layer (norm, quant, q/k/v)")
    ao = fused_qknorm_rope_attention(
        q, k, v, layer["q_norm"], layer["k_norm"], rope_cs[0], rope_cs[1],
        attention_mask.to(torch.int32), num_heads=h, num_kv_heads=hk, head_dim=dh,
        eps=cfg.rms_norm_eps, causal=True, scale=1.0 / np.sqrt(dh))
    out = torch.empty_like(x)
    aq = torch.empty((t, hq_d), dtype=torch.int8, device=dev)
    sa = torch.empty((t,), dtype=torch.float32, device=dev)
    err = lib.ts_attn_int8_out(
        ao.data_ptr(), wo_t.data_ptr(), so.data_ptr(), x.data_ptr(), out.data_ptr(),
        aq.data_ptr(), sa.data_ptr(), t, hq_d, d, _stream(dev))
    check(lib, err, "fused_attn_int8_layer (requant, o)")
    attn_int8_launches.bump()
    if stages is not None:
        stages.update(xq=xq, sx=sx, q=q, k=k, v=v, ao=ao, aq=aq, sa=sa)
    return out
