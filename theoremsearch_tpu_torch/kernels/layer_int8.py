"""Whole-layer int8 (w8a8) encoder blocks: the attention sub-block (B3)
and the MLP sub-block (B4), in the qwen form (pre-norm only, SwiGLU,
causal) and the gemma form (sandwich post-norms with (1 + w) weights,
GeGLU with the tanh GELU, bidirectional attention at head_dim 256).

Port of theoremsearch_tpu/kernels/layer_int8.py. Two TPU kernels become
short fixed sequences of hand-written CUDA kernels in
`csrc/layer_int8.cu`:

- `_mlp_kernel` -> `fused_mlp_int8_layer` (plain version
  `fused_mlp_int8_layer_plain`): RMSNorm fused with the per-token int8
  quant -> gate/up int8 products with the act(g)*u epilogue into bf16 h
  (act = SiLU, or the tanh GELU with act="gelu_tanh") -> per-row requant
  of h -> down int8 product, dequant, [the post-norm with post_w] and the
  bf16 residual add;
- `_attn_layer_kernel` -> `fused_attn_int8_layer` and
  `fused_attn_int8_layer_gemma` (plain versions `..._plain`): RMSNorm +
  quant -> q/k/v int8 products dequantized to bf16 -> the fused attention
  core (`kernels/attention.py`, kernel B2; the gemma form at head_dim 256,
  bidirectional) -> per-row requant -> o int8 product, dequant, [the
  gemma post-norm] and the bf16 residual add.

The gemma post-norm normalizes the block output over D, a whole row, so
on the card the down / o product writes bf16 and a one-warp-a-row pass
applies the norm and the residual add.

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
integer below 2^53), never in f32: 127^2 * 3072 > 2^24. The tanh GELU
is written out in the reference's operation order (`gelu_tanh`), which the
kernel's epilogue repeats; the gemma post-norm takes its sum of squares
in f64 like the pre-norm.

A CPU tensor goes to the plain version, a CUDA tensor to the kernels.
Each form counts its own launches (the gemma counters below).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch
import torch.nn.functional as F

from .attention import fused_qknorm_rope_attention, fused_qknorm_rope_attention_plain
from ._build import LaunchCounter, check, load

mlp_int8_launches = LaunchCounter()          # qwen form
attn_int8_launches = LaunchCounter()
mlp_int8_gemma_launches = LaunchCounter()    # gemma form
attn_int8_gemma_launches = LaunchCounter()

_INV127 = 1.0 / 127.0   # exactly f32(1/127) once cast: 0x1.020408p-7
_MIN_SCALE = 1e-12
_SQRT_2_OVER_PI = float(np.float32(np.sqrt(2 / np.pi)))

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


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """The tanh GELU in the reference's operation order
    (jax.nn.gelu(approximate=True)): x * (0.5 * (1 + tanh(c * (x + 0.044715
    x^3)))), c = f32(sqrt(2 / pi)); the kernel's GeGLU epilogue repeats it
    operation by operation."""
    x3 = x * x * x
    return x * (0.5 * (1.0 + torch.tanh(_SQRT_2_OVER_PI * (x + 0.044715 * x3))))


_GLU_ACTS = {"silu": F.silu, "gelu_tanh": gelu_tanh}


def _act(act: str):
    if act not in _GLU_ACTS:
        raise ValueError(f"unknown glu activation {act!r}")
    return _GLU_ACTS[act]


def post_norm_plain(y: torch.Tensor, pw: torch.Tensor, eps: float) -> torch.Tensor:
    """The gemma sandwich post-norm of a block output, with the kernel's
    casts: y rounded to bf16, its RMSNorm (sum of squares in f64, as the
    pre-norm's) times the pre-adjusted (1 + w) weight, rounded to bf16."""
    yb = y.to(torch.bfloat16).float()
    ss = (yb * yb).double().sum(dim=-1, keepdim=True).float()
    r = torch.rsqrt(ss * (1.0 / yb.shape[-1]) + eps)
    return (yb * r * pw.float()).to(torch.bfloat16)


def _block_out(y: torch.Tensor, post_w, eps: float) -> torch.Tensor:
    """A block's bf16 output: y itself, or its post-norm."""
    return y.to(torch.bfloat16) if post_w is None else post_norm_plain(y, post_w, eps)


def fused_mlp_int8_layer_plain(x, norm_w, wg: dict, wu: dict, wd: dict, post_w=None, *,
                               eps: float = 1e-6, act: str = "silu"):
    """x + [post_norm](GLU_int8(RMSNorm(x))), with the kernels' casts.
    `wg`, `wu`, `wd` are {"q": (in, out) int8, "s": (out,) f32} from
    `encoder/model.py:quantize_params_int8`; qwen form act="silu",
    post_w=None; gemma form act="gelu_tanh" with norm_w and post_w
    pre-adjusted (1 + w)."""
    fn = _act(act)
    shape = x.shape
    x2 = x.reshape(-1, shape[-1]).to(torch.bfloat16)
    xq, sx = rmsnorm_quant_plain(x2, norm_w, eps)
    g = dequant(i8_matmul(xq, wg["q"]), sx, wg["s"])
    u = dequant(i8_matmul(xq, wu["q"]), sx, wu["s"])
    h = (fn(g) * u).to(torch.bfloat16)
    hq, sh = quant_rows_plain(h)
    d = _block_out(dequant(i8_matmul(hq, wd["q"]), sh, wd["s"]), post_w, eps)
    return (x2 + d).reshape(shape)


def _attn_layer_plain(x, norm_w, q_norm_w, k_norm_w, lq: dict, attention_mask, rope_cs, cfg,
                      causal: bool, scale: float, post_w=None):
    b, s, d = x.shape
    xb = x.to(torch.bfloat16)
    xq, sx = rmsnorm_quant_plain(xb, norm_w, cfg.rms_norm_eps)
    q, k, v = (dequant(i8_matmul(xq, lq[n]["q"]), sx, lq[n]["s"]).to(torch.bfloat16)
               for n in ("wq", "wk", "wv"))
    ao = fused_qknorm_rope_attention_plain(
        q, k, v, q_norm_w, k_norm_w, rope_cs[0], rope_cs[1],
        attention_mask.to(torch.int32), num_heads=cfg.num_heads,
        num_kv_heads=cfg.num_kv_heads, head_dim=cfg.head_dim, eps=cfg.rms_norm_eps,
        causal=causal, scale=scale)
    aq, sa = quant_rows_plain(ao)
    return xb + _block_out(dequant(i8_matmul(aq, lq["wo"]["q"]), sa, lq["wo"]["s"]), post_w,
                           cfg.rms_norm_eps)


def _gemma_attn_args(layer: dict, cfg) -> dict:
    """The gemma form's arguments: the (1 + w) norm weights pre-adjusted
    (as theoremsearch_tpu/kernels/layer_int8.py:522-532 passes them),
    bidirectional, scale query_pre_attn_scalar^-1/2."""
    one = lambda w: w.float() + 1.0  # noqa: E731
    return dict(norm_w=one(layer["attn_norm"]), q_norm_w=one(layer["q_norm"]),
                k_norm_w=one(layer["k_norm"]), post_w=one(layer["post_attn_norm"]),
                causal=False, scale=float(cfg.query_pre_attn_scalar) ** -0.5)


def fused_attn_int8_layer_plain(x, layer: dict, lq: dict, attention_mask, rope_cs, cfg):
    """x + o_proj(attention(qkv_proj(RMSNorm(x)))), with the kernels'
    casts: q/k/v dequantized to bf16, the attention core's plain version,
    the output requantized per token."""
    return _attn_layer_plain(x, layer["attn_norm"], layer["q_norm"], layer["k_norm"], lq,
                             attention_mask, rope_cs, cfg, causal=True,
                             scale=1.0 / np.sqrt(cfg.head_dim))


def fused_attn_int8_layer_gemma_plain(x, layer: dict, lq: dict, attention_mask, rope_cs, cfg):
    """The gemma sandwich attention block, x + post_attn_norm(o_proj(
    bidirectional_attention(qkv_proj(attn_norm(x))))), with the kernels'
    casts."""
    kw = _gemma_attn_args(layer, cfg)
    return _attn_layer_plain(x, kw.pop("norm_w"), kw.pop("q_norm_w"), kw.pop("k_norm_w"), lq,
                             attention_mask, rope_cs, cfg, **kw)


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


def _post_norm_args(post_w, dev, t: int, d: int):
    """(post-norm weight, bf16 (t, d) scratch for the product), or (None,
    None) without a post-norm."""
    if post_w is None:
        return None, None
    pw = post_w.to(dev, torch.float32).contiguous()
    if pw.shape != (d,):
        raise ValueError(f"post_w must be ({d},), got {tuple(pw.shape)}")
    return pw, torch.empty((t, d), dtype=torch.bfloat16, device=dev)


def _ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


def _check_x(x: torch.Tensor, what: str) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {x.device}")
    if x.dtype != torch.bfloat16 or not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError(f"{what}: x must be contiguous, 16-byte aligned bf16, got {x.dtype}")


def fused_mlp_int8_layer(
    x: torch.Tensor,          # (B, S, D) or (T, D) bf16, pre-norm residual stream
    norm_w: torch.Tensor,     # (D,) mlp pre-norm weight (gemma: pass 1 + w)
    wg: dict,                 # {"q": (D, I) int8, "s": (I,) f32[, "t": (I, D) int8]}
    wu: dict,
    wd: dict,                 # {"q": (I, D) int8, "s": (D,) f32[, "t": (D, I) int8]}
    post_w: torch.Tensor | None = None,   # (D,) sandwich post-norm (1 + w), or None
    *,
    eps: float = 1e-6,
    act: str = "silu",
    stages: dict | None = None,
) -> torch.Tensor:
    """x + [post_norm](GLU_int8(RMSNorm(x))), bf16 of x's shape; qwen form
    act="silu", post_w=None; gemma form act="gelu_tanh" with post_w. On
    the card one call runs four kernels (norm + quant, gate/up products
    with the GLU epilogue, requant, down product with the residual add),
    five with post_w (the down product writes bf16, then the post-norm +
    residual pass). `stages`, if given, receives the intermediates ("xq",
    "sx", "h", "hq", "sh")."""
    _act(act)
    _inference_only("fused_mlp_int8_layer", x, norm_w, *([] if post_w is None else [post_w]))
    if x.device.type == "cpu":
        return fused_mlp_int8_layer_plain(x, norm_w, wg, wu, wd, post_w, eps=eps, act=act)
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
    pw, y = _post_norm_args(post_w, dev, t, d)
    out = torch.empty_like(x)
    xq = torch.empty((t, d), dtype=torch.int8, device=dev)
    sx = torch.empty((t,), dtype=torch.float32, device=dev)
    h = torch.empty((t, i), dtype=torch.bfloat16, device=dev)
    hq = torch.empty((t, i), dtype=torch.int8, device=dev)
    sh = torch.empty((t,), dtype=torch.float32, device=dev)
    lib = load()
    # the launch and cudaFuncSetAttribute act on the current device
    with torch.cuda.device(dev):
        err = lib.ts_mlp_int8_layer(
            x.data_ptr(), nw.data_ptr(), wg_t.data_ptr(), wu_t.data_ptr(), wd_t.data_ptr(),
            sg.data_ptr(), su.data_ptr(), sd.data_ptr(), _ptr(pw), out.data_ptr(), xq.data_ptr(),
            sx.data_ptr(), h.data_ptr(), hq.data_ptr(), sh.data_ptr(), _ptr(y), t, d, i,
            int(act == "gelu_tanh"), float(eps), _stream(dev))
    check(lib, err, "fused_mlp_int8_layer")
    gemma = act == "gelu_tanh" or post_w is not None
    (mlp_int8_gemma_launches if gemma else mlp_int8_launches).bump()
    if stages is not None:
        stages.update(xq=xq, sx=sx, h=h, hq=hq, sh=sh)
    return out


def _attn_layer(x, norm_w, q_norm_w, k_norm_w, lq: dict, attention_mask, rope_cs, cfg,
                causal: bool, scale: float, post_w, stages: dict | None, what: str) -> torch.Tensor:
    """The attention block on the card: norm + quant and the q/k/v
    products, kernel B2, then the requant and the o product with the
    [post-norm and] residual add."""
    _check_x(x, what)
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
        raise ValueError(f"{what}: weights do not fit D={d}, {h}/{hk} heads of {dh}")
    nw = norm_w.to(dev, torch.float32).contiguous()
    xq = torch.empty((t, d), dtype=torch.int8, device=dev)
    sx = torch.empty((t,), dtype=torch.float32, device=dev)
    q = torch.empty((b, s, hq_d), dtype=torch.bfloat16, device=dev)
    k = torch.empty((b, s, hk_d), dtype=torch.bfloat16, device=dev)
    v = torch.empty((b, s, hk_d), dtype=torch.bfloat16, device=dev)
    eps = float(cfg.rms_norm_eps)
    lib = load()
    # the launch and cudaFuncSetAttribute act on the current device
    with torch.cuda.device(dev):
        err = lib.ts_attn_int8_qkv(
            x.data_ptr(), nw.data_ptr(), wq_t.data_ptr(), wk_t.data_ptr(), wv_t.data_ptr(),
            sq.data_ptr(), sk.data_ptr(), sv.data_ptr(), q.data_ptr(), k.data_ptr(), v.data_ptr(),
            xq.data_ptr(), sx.data_ptr(), t, d, hq_d, hk_d, eps, _stream(dev))
    check(lib, err, f"{what} (norm, quant, q/k/v)")
    ao = fused_qknorm_rope_attention(
        q, k, v, q_norm_w, k_norm_w, rope_cs[0], rope_cs[1],
        attention_mask.to(torch.int32), num_heads=h, num_kv_heads=hk, head_dim=dh,
        eps=eps, causal=causal, scale=scale)
    pw, y = _post_norm_args(post_w, dev, t, d)
    out = torch.empty_like(x)
    aq = torch.empty((t, hq_d), dtype=torch.int8, device=dev)
    sa = torch.empty((t,), dtype=torch.float32, device=dev)
    # the launch and cudaFuncSetAttribute act on the current device
    with torch.cuda.device(dev):
        err = lib.ts_attn_int8_out(
            ao.data_ptr(), wo_t.data_ptr(), so.data_ptr(), x.data_ptr(), _ptr(pw), out.data_ptr(),
            aq.data_ptr(), sa.data_ptr(), _ptr(y), t, hq_d, d, eps, _stream(dev))
    check(lib, err, f"{what} (requant, o)")
    if stages is not None:
        stages.update(xq=xq, sx=sx, q=q, k=k, v=v, ao=ao, aq=aq, sa=sa)
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
    out = _attn_layer(x, layer["attn_norm"], layer["q_norm"], layer["k_norm"], lq,
                      attention_mask, rope_cs, cfg, True, 1.0 / np.sqrt(cfg.head_dim), None,
                      stages, "fused_attn_int8_layer")
    attn_int8_launches.bump()
    return out


def fused_attn_int8_layer_gemma(
    x: torch.Tensor,          # (B, S, D) bf16 residual stream
    layer: dict,              # gemma layer params (zero-init (1 + w) norms)
    lq: dict,                 # int8 weights from quantize_params_int8 (+ "t")
    attention_mask: torch.Tensor,   # (B, S)
    rope_cs: tuple,           # the layer kind's (cos, sin), each (B, S, Dh//2) f32
    cfg,                      # GemmaEncoderConfig
    *,
    stages: dict | None = None,
) -> torch.Tensor:
    """The gemma sandwich attention block, x + post_attn_norm(o_proj(
    bidirectional_attention(qkv_proj(attn_norm(x))))), bf16 (B, S, D): the
    (1 + w) norm weights pre-adjusted, kernel B2 at head_dim 256 with
    causal=False and scale query_pre_attn_scalar^-1/2, the post-norm pass
    before the residual add. Valid only where the sliding window cannot
    bind (`encoder/gemma.py:_fused_ok` gates the callers)."""
    _inference_only("fused_attn_int8_layer_gemma", x, *(layer[n] for n in (
        "attn_norm", "q_norm", "k_norm", "post_attn_norm")))
    if x.device.type == "cpu":
        return fused_attn_int8_layer_gemma_plain(x, layer, lq, attention_mask, rope_cs, cfg)
    kw = _gemma_attn_args(layer, cfg)
    out = _attn_layer(x, kw["norm_w"], kw["q_norm_w"], kw["k_norm_w"], lq, attention_mask,
                      rope_cs, cfg, kw["causal"], kw["scale"], kw["post_w"], stages,
                      "fused_attn_int8_layer_gemma")
    attn_int8_gemma_launches.bump()
    return out
