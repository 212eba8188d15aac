// Whole-layer int8 (w8a8) encoder blocks: the MLP sub-block (B4) and the
// two int8 halves of the attention sub-block (B3) around the fused
// attention core of attention.cu (B2).
//
// Replaces the TPU kernels theoremsearch_tpu/kernels/layer_int8.py:
// _mlp_kernel (driven by fused_mlp_int8_layer) and _attn_layer_kernel
// (driven by fused_attn_int8_layer and fused_attn_int8_layer_gemma), in
// both of their forms: the qwen form (pre-norm only, SwiGLU, causal
// attention) and the gemma form (sandwich post-norms with (1 + w) weights,
// GeGLU with the tanh GELU, bidirectional attention at head_dim 256).
//
//   ts_mlp_int8_layer   x -> RMSNorm + per-token quant -> gate/up int8
//                       products, dequant, act(g) * u -> bf16 h -> per-row
//                       requant -> down int8 product, dequant -> [post-norm]
//                       -> bf16 residual add
//   ts_attn_int8_qkv    x -> RMSNorm + per-token quant -> q/k/v int8
//                       products dequantized to bf16
//   ts_attn_int8_out    attention output (bf16) -> per-row requant -> o int8
//                       product, dequant -> [post-norm] -> bf16 residual add
//
// Numerics are the plain version's (kernels/layer_int8.py), operation by
// operation:
//   - norm: the sum of squares in f64, rounded to f32 (so kernel and
//     plain agree whatever their summation order), r = rsqrtf(ss * (1/D) +
//     eps) (torch.rsqrt's CUDA form), m = max|x * w| * r,
//     s = max(m * f32(1/127), 1e-12), codes rint((x * (r / s)) * w)
//     clipped to +-127 -- bit-equal to the plain version on the card;
//   - requant: s = max(max|h| * f32(1/127), 1e-12), codes rint(h / s);
//   - products: exact int8 x int8 -> int32 on the tensor cores, then
//     (__int2float_rn(acc) * row scale) * column scale in f32 (|acc| can
//     pass 2^24 at K = 3072, so the conversion rounds, as float() of the
//     plain version's exact f64 sum does);
//   - SiLU as torch computes it on the card, g / (1 + expf(-g)); the tanh
//     GELU in the plain version's operation order (`gelu_tanh`, the
//     reference's jax.nn.gelu order): x * (0.5 * (1 + tanhf(c * (x +
//     0.044715 * ((x * x) * x))))), c = f32(sqrt(2 / pi)); h and the block
//     outputs rounded to bf16; the residual add bf16 + bf16 in f32, rounded
//     to bf16;
//   - the gemma post-norm on the bf16 block output y: the sum of squares
//     in f64 as above, r = rsqrtf(ss * (1/D) + eps), bf16((y * r) * pw).
// Built with -fmad=false, so no multiply-add is contracted.
//
// What bounds it on an H100: at the serving shapes (T = B * S = 32,768
// tokens, D = 1024, I = 3072, 16/8 heads of 128) the products are
// 6 * T * D * I = 6.2e11 int8 operations for the MLP and
// 2 * T * D * (2 * 2048 + 2 * 1024) = 4.1e11 for the attention block's
// projections, against ~0.3 GB of activations: the int8 tensor cores bound
// both. The TPU kernels copied all int8 weights (9.4 MB MLP, 6 MB
// attention) into VMEM once and streamed 128-token tiles past them. A
// Hopper block has at most 227 KB of shared memory, so here the weights
// stay in the 50 MB L2: each product's grid runs its column tiles fastest,
// so the blocks in flight share one token tile and read the whole weight
// matrix from L2. Each product is one block of eight warps per (128-token,
// 128-column) tile: 64-byte K slices of the token tile and of the 128
// weight rows (weights stored K-contiguous, (N, K)) stream through a
// two-stage cp.async ring in shared memory into mma.sync m16n8k32 s8;
// each warp owns a 32 x 64 accumulator tile. The gate/up product loads
// 64 gate rows and the same 64 up rows into one tile, so each thread holds
// g and u of the same (token, column) and the GLU is its epilogue.
//
// The per-token requant needs a whole row's absmax first (I = 3072 of h,
// 2048 of the attention output), so the norm + quant and the requant are
// passes of their own (one warp a row) and the intermediates h, their
// codes and the q/k/v projections go through device memory. The gemma
// post-norm needs a whole row of the product too (it normalizes over D),
// so it cannot be a tile epilogue either: with a post-norm the down/o
// product writes its bf16 output and a one-warp-a-row pass applies the
// norm and the residual add (the gemma shapes, D = 768 and I = 1152 at
// T = 32,768 tokens, are 1.7e11 int8 operations for the MLP). Fusing
// these passes away, and wgmma/TMA for the products, are later work.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "int8_mma.cuh"

namespace {

constexpr int BM = 128;        // tokens per product block
constexpr int BN = 128;        // weight rows per product block
constexpr int BK = 64;         // K bytes per pipeline stage
constexpr int SSTR = BK + 16;  // padded shared row: 20 words, conflict-free
constexpr int THREADS = 256;   // 8 warps: 4 (tokens) x 2 (weight rows)
constexpr int ROWS_PER_BLOCK = THREADS / 32;   // row passes: one warp a row
constexpr float INV127 = 1.0f / 127.0f;        // what XLA makes of m / 127
constexpr float MIN_SCALE = 1e-12f;

enum { EPI_BF16 = 0, EPI_GLU = 1, EPI_RESIDUAL = 2, EPI_GEGLU = 3 };
constexpr float SQRT_2_OVER_PI = 0.7978845608028654f;

__device__ __forceinline__ float gelu_tanh(float x) {
  const float x3 = (x * x) * x;
  return x * (0.5f * (1.0f + tanhf(SQRT_2_OVER_PI * (x + 0.044715f * x3))));
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ uint32_t quant4(const float (&v)[4], float mul_a, const float* w,
                                           float div_s) {
  // four codes packed little-endian; w == nullptr: rint(v / div_s),
  // else rint((v * mul_a) * w)
  uint32_t packed = 0;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float t = w ? (v[e] * mul_a) * w[e] : v[e] / div_s;
    const int c = min(max(__float2int_rn(t), -127), 127);
    packed |= (uint32_t)(uint8_t)(int8_t)c << (8 * e);
  }
  return packed;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&v)[4]) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
}

// RMSNorm fused with the per-token int8 quant: codes of x * r * w and the
// row's scale, the normed row never formed. One warp a row; D % 128 == 0.
__global__ void __launch_bounds__(THREADS) rmsnorm_quant_kernel(
    const __nv_bfloat16* __restrict__ x, const float* __restrict__ w,
    int8_t* __restrict__ q, float* __restrict__ scale, int T, int D, float eps) {
  const int row = blockIdx.x * ROWS_PER_BLOCK + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= T) return;
  const __nv_bfloat16* xr = x + (size_t)row * D;
  double ss = 0.0;
  float mx = 0.0f;
  for (int c = 4 * lane; c < D; c += 128) {
    float v[4];
    load4(xr + c, v);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      ss += (double)(v[e] * v[e]);
      mx = fmaxf(mx, fabsf(v[e]) * fabsf(w[c + e]));
    }
  }
  ss = warp_sum(ss);
  mx = warp_max(mx);
  const float r = rsqrtf((float)ss * (1.0f / (float)D) + eps);
  const float s = fmaxf(mx * r * INV127, MIN_SCALE);
  const float rs = r / s;
  for (int c = 4 * lane; c < D; c += 128) {
    float v[4];
    load4(xr + c, v);
    *reinterpret_cast<uint32_t*>(q + (size_t)row * D + c) = quant4(v, rs, w + c, 1.0f);
  }
  if (lane == 0) scale[row] = s;
}

// Per-row int8 quant of a bf16 (T, W) matrix: one warp a row; W % 128 == 0.
__global__ void __launch_bounds__(THREADS) row_quant_kernel(
    const __nv_bfloat16* __restrict__ x, int8_t* __restrict__ q, float* __restrict__ scale,
    int T, int W) {
  const int row = blockIdx.x * ROWS_PER_BLOCK + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= T) return;
  const __nv_bfloat16* xr = x + (size_t)row * W;
  float mx = 0.0f;
  for (int c = 4 * lane; c < W; c += 128) {
    float v[4];
    load4(xr + c, v);
#pragma unroll
    for (int e = 0; e < 4; ++e) mx = fmaxf(mx, fabsf(v[e]));
  }
  mx = warp_max(mx);
  const float s = fmaxf(mx * INV127, MIN_SCALE);
  for (int c = 4 * lane; c < W; c += 128) {
    float v[4];
    load4(xr + c, v);
    *reinterpret_cast<uint32_t*>(q + (size_t)row * W + c) = quant4(v, 0.0f, nullptr, s);
  }
  if (lane == 0) scale[row] = s;
}

// The gemma post-norm and residual add: out = bf16(x + bf16((y * r) * pw))
// with r the RMSNorm of the bf16 block output y. One warp a row; D % 128 == 0.
__global__ void __launch_bounds__(THREADS) post_norm_residual_kernel(
    const __nv_bfloat16* __restrict__ y, const float* __restrict__ pw,
    const __nv_bfloat16* __restrict__ x, __nv_bfloat16* __restrict__ out, int T, int D,
    float eps) {
  const int row = blockIdx.x * ROWS_PER_BLOCK + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= T) return;
  const __nv_bfloat16* yr = y + (size_t)row * D;
  const __nv_bfloat16* xr = x + (size_t)row * D;
  double ss = 0.0;
  for (int c = 4 * lane; c < D; c += 128) {
    float v[4];
    load4(yr + c, v);
#pragma unroll
    for (int e = 0; e < 4; ++e) ss += (double)(v[e] * v[e]);
  }
  ss = warp_sum(ss);
  const float r = rsqrtf((float)ss * (1.0f / (float)D) + eps);
  for (int c = 4 * lane; c < D; c += 128) {
    float v[4], xv[4];
    load4(yr + c, v);
    load4(xr + c, xv);
    __nv_bfloat162 o[2];
#pragma unroll
    for (int e = 0; e < 4; e += 2) {
      const float a = __bfloat162float(__float2bfloat16((v[e] * r) * pw[c + e]));
      const float b = __bfloat162float(__float2bfloat16((v[e + 1] * r) * pw[c + e + 1]));
      o[e / 2] = __floats2bfloat162_rn(xv[e] + a, xv[e + 1] + b);
    }
    *reinterpret_cast<uint2*>(out + (size_t)row * D + c) = *reinterpret_cast<const uint2*>(o);
  }
}

// out (T, N) bf16 from a (T, K) int8 x (N, K) int8 product with per-token
// scales sa and per-column scales s0, through one of three epilogues:
//   EPI_BF16      out = bf16((acc * sa) * s0)
//   EPI_GLU       out = bf16(silu(g) * u), g from (w0, s0), u from (w1, s1);
//                 a block covers 64 output columns (64 gate + 64 up rows)
//   EPI_GEGLU     out = bf16(gelu_tanh(g) * u), as EPI_GLU
//   EPI_RESIDUAL  out = bf16(res + bf16((acc * sa) * s0))
// Grid: (column tiles, token tiles); tokens past T are zero-filled and
// not stored. N % 128 == 0 (64 for EPI_GLU and EPI_GEGLU), K % 64 == 0.
template <int EPI>
__global__ void __launch_bounds__(THREADS) i8_gemm_kernel(
    const int8_t* __restrict__ a, const float* __restrict__ sa,
    const int8_t* __restrict__ w0, const float* __restrict__ s0,
    const int8_t* __restrict__ w1, const float* __restrict__ s1,
    const __nv_bfloat16* __restrict__ res, __nv_bfloat16* __restrict__ out, int T, int N,
    int K) {
  __shared__ __align__(16) int8_t As[2][BM * SSTR];
  __shared__ __align__(16) int8_t Bs[2][BN * SSTR];
  constexpr bool GLU = EPI == EPI_GLU || EPI == EPI_GEGLU;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int wm = warp & 3, wn = warp >> 2;
  const int gq = lane >> 2, tig = lane & 3;
  constexpr int CT = GLU ? BN / 2 : BN;   // output columns per block
  const int c0 = blockIdx.x * CT;
  const int m0 = blockIdx.y * BM;
  const int nk = K / BK;

  auto load = [&](int st, int k0) {
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const int idx = tid + s * THREADS, r = idx >> 2, kb = (idx & 3) * 16;
      const bool ok = m0 + r < T;
      cp_async16(&As[st][r * SSTR + kb], ok ? a + (size_t)(m0 + r) * K + k0 + kb : a,
                 ok ? 16 : 0);
    }
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const int idx = tid + s * THREADS, r = idx >> 2, kb = (idx & 3) * 16;
      const int8_t* src = GLU
          ? (r < CT ? w0 + (size_t)(c0 + r) * K : w1 + (size_t)(c0 + r - CT) * K)
          : w0 + (size_t)(c0 + r) * K;
      cp_async16(&Bs[st][r * SSTR + kb], src + k0 + kb, 16);
    }
    cp_async_commit();
  };

  // weight row (within the block's 128) of this warp's n8 tile nt: gate
  // tiles 0-3 and up tiles 4-7 of the same columns for the GLU
  auto brow = [&](int nt) {
    return GLU ? (nt >> 2) * CT + wn * 32 + (nt & 3) * 8 : wn * 64 + nt * 8;
  };

  int32_t acc[2][8][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0;

  load(0, 0);
  for (int kc = 0; kc < nk; ++kc) {
    const int st = kc & 1;
    if (kc + 1 < nk) {
      load(st ^ 1, (kc + 1) * BK);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < BK; ks += 32) {
      uint32_t af[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int8_t* p = &As[st][(wm * 32 + mt * 16 + gq) * SSTR + ks + tig * 4];
        af[mt][0] = *reinterpret_cast<const uint32_t*>(p);
        af[mt][1] = *reinterpret_cast<const uint32_t*>(p + 8 * SSTR);
        af[mt][2] = *reinterpret_cast<const uint32_t*>(p + 16);
        af[mt][3] = *reinterpret_cast<const uint32_t*>(p + 8 * SSTR + 16);
      }
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int8_t* p = &Bs[st][(brow(nt) + gq) * SSTR + ks + tig * 4];
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(p);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(p + 16);
        mma_s8(acc[0][nt], af[0], b0, b1);
        mma_s8(acc[1][nt], af[1], b0, b1);
      }
    }
    __syncthreads();  // the next iteration's load overwrites this stage
  }

#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + wm * 32 + mt * 16 + gq + h * 8;
      if (row >= T) continue;
      const float rs = sa[row];
#pragma unroll
      for (int nt = 0; nt < (GLU ? 4 : 8); ++nt) {
        const int col = c0 + brow(nt) + tig * 2;   // brow(nt) < CT for the stored tiles
        float v[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float d = ((float)__int2float_rn(acc[mt][nt][2 * h + e]) * rs) * s0[col + e];
          if (GLU) {
            const float u = ((float)__int2float_rn(acc[mt][nt + 4][2 * h + e]) * rs) * s1[col + e];
            v[e] = (EPI == EPI_GLU ? d / (1.0f + expf(-d)) : gelu_tanh(d)) * u;
          } else {
            v[e] = d;
          }
        }
        __nv_bfloat162 o = __floats2bfloat162_rn(v[0], v[1]);
        if (EPI == EPI_RESIDUAL) {
          const float2 xr = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(res + (size_t)row * N + col));
          const float2 dv = __bfloat1622float2(o);
          o = __floats2bfloat162_rn(xr.x + dv.x, xr.y + dv.y);
        }
        *reinterpret_cast<__nv_bfloat162*>(out + (size_t)row * N + col) = o;
      }
    }
  }
}

int row_blocks(int T) { return (T + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK; }

template <int EPI>
int gemm(const void* a, const void* sa, const void* w0, const void* s0, const void* w1,
         const void* s1, const void* res, void* out, int T, int N, int K,
         cudaStream_t stream) {
  const int ct = (EPI == EPI_GLU || EPI == EPI_GEGLU) ? BN / 2 : BN;
  if (N % ct || K % BK || (T + BM - 1) / BM > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid(N / ct, (T + BM - 1) / BM);
  i8_gemm_kernel<EPI><<<grid, THREADS, 0, stream>>>(
      (const int8_t*)a, (const float*)sa, (const int8_t*)w0, (const float*)s0,
      (const int8_t*)w1, (const float*)s1, (const __nv_bfloat16*)res, (__nv_bfloat16*)out,
      T, N, K);
  return (int)cudaGetLastError();
}

int rmsnorm_quant(const void* x, const void* w, void* q, void* s, int T, int D, float eps,
                  cudaStream_t stream) {
  rmsnorm_quant_kernel<<<row_blocks(T), THREADS, 0, stream>>>(
      (const __nv_bfloat16*)x, (const float*)w, (int8_t*)q, (float*)s, T, D, eps);
  return (int)cudaGetLastError();
}

int row_quant(const void* x, void* q, void* s, int T, int W, cudaStream_t stream) {
  row_quant_kernel<<<row_blocks(T), THREADS, 0, stream>>>(
      (const __nv_bfloat16*)x, (int8_t*)q, (float*)s, T, W);
  return (int)cudaGetLastError();
}

int post_norm_residual(const void* y, const void* pw, const void* x, void* out, int T, int D,
                       float eps, cudaStream_t stream) {
  post_norm_residual_kernel<<<row_blocks(T), THREADS, 0, stream>>>(
      (const __nv_bfloat16*)y, (const float*)pw, (const __nv_bfloat16*)x, (__nv_bfloat16*)out,
      T, D, eps);
  return (int)cudaGetLastError();
}

// the down / o product and the residual add: straight after the product
// (pw == nullptr), or through bf16 y and the post-norm pass
int product_residual(const void* a, const void* sa, const void* w, const void* sw,
                     const void* x, const void* pw, void* y, void* out, int T, int N, int K,
                     float eps, cudaStream_t st) {
  if (!pw) return gemm<EPI_RESIDUAL>(a, sa, w, sw, nullptr, nullptr, x, out, T, N, K, st);
  int err = gemm<EPI_BF16>(a, sa, w, sw, nullptr, nullptr, nullptr, y, T, N, K, st);
  if (!err) err = post_norm_residual(y, pw, x, out, T, N, eps, st);
  return err;
}

bool dims_ok(int T, int a, int b) { return T >= 1 && a % 128 == 0 && b % 128 == 0; }

}  // namespace

// x (T, D) bf16 -> out (T, D) bf16 = x + [post_norm](MLP_int8(RMSNorm(x))).
// wg, wu (I, D) and wd (D, I) int8, K-contiguous; sg, su (I,), sd (D,) f32
// column scales; act 0 = SiLU, 1 = tanh GELU; pw (D,) f32 the post-norm
// weight or null; xq (T, D), sx (T,), h (T, I) bf16, hq (T, I), sh (T,) and
// y (T, D) bf16 (used with pw only) are scratch.
extern "C" int ts_mlp_int8_layer(const void* x, const void* nw, const void* wg, const void* wu,
                                 const void* wd, const void* sg, const void* su,
                                 const void* sd, const void* pw, void* out, void* xq, void* sx,
                                 void* h, void* hq, void* sh, void* y, int T, int D, int I,
                                 int act, float eps, void* stream) {
  if (!dims_ok(T, D, I) || act < 0 || act > 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  int err = rmsnorm_quant(x, nw, xq, sx, T, D, eps, st);
  if (!err)
    err = act ? gemm<EPI_GEGLU>(xq, sx, wg, sg, wu, su, nullptr, h, T, I, D, st)
              : gemm<EPI_GLU>(xq, sx, wg, sg, wu, su, nullptr, h, T, I, D, st);
  if (!err) err = row_quant(h, hq, sh, T, I, st);
  if (!err) err = product_residual(hq, sh, wd, sd, x, pw, y, out, T, D, I, eps, st);
  return err;
}

// x (T, D) bf16 -> q (T, HQ), k, v (T, HK) bf16 projections of
// RMSNorm(x), through int8 codes xq (T, D) and scales sx (T,). wq (HQ, D),
// wk, wv (HK, D) int8, K-contiguous; sq, sk, sv their column scales.
extern "C" int ts_attn_int8_qkv(const void* x, const void* nw, const void* wq, const void* wk,
                                const void* wv, const void* sq, const void* sk,
                                const void* sv, void* q, void* k, void* v, void* xq, void* sx,
                                int T, int D, int HQ, int HK, float eps, void* stream) {
  if (!dims_ok(T, D, HQ) || HK % 128) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  int err = rmsnorm_quant(x, nw, xq, sx, T, D, eps, st);
  if (!err) err = gemm<EPI_BF16>(xq, sx, wq, sq, nullptr, nullptr, nullptr, q, T, HQ, D, st);
  if (!err) err = gemm<EPI_BF16>(xq, sx, wk, sk, nullptr, nullptr, nullptr, k, T, HK, D, st);
  if (!err) err = gemm<EPI_BF16>(xq, sx, wv, sv, nullptr, nullptr, nullptr, v, T, HK, D, st);
  return err;
}

// ao (T, HQ) bf16 attention output -> out (T, D) bf16 = x +
// [post_norm](o_proj(ao)), through codes aq (T, HQ) and scales sa (T,). wo
// (D, HQ) int8, K-contiguous; pw (D,) f32 the post-norm weight or null; y
// (T, D) bf16 scratch (used with pw only).
extern "C" int ts_attn_int8_out(const void* ao, const void* wo, const void* so, const void* x,
                                const void* pw, void* out, void* aq, void* sa, void* y, int T,
                                int HQ, int D, float eps, void* stream) {
  if (!dims_ok(T, D, HQ)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  int err = row_quant(ao, aq, sa, T, HQ, st);
  if (!err) err = product_residual(aq, sa, wo, so, x, pw, y, out, T, D, HQ, eps, st);
  return err;
}
