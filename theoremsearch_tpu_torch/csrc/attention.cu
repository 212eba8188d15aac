// Fused encoder attention: per-head q/k RMSNorm, half-split RoPE, masked
// softmax(q k^T) v, GQA by head index.
//
// Replaces the TPU kernel theoremsearch_tpu/kernels/attention.py:_attn_kernel
// (driven by fused_qknorm_rope_attention), with that kernel's casts:
//   - norm statistics, the norm and RoPE in f32;
//   - q multiplied by `scale` before its bf16 cast; k normed, rotated, cast;
//   - logits f32 (bf16 x bf16 products, f32 sums) plus -1e30 where masked
//     (causal x key padding);
//   - f32 softmax, probabilities cast to bf16;
//   - P V accumulated in f32, the output cast to bf16.
//
// Two forms, one template on the head dim DH: the qwen form (DH = 128,
// causal, 1/sqrt(Dh)) and the gemma form (DH = 256, bidirectional, scale
// query_pre_attn_scalar^-1/2, the (1 + w) norm weights passed with the 1
// already added), which theoremsearch_tpu/encoder/gemma.py:_make_attn_core
// reaches with the same TPU kernel.
//
// What bounds it on an H100: at the serving shapes (S <= 128, Dh = 128) a
// (item, head) pair reads 3 * S * Dh * 2 bytes and does 4 * S^2 * Dh flops --
// 2S/3 flops a byte whatever Dh, ~85 at S = 128, under the ~295 at which the
// bf16 tensor cores would bound it, so it is memory- and latency-bound.
// The TPU kernel packed 128 / S items into one block-diagonal tile to fill
// the MXU; on this card that packing only wastes work, so it is left out.
// One block of sixteen warps takes one (item, q head): it normalises,
// rotates and stages q, k (its kv head) and v in shared memory (<= 100 KB
// at S = 128, Dh = 128), then each warp owns query rows: the lanes take
// keys for the logits (padded rows keep the k reads free of bank
// conflicts), reduce max and sum by shuffles, and take Dh / 32 output
// columns each for P V. Intermediates never touch device memory; q, k, v
// are read once and the output written once. Each row's work is a chain of
// dependent loads, shuffles and f32 adds, so sixteen warps a block (four
// blocks, a full SM, at S = 64) are there to hide latency: with four warps
// the kernel ran 1.43x slower at the encoder's (512, 64) batches on an
// H100 80GB HBM3 at 700 W, with bit-identical output. At DH = 256 and
// S = 128 the staged rows take 2 * 128 * 258 * 2 (q, k) + 128 * 256 * 2 (v)
// + 16 * 128 * 4 (p) + 128 * 4 (mask) = 206,336 bytes, under the 227 KB a
// block may opt into: one block an SM there.
//
// Masked keys (causal, and the right padding of short texts in a width
// bucket) cost no dot and no P V step: a masked logit is set to -1e30,
// which is what dot + (-1e30) rounds to in f32 for any |dot| < 3.8e22, and
// a zero probability adds exactly +0 to the P V sums, so skipping them
// leaves every output bit unchanged.
//
// Built with -fmad=false, so the f32 norm, RoPE and softmax arithmetic
// rounds after every operation, as the plain PyTorch version's unfused
// ops do (the bf16 x bf16 products in the dots are exact in f32 either way).

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int WARPS = 16;  // 4 blocks of 16 warps fill an SM at S = 64 (DH = 128)
constexpr int THREADS = WARPS * 32;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// RMSNorm (f32 stats) + half-split RoPE of one DH row held by a warp: lane
// l holds E = DH / 64 consecutive elements of each half, x[E l + e] and
// x[DH/2 + E l + e] (2 + 2 at DH 128, 4 + 4 at DH 256).
template <int DH>
__device__ __forceinline__ void norm_rope_row(
    const __nv_bfloat16* __restrict__ src, const float* __restrict__ w,
    const float* __restrict__ cs, const float* __restrict__ sn, float eps,
    float post_scale, __nv_bfloat16* dst, int lane) {
  constexpr int HALF = DH / 2;
  constexpr int E = DH / 64;
  const int d = E * lane;
  float x1[E], x2[E];
#pragma unroll
  for (int e = 0; e < E; e += 2) {
    const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(src + d + e);
    const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(src + HALF + d + e);
    x1[e] = __low2float(lo);
    x1[e + 1] = __high2float(lo);
    x2[e] = __low2float(hi);
    x2[e + 1] = __high2float(hi);
  }
  float ss = x1[0] * x1[0];
#pragma unroll
  for (int e = 1; e < E; ++e) ss += x1[e] * x1[e];
#pragma unroll
  for (int e = 0; e < E; ++e) ss += x2[e] * x2[e];
  ss = warp_sum(ss);
  const float r = rsqrtf(ss / (float)DH + eps);   // torch.rsqrt's CUDA form
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const float a = x1[e] * r * w[d + e];
    const float b = x2[e] * r * w[HALF + d + e];
    const float c = cs[d + e], s = sn[d + e];
    dst[d + e] = __float2bfloat16((a * c - b * s) * post_scale);
    dst[HALF + d + e] = __float2bfloat16((b * c + a * s) * post_scale);
  }
}

// Blocks an SM that the register file must hold: three at DH = 128 (<= 40
// registers a thread; with two the kernel ran ~7% slower at (512, 64) on
// an H100 80GB HBM3 at 700 W), two at DH = 256 (<= 64; with one, ~25%
// slower), as many as shared memory allows at S = 64.
template <int DH>
__global__ void __launch_bounds__(THREADS, DH == 128 ? 3 : 2) qknorm_rope_attention_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const float* __restrict__ qw,
    const float* __restrict__ kw, const float* __restrict__ cosv,
    const float* __restrict__ sinv, const int32_t* __restrict__ mask,
    __nv_bfloat16* __restrict__ out, int S, int H, int Hk, float eps,
    float scale, int causal) {
  constexpr int HALF = DH / 2;
  // padded bf16 row of DH + 2: 65 words at DH 128, 129 at DH 256 -- odd,
  // so the lanes' reads of 32 different k rows hit 32 different banks
  constexpr int KSTR = DH + 2;
  constexpr int VC = DH / 32;   // output columns a lane owns in P V: 4 or 8
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);  // S x KSTR
  __nv_bfloat16* Ks = Qs + S * KSTR;                             // S x KSTR
  __nv_bfloat16* Vs = Ks + S * KSTR;                             // S x DH
  float* Ps = reinterpret_cast<float*>(Vs + S * DH);             // WARPS x S
  int32_t* Ms = reinterpret_cast<int32_t*>(Ps + WARPS * S);      // S

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int g = h / (H / Hk);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const size_t qstride = (size_t)H * DH;
  const size_t kstride = (size_t)Hk * DH;

  for (int j = threadIdx.x; j < S; j += THREADS) Ms[j] = mask[(size_t)b * S + j];
  for (int s = warp; s < S; s += WARPS) {
    const size_t tok = (size_t)b * S + s;
    const float* cs = cosv + tok * HALF;
    const float* sn = sinv + tok * HALF;
    norm_rope_row<DH>(q + tok * qstride + (size_t)h * DH, qw, cs, sn, eps, scale,
                      Qs + s * KSTR, lane);
    norm_rope_row<DH>(k + tok * kstride + (size_t)g * DH, kw, cs, sn, eps, 1.0f,
                      Ks + s * KSTR, lane);
    const __nv_bfloat16* vsrc = v + tok * kstride + (size_t)g * DH + VC * lane;
#pragma unroll
    for (int c = 0; c < VC; c += 4)
      *reinterpret_cast<uint2*>(Vs + s * DH + VC * lane + c) =
          *reinterpret_cast<const uint2*>(vsrc + c);
  }
  __syncthreads();

  float* P = Ps + warp * S;
  for (int i = warp; i < S; i += WARPS) {
    const __nv_bfloat162* qrow = reinterpret_cast<const __nv_bfloat162*>(Qs + i * KSTR);
    float logit[4];
    float m = -CUDART_INF_F;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int j = lane + 32 * c;
      logit[c] = -CUDART_INF_F;
      if (j < S) {
        logit[c] = -1e30f;
        if ((!causal || j <= i) && Ms[j] != 0) {
          const __nv_bfloat162* krow = reinterpret_cast<const __nv_bfloat162*>(Ks + j * KSTR);
          float dot = 0.0f;
#pragma unroll 8
          for (int w2 = 0; w2 < HALF; ++w2) {
            const float2 qa = __bfloat1622float2(qrow[w2]);
            const float2 kb = __bfloat1622float2(krow[w2]);
            dot += qa.x * kb.x;
            dot += qa.y * kb.y;
          }
          logit[c] = dot;
        }
        m = fmaxf(m, logit[c]);
      }
    }
    m = warp_max(m);
    float e[4];
    float sum = 0.0f;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      e[c] = (lane + 32 * c < S) ? expf(logit[c] - m) : 0.0f;
      sum += e[c];
    }
    sum = warp_sum(sum);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int j = lane + 32 * c;
      if (j < S) P[j] = __bfloat162float(__float2bfloat16(e[c] / sum));
    }
    __syncwarp();
    float acc[VC];
#pragma unroll
    for (int c = 0; c < VC; ++c) acc[c] = 0.0f;
    for (int j = 0; j < S; ++j) {
      const float p = P[j];
      if (p == 0.0f) continue;  // warp-uniform: every lane reads P[j]
      const __nv_bfloat162* vr = reinterpret_cast<const __nv_bfloat162*>(Vs + j * DH + VC * lane);
#pragma unroll
      for (int c = 0; c < VC / 2; ++c) {
        const float2 vv = __bfloat1622float2(vr[c]);
        acc[2 * c] += p * vv.x;
        acc[2 * c + 1] += p * vv.y;
      }
    }
    __nv_bfloat162* orow = reinterpret_cast<__nv_bfloat162*>(
        out + ((size_t)b * S + i) * qstride + (size_t)h * DH + VC * lane);
#pragma unroll
    for (int c = 0; c < VC / 2; ++c) orow[c] = __floats2bfloat162_rn(acc[2 * c], acc[2 * c + 1]);
    __syncwarp();
  }
}

template <int DH>
int launch(const void* q, const void* k, const void* v, const void* qw, const void* kw,
           const void* cosv, const void* sinv, const void* mask, void* out, int B, int S,
           int H, int Hk, float eps, float scale, int causal, cudaStream_t stream) {
  const size_t smem = (size_t)S * (DH + 2) * 2 * sizeof(__nv_bfloat16) +
                      (size_t)S * DH * sizeof(__nv_bfloat16) +
                      (size_t)WARPS * S * sizeof(float) + (size_t)S * sizeof(int32_t);
  cudaError_t err = cudaFuncSetAttribute(qknorm_rope_attention_kernel<DH>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(H, B);
  qknorm_rope_attention_kernel<DH><<<grid, THREADS, smem, stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v,
      (const float*)qw, (const float*)kw, (const float*)cosv, (const float*)sinv,
      (const int32_t*)mask, (__nv_bfloat16*)out, S, H, Hk, eps, scale, causal);
  return (int)cudaGetLastError();
}

}  // namespace

// Dh 128 (the qwen form) or 256 (the gemma form); S <= 128.
extern "C" int ts_qknorm_rope_attention(
    const void* q, const void* k, const void* v, const void* qw, const void* kw,
    const void* cosv, const void* sinv, const void* mask, void* out, int B, int S,
    int H, int Hk, int Dh, float eps, float scale, int causal, void* stream) {
  if (S < 1 || S > 128 || Hk < 1 || H % Hk) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (Dh == 128)
    return launch<128>(q, k, v, qw, kw, cosv, sinv, mask, out, B, S, H, Hk, eps, scale, causal, st);
  if (Dh == 256)
    return launch<256>(q, k, v, qw, kw, cosv, sinv, mask, out, B, S, H, Hk, eps, scale, causal, st);
  return (int)cudaErrorInvalidValue;
}
