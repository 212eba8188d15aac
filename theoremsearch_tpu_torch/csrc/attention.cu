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
// What bounds it on an H100: at the serving shapes (S <= 128, Dh = 128) a
// (item, head) pair reads 3 * S * 256 bytes and does 4 * S^2 * Dh flops --
// about 2.7 flops a byte at S = 128, so it is memory- and latency-bound,
// not tensor-core-bound. The TPU kernel packed 128 / S items into one
// block-diagonal tile to fill the MXU; on this card that packing only
// wastes work, so it is left out. One block of sixteen warps takes one
// (item, q head): it normalises, rotates and stages q, k (its kv head) and v
// in shared memory (<= 100 KB at S = 128), then each warp owns query rows:
// the lanes take keys for the logits (padded rows keep the k reads free of
// bank conflicts), reduce max and sum by shuffles, and take 4 output
// columns each for P V. Intermediates never touch device memory; q, k, v
// are read once and the output written once. Each row's work is a chain of
// dependent loads, shuffles and f32 adds, so sixteen warps a block (four
// blocks, a full SM, at S = 64) are there to hide latency: with four warps
// the kernel ran 1.43x slower at the encoder's (512, 64) batches on an
// H100 80GB HBM3 at 700 W, with bit-identical output.
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

constexpr int DH = 128;
constexpr int HALF = DH / 2;
constexpr int WARPS = 16;  // 4 blocks of 16 warps fill an SM at S = 64
constexpr int THREADS = WARPS * 32;
constexpr int KSTR = DH + 2;  // padded bf16 row: 65 words, conflict-free

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

// RMSNorm (f32 stats) + half-split RoPE of one Dh = 128 row held by a warp:
// lane holds x[2l], x[2l+1] (first half) and x[64+2l], x[64+2l+1].
__device__ __forceinline__ void norm_rope_row(
    const __nv_bfloat16* __restrict__ src, const float* __restrict__ w,
    const float* __restrict__ cs, const float* __restrict__ sn, float eps,
    float post_scale, __nv_bfloat16* dst, int lane) {
  const int d = 2 * lane;
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(src + d);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(src + HALF + d);
  float x1[2] = {__low2float(lo), __high2float(lo)};
  float x2[2] = {__low2float(hi), __high2float(hi)};
  float ss = x1[0] * x1[0] + x1[1] * x1[1] + x2[0] * x2[0] + x2[1] * x2[1];
  ss = warp_sum(ss);
  const float r = rsqrtf(ss / (float)DH + eps);   // torch.rsqrt's CUDA form
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const float a = x1[e] * r * w[d + e];
    const float b = x2[e] * r * w[HALF + d + e];
    const float c = cs[d + e], s = sn[d + e];
    dst[d + e] = __float2bfloat16((a * c - b * s) * post_scale);
    dst[HALF + d + e] = __float2bfloat16((b * c + a * s) * post_scale);
  }
}

__global__ void __launch_bounds__(THREADS) qknorm_rope_attention_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const float* __restrict__ qw,
    const float* __restrict__ kw, const float* __restrict__ cosv,
    const float* __restrict__ sinv, const int32_t* __restrict__ mask,
    __nv_bfloat16* __restrict__ out, int S, int H, int Hk, float eps,
    float scale, int causal) {
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
    norm_rope_row(q + tok * qstride + (size_t)h * DH, qw, cs, sn, eps, scale,
                  Qs + s * KSTR, lane);
    norm_rope_row(k + tok * kstride + (size_t)g * DH, kw, cs, sn, eps, 1.0f,
                  Ks + s * KSTR, lane);
    const uint2 vv = *reinterpret_cast<const uint2*>(v + tok * kstride + (size_t)g * DH + 4 * lane);
    *reinterpret_cast<uint2*>(Vs + s * DH + 4 * lane) = vv;
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
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int j = 0; j < S; ++j) {
      const float p = P[j];
      if (p == 0.0f) continue;  // warp-uniform: every lane reads P[j]
      const __nv_bfloat162* vr = reinterpret_cast<const __nv_bfloat162*>(Vs + j * DH + 4 * lane);
      const float2 v01 = __bfloat1622float2(vr[0]);
      const float2 v23 = __bfloat1622float2(vr[1]);
      acc[0] += p * v01.x;
      acc[1] += p * v01.y;
      acc[2] += p * v23.x;
      acc[3] += p * v23.y;
    }
    __nv_bfloat162 o01 = __floats2bfloat162_rn(acc[0], acc[1]);
    __nv_bfloat162 o23 = __floats2bfloat162_rn(acc[2], acc[3]);
    __nv_bfloat162* orow = reinterpret_cast<__nv_bfloat162*>(
        out + ((size_t)b * S + i) * qstride + (size_t)h * DH + 4 * lane);
    orow[0] = o01;
    orow[1] = o23;
    __syncwarp();
  }
}

}  // namespace

extern "C" int ts_qknorm_rope_attention(
    const void* q, const void* k, const void* v, const void* qw, const void* kw,
    const void* cosv, const void* sinv, const void* mask, void* out, int B, int S,
    int H, int Hk, int Dh, float eps, float scale, int causal, void* stream) {
  if (Dh != DH || S < 1 || S > 128 || Hk < 1 || H % Hk) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)S * KSTR * 2 * sizeof(__nv_bfloat16) +
                      (size_t)S * DH * sizeof(__nv_bfloat16) +
                      (size_t)WARPS * S * sizeof(float) + (size_t)S * sizeof(int32_t);
  cudaError_t err = cudaFuncSetAttribute(qknorm_rope_attention_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(H, B);
  qknorm_rope_attention_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v,
      (const float*)qw, (const float*)kw, (const float*)cosv, (const float*)sinv,
      (const int32_t*)mask, (__nv_bfloat16*)out, S, H, Hk, eps, scale, causal);
  return (int)cudaGetLastError();
}
