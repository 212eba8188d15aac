// Backward of the fused encoder attention (kernel B7): the gradients of
// per-head q/k RMSNorm, half-split RoPE and masked softmax(q k^T) v with
// respect to the raw projections q, k, v and the two norm weights.
//
// Replaces the TPU kernel theoremsearch_tpu/kernels/attention.py:
// _attn_bwd_kernel (driven by fused_qknorm_rope_attention_bwd), with that
// kernel's steps and casts. Nothing is saved from the forward; each block
// recomputes it:
//   - q normed, rotated, scaled, cast to bf16 (qh); k normed, rotated, cast;
//   - f32 logits (masked keys -1e30), f32 softmax p, pb = bf16(p);
//   - dv += pb^T g;  dp = g v^T (f32);  dl = p (dp - rowsum(dp p));
//     dlb = bf16(dl);
//   - dq_rot = (dlb k) * scale;  dk_rot += dlb^T qh;
//   - the rotation's transpose, then the RMSNorm adjoint
//     dx = r (dxn - xn mean(dxn xn)) with dxn = dz w, and dw += sum(dz xn);
//   - dq, dk, dv cast to bf16; dqw, dkw f32.
//
// What bounds it on an H100: at the training shape (B, S, H, Hk, Dh) =
// (64, 64, 16, 8, 128) it reads q, k, v, g and the cos/sin tables and
// writes dq, dk, dv, about 86 MB, or 0.026 ms at 3.35 TB/s; its five
// causal S x S x Dh products are 2.7 GFLOP, 2.8 us at the bf16 peak. So it
// is bytes-bound, and a first kernel that keeps every intermediate in
// shared memory and registers reads each input once and writes each output
// once; its time goes to the products, done here on the f32 pipes.
//
// Design. One block of sixteen warps per (item, kv head): it loops over
// the H / Hk q heads that share the kv head, so dk and dv accumulate
// inside the block, with no atomics (the TPU kernel's own loop). The TPU
// packed 128 / S items into one block-diagonal 128-wide tile for its MXU;
// on this card that packing only wastes work, so it is left out.
//   1. k normed, rotated and cast, and v, are staged once in shared memory.
//   2. For each q head: qh and g are staged; one warp per query row computes
//      the logits and dp (lanes take keys, rows padded so the key reads are
//      free of bank conflicts), the softmax and its backward with shuffles
//      for the row sums, writes bf16 pb and dlb rows to shared memory, then
//      the row's dq: (dlb k) * scale, the rotation's transpose and the norm
//      adjoint, with the q row re-read for its statistics.
//   3. Then every thread adds pb^T g and dlb^T qh into its own slice of the
//      f32 dv and dk accumulators (one column, S/4 rows), held in registers
//      across the q heads: they would not fit in shared memory beside the
//      six bf16 tiles at S = 128.
//   4. After the last head the dk accumulator goes through shared memory to
//      one warp per row for its rotation transpose and norm adjoint.
// The norm-weight gradients sum over every token of every item. TPU grid
// steps run in order and accumulated them in one output block; blocks here
// run in parallel and in no order, so each block writes its (Dh,) partial
// sums to scratch and a second small kernel adds them in a fixed order:
// without atomics two launches on the same inputs give bit-equal outputs.
//
// Masked keys (causal, and the right padding of short texts) have p = 0
// exactly, hence pb = 0 and dl = 0: skipping them is exact, as in the
// forward. An item whose mask is all zero is the one case the TPU kernel
// (which spreads such a row over its whole packed tile) cannot be matched
// on; the encoder never sends one (batching sets mask[:, 0] = 1).
//
// Built with -fmad=false, so the f32 norm, RoPE and softmax chains round
// after every operation, as the plain PyTorch version's unfused ops do.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int DH = 128;
constexpr int HALF = DH / 2;
constexpr int WARPS = 16;
constexpr int THREADS = WARPS * 32;
constexpr int KSTR = DH + 2;  // padded bf16 row: 65 words, conflict-free
constexpr int RED_PARTS = 8;  // threads per column in the partial-sum kernel

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

// A warp's view of one Dh = 128 row: lane l holds columns 2l, 2l+1 (first
// half) and 64+2l, 64+2l+1 (second half), so the rotation pairs a lane's
// own values.
__device__ __forceinline__ void load_row(const __nv_bfloat16* __restrict__ src, int lane,
                                         float x1[2], float x2[2]) {
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(src + 2 * lane));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(src + HALF + 2 * lane));
  x1[0] = lo.x; x1[1] = lo.y; x2[0] = hi.x; x2[1] = hi.y;
}

// RMSNorm (f32 statistics) + half-split RoPE of one row, times post_scale,
// cast to bf16 into dst.
__device__ __forceinline__ void norm_rope_row(
    const __nv_bfloat16* __restrict__ src, const float* __restrict__ w,
    const float* __restrict__ cs, const float* __restrict__ sn, float eps,
    float post_scale, __nv_bfloat16* dst, int lane) {
  const int d = 2 * lane;
  float x1[2], x2[2];
  load_row(src, lane, x1, x2);
  float ss = x1[0] * x1[0] + x1[1] * x1[1] + x2[0] * x2[0] + x2[1] * x2[1];
  ss = warp_sum(ss);
  const float r = rsqrtf(ss / (float)DH + eps);
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const float a = x1[e] * r * w[d + e];
    const float b = x2[e] * r * w[HALF + d + e];
    const float c = cs[d + e], s = sn[d + e];
    dst[d + e] = __float2bfloat16((a * c - b * s) * post_scale);
    dst[HALF + d + e] = __float2bfloat16((b * c + a * s) * post_scale);
  }
}

// Given dy (the gradient of the rotated, weighted, normed row) in the
// warp's row layout: the rotation's transpose, then the RMSNorm adjoint
// against the raw row `src`. Writes dx (bf16) and adds dz * xn to dw.
__device__ __forceinline__ void rope_norm_bwd_row(
    const float dy1[2], const float dy2[2], const __nv_bfloat16* __restrict__ src,
    const float* __restrict__ w, const float* __restrict__ cs,
    const float* __restrict__ sn, float eps, __nv_bfloat16* __restrict__ dst,
    float dw[4], int lane) {
  const int d = 2 * lane;
  float x1[2], x2[2];
  load_row(src, lane, x1, x2);
  float ss = x1[0] * x1[0] + x1[1] * x1[1] + x2[0] * x2[0] + x2[1] * x2[1];
  ss = warp_sum(ss);
  const float r = rsqrtf(ss / (float)DH + eps);
  float xn1[2], xn2[2], dxn1[2], dxn2[2];
  float proj = 0.0f;
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const float c = cs[d + e], s = sn[d + e];
    const float dz1 = dy1[e] * c + dy2[e] * s;
    const float dz2 = dy2[e] * c - dy1[e] * s;
    xn1[e] = x1[e] * r;
    xn2[e] = x2[e] * r;
    dxn1[e] = dz1 * w[d + e];
    dxn2[e] = dz2 * w[HALF + d + e];
    dw[e] += dz1 * xn1[e];
    dw[2 + e] += dz2 * xn2[e];
    proj += dxn1[e] * xn1[e];
    proj += dxn2[e] * xn2[e];
  }
  proj = warp_sum(proj) / (float)DH;
  *reinterpret_cast<__nv_bfloat162*>(dst + d) =
      __floats2bfloat162_rn(r * (dxn1[0] - xn1[0] * proj), r * (dxn1[1] - xn1[1] * proj));
  *reinterpret_cast<__nv_bfloat162*>(dst + HALF + d) =
      __floats2bfloat162_rn(r * (dxn2[0] - xn2[0] * proj), r * (dxn2[1] - xn2[1] * proj));
}

__device__ __forceinline__ void copy_row(const __nv_bfloat16* __restrict__ src,
                                         __nv_bfloat16* dst, int lane) {
  reinterpret_cast<__nv_bfloat162*>(dst)[lane] = reinterpret_cast<const __nv_bfloat162*>(src)[lane];
  reinterpret_cast<__nv_bfloat162*>(dst + HALF)[lane] =
      reinterpret_cast<const __nv_bfloat162*>(src + HALF)[lane];
}

__device__ __forceinline__ float dot_row(const __nv_bfloat16* a, const __nv_bfloat16* b) {
  const __nv_bfloat162* a2 = reinterpret_cast<const __nv_bfloat162*>(a);
  const __nv_bfloat162* b2 = reinterpret_cast<const __nv_bfloat162*>(b);
  float dot = 0.0f;
#pragma unroll 8
  for (int w2 = 0; w2 < HALF; ++w2) {
    const float2 x = __bfloat1622float2(a2[w2]);
    const float2 y = __bfloat1622float2(b2[w2]);
    dot += x.x * y.x;
    dot += x.y * y.y;
  }
  return dot;
}

// RPT: rows of the dv / dk accumulators a thread owns (S <= 4 * RPT); the
// pb and dlb tiles are stored with 4 * RPT columns, zero past S.
template <int RPT>
__global__ void __launch_bounds__(THREADS) qknorm_rope_attention_bwd_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const float* __restrict__ qw,
    const float* __restrict__ kw, const float* __restrict__ cosv,
    const float* __restrict__ sinv, const int32_t* __restrict__ mask,
    const __nv_bfloat16* __restrict__ gin, __nv_bfloat16* __restrict__ dq,
    __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
    float* __restrict__ partial, int S, int H, int Hk, float eps, float scale, int causal) {
  constexpr int SP = 4 * RPT;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem);  // S x KSTR
  __nv_bfloat16* Vs = Ks + S * KSTR;                             // S x KSTR
  __nv_bfloat16* Qs = Vs + S * KSTR;                             // S x KSTR
  __nv_bfloat16* Gs = Qs + S * KSTR;                             // S x KSTR
  __nv_bfloat16* PB = Gs + S * KSTR;                             // S x SP
  __nv_bfloat16* DL = PB + S * SP;                               // S x SP
  int32_t* Ms = reinterpret_cast<int32_t*>(DL + S * SP);         // S
  float* red = reinterpret_cast<float*>(Ms + S);                 // 2 x WARPS x DH
  float* Fs = reinterpret_cast<float*>(Qs);  // S x DH, over Qs..DL after the heads

  const int g = blockIdx.x;
  const int b = blockIdx.y;
  const int rep = H / Hk;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int col = threadIdx.x & (DH - 1);  // this thread's accumulator column
  const int jq = threadIdx.x >> 7;          // and its rows jq * RPT + [0, RPT)
  const size_t qstride = (size_t)H * DH;
  const size_t kstride = (size_t)Hk * DH;

  for (int j = threadIdx.x; j < S; j += THREADS) Ms[j] = mask[(size_t)b * S + j];
  for (int s = warp; s < S; s += WARPS) {
    const size_t tok = (size_t)b * S + s;
    norm_rope_row(k + tok * kstride + (size_t)g * DH, kw, cosv + tok * HALF, sinv + tok * HALF,
                  eps, 1.0f, Ks + s * KSTR, lane);
    copy_row(v + tok * kstride + (size_t)g * DH, Vs + s * KSTR, lane);
  }
  float accv[RPT], acck[RPT];
#pragma unroll
  for (int r = 0; r < RPT; ++r) accv[r] = acck[r] = 0.0f;
  float dwq[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  float dwk[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  __syncthreads();

  for (int hh = 0; hh < rep; ++hh) {
    const int h = g * rep + hh;
    for (int s = warp; s < S; s += WARPS) {
      const size_t tok = (size_t)b * S + s;
      norm_rope_row(q + tok * qstride + (size_t)h * DH, qw, cosv + tok * HALF, sinv + tok * HALF,
                    eps, scale, Qs + s * KSTR, lane);
      copy_row(gin + tok * qstride + (size_t)h * DH, Gs + s * KSTR, lane);
    }
    __syncthreads();

    for (int i = warp; i < S; i += WARPS) {
      const __nv_bfloat16* qrow = Qs + i * KSTR;
      const __nv_bfloat16* grow = Gs + i * KSTR;
      float lg[4], dpv[4];
      float m = -CUDART_INF_F;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int j = lane + 32 * c;
        lg[c] = -CUDART_INF_F;
        dpv[c] = 0.0f;
        if (j < S) {
          lg[c] = -1e30f;
          if ((!causal || j <= i) && Ms[j] != 0) {
            lg[c] = dot_row(qrow, Ks + j * KSTR);
            dpv[c] = dot_row(grow, Vs + j * KSTR);
          }
          m = fmaxf(m, lg[c]);
        }
      }
      m = warp_max(m);
      float p[4];
      float sum = 0.0f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        p[c] = (lane + 32 * c < S) ? expf(lg[c] - m) : 0.0f;
        sum += p[c];
      }
      sum = warp_sum(sum);
      float t = 0.0f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        p[c] = p[c] / sum;
        t += dpv[c] * p[c];
      }
      t = warp_sum(t);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int j = lane + 32 * c;
        if (j < SP) {
          const bool in = j < S;
          PB[i * SP + j] = __float2bfloat16(in ? p[c] : 0.0f);
          DL[i * SP + j] = __float2bfloat16(in ? p[c] * (dpv[c] - t) : 0.0f);
        }
      }
      __syncwarp();
      // this row's dq: (dlb k) * scale, then the rotation and norm adjoints
      float a[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      const int jend = causal ? min(i + 1, S) : S;
      for (int j = 0; j < jend; ++j) {
        const float d = __bfloat162float(DL[i * SP + j]);
        if (d == 0.0f) continue;  // warp-uniform: every lane reads DL[i][j]
        float k1[2], k2[2];
        load_row(Ks + j * KSTR, lane, k1, k2);
        a[0] += d * k1[0];
        a[1] += d * k1[1];
        a[2] += d * k2[0];
        a[3] += d * k2[1];
      }
      const float dy1[2] = {a[0] * scale, a[1] * scale};
      const float dy2[2] = {a[2] * scale, a[3] * scale};
      const size_t tok = (size_t)b * S + i;
      rope_norm_bwd_row(dy1, dy2, q + tok * qstride + (size_t)h * DH, qw, cosv + tok * HALF,
                        sinv + tok * HALF, eps, dq + tok * qstride + (size_t)h * DH, dwq, lane);
    }
    __syncthreads();

    // dv += pb^T g and dk_rot += dlb^T qh on this thread's (column, rows)
    for (int i = 0; i < S; ++i) {
      if (causal && i < jq * RPT) continue;  // warp-uniform: pb, dlb are 0 there
      const float gv = __bfloat162float(Gs[i * KSTR + col]);
      const float qv = __bfloat162float(Qs[i * KSTR + col]);
      const uint4* pr = reinterpret_cast<const uint4*>(PB + i * SP + jq * RPT);
      const uint4* dr = reinterpret_cast<const uint4*>(DL + i * SP + jq * RPT);
#pragma unroll
      for (int u = 0; u < RPT / 8; ++u) {
        const uint4 pw = pr[u];
        const uint4 dw = dr[u];
        const __nv_bfloat162* p2 = reinterpret_cast<const __nv_bfloat162*>(&pw);
        const __nv_bfloat162* d2 = reinterpret_cast<const __nv_bfloat162*>(&dw);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 pf = __bfloat1622float2(p2[e]);
          const float2 df = __bfloat1622float2(d2[e]);
          accv[8 * u + 2 * e] += pf.x * gv;
          accv[8 * u + 2 * e + 1] += pf.y * gv;
          acck[8 * u + 2 * e] += df.x * qv;
          acck[8 * u + 2 * e + 1] += df.y * qv;
        }
      }
    }
    __syncthreads();
  }

  // dv straight from registers; dk_rot through shared memory to row warps
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const int j = jq * RPT + r;
    if (j < S) {
      dv[((size_t)b * S + j) * kstride + (size_t)g * DH + col] = __float2bfloat16(accv[r]);
      Fs[j * DH + col] = acck[r];
    }
  }
  __syncthreads();
  for (int j = warp; j < S; j += WARPS) {
    const float2 f1 = *reinterpret_cast<const float2*>(Fs + j * DH + 2 * lane);
    const float2 f2 = *reinterpret_cast<const float2*>(Fs + j * DH + HALF + 2 * lane);
    const float dy1[2] = {f1.x, f1.y};
    const float dy2[2] = {f2.x, f2.y};
    const size_t tok = (size_t)b * S + j;
    rope_norm_bwd_row(dy1, dy2, k + tok * kstride + (size_t)g * DH, kw, cosv + tok * HALF,
                      sinv + tok * HALF, eps, dk + tok * kstride + (size_t)g * DH, dwk, lane);
  }

  // this block's partial norm-weight gradients, summed over its warps in order
  float* rq = red;
  float* rk = red + WARPS * DH;
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    rq[warp * DH + 2 * lane + e] = dwq[e];
    rq[warp * DH + HALF + 2 * lane + e] = dwq[2 + e];
    rk[warp * DH + 2 * lane + e] = dwk[e];
    rk[warp * DH + HALF + 2 * lane + e] = dwk[2 + e];
  }
  __syncthreads();
  if (threadIdx.x < 2 * DH) {
    const int c = threadIdx.x & (DH - 1);
    const float* src = threadIdx.x < DH ? rq : rk;
    float s = 0.0f;
    for (int w = 0; w < WARPS; ++w) s += src[w * DH + c];
    const size_t nblk = (size_t)gridDim.x * gridDim.y;
    const size_t blk = (size_t)b * gridDim.x + g;
    partial[(threadIdx.x < DH ? 0 : nblk * DH) + blk * DH + c] = s;
  }
}

// Sums the per-block partials (nblk, Dh) in a fixed order: block 0 the q
// weight's, block 1 the k weight's.
__global__ void __launch_bounds__(RED_PARTS * DH) norm_weight_grad_sum_kernel(
    const float* __restrict__ partial, float* __restrict__ dqw, float* __restrict__ dkw,
    int nblk) {
  __shared__ float part[RED_PARTS][DH];
  const float* src = partial + (size_t)blockIdx.x * nblk * DH;
  const int c = threadIdx.x & (DH - 1);
  const int p = threadIdx.x / DH;
  float s = 0.0f;
  for (int blk = p; blk < nblk; blk += RED_PARTS) s += src[(size_t)blk * DH + c];
  part[p][c] = s;
  __syncthreads();
  if (threadIdx.x < DH) {
    float o = 0.0f;
#pragma unroll
    for (int i = 0; i < RED_PARTS; ++i) o += part[i][threadIdx.x];
    (blockIdx.x == 0 ? dqw : dkw)[threadIdx.x] = o;
  }
}

template <int RPT>
cudaError_t launch_bwd(const void* q, const void* k, const void* v, const void* qw,
                       const void* kw, const void* cosv, const void* sinv, const void* mask,
                       const void* g, void* dq, void* dk, void* dv, void* partial, int B,
                       int S, int H, int Hk, float eps, float scale, int causal,
                       cudaStream_t stream) {
  constexpr int SP = 4 * RPT;
  const size_t smem = (size_t)4 * S * KSTR * sizeof(__nv_bfloat16) +
                      (size_t)2 * S * SP * sizeof(__nv_bfloat16) + (size_t)S * sizeof(int32_t) +
                      (size_t)2 * WARPS * DH * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(qknorm_rope_attention_bwd_kernel<RPT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(Hk, B);
  qknorm_rope_attention_bwd_kernel<RPT><<<grid, THREADS, smem, stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v,
      (const float*)qw, (const float*)kw, (const float*)cosv, (const float*)sinv,
      (const int32_t*)mask, (const __nv_bfloat16*)g, (__nv_bfloat16*)dq, (__nv_bfloat16*)dk,
      (__nv_bfloat16*)dv, (float*)partial, S, H, Hk, eps, scale, causal);
  return cudaGetLastError();
}

}  // namespace

extern "C" int ts_qknorm_rope_attention_bwd(
    const void* q, const void* k, const void* v, const void* qw, const void* kw,
    const void* cosv, const void* sinv, const void* mask, const void* g, void* dq, void* dk,
    void* dv, void* partial, void* dqw, void* dkw, int B, int S, int H, int Hk, int Dh,
    float eps, float scale, int causal, void* stream) {
  if (Dh != DH || S < 1 || S > 128 || Hk < 1 || H % Hk || B < 1 || B > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err;
  if (S <= 32)
    err = launch_bwd<8>(q, k, v, qw, kw, cosv, sinv, mask, g, dq, dk, dv, partial, B, S, H, Hk,
                        eps, scale, causal, st);
  else if (S <= 64)
    err = launch_bwd<16>(q, k, v, qw, kw, cosv, sinv, mask, g, dq, dk, dv, partial, B, S, H, Hk,
                         eps, scale, causal, st);
  else
    err = launch_bwd<32>(q, k, v, qw, kw, cosv, sinv, mask, g, dq, dk, dv, partial, B, S, H, Hk,
                         eps, scale, causal, st);
  if (err != cudaSuccess) return (int)err;
  norm_weight_grad_sum_kernel<<<2, RED_PARTS * DH, 0, st>>>(
      (const float*)partial, (float*)dqw, (float*)dkw, B * Hk);
  return (int)cudaGetLastError();
}
