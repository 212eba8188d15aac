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
// is bytes-bound; every intermediate stays in shared memory and registers,
// so each input is read once and each output written once.
//
// Design. One block of eight warps per (item, kv head), grid (Hk, B): it
// loops over the H / Hk q heads that share the kv head, so dk and dv
// accumulate inside the block with no atomics (the TPU kernel's own loop).
// All five products run on the tensor cores, mma.sync m16n8k16 bf16 ->
// f32, with operands loaded from shared memory by ldmatrix (.trans for the
// transposed ones), as B2 (attention.cu) does:
//   1. k normed, rotated and cast, and v, are staged once in shared memory
//      (rows padded to Dh + 8 bf16: ldmatrix free of bank conflicts; rows
//      S .. Sp-1 of the padded length Sp = ceil16(S) zero). The norm and
//      RoPE run a quad of lanes a row, eight rows a warp at once, with
//      16-byte loads; v and g are plain copies by cp.async, and the item's
//      cos/sin rows and the norm weights go to shared memory where they fit.
//   2. The q heads are taken in groups of as many as keep the eight warps
//      busy in phase A (two at S <= 64 with H / Hk = 2, one at S > 64):
//      a group's qh and g are staged the same way (the first group
//      together with k and v, behind one barrier). Phase
//      A: warp w owns query strip w % (Sp / 16) of the group's head
//      w / (Sp / 16). It computes the strip's logits (qh k^T)
//      and dp (g v^T) over the key tiles it needs, the softmax and its
//      backward in registers (row max and sums by quad shuffles), writes
//      bf16 pb and dlb rows to shared memory, then dq_rot = dlb k with dlb
//      read back as the A operand and k through ldmatrix.trans, and runs
//      dq's rotation transpose and norm adjoint on the accumulators (the
//      RoPE pair d, d + 64 sits in one lane; the row sums are quad
//      shuffles; the raw q row is read once for its statistics).
//   3. Phase B: warp w owns a 16-key strip and a slice of the head dim and
//      adds pb^T g and dlb^T qh into its dv and dk accumulators (pb^T and
//      dlb^T as A operands by ldmatrix.trans, g and qh as B operands by
//      ldmatrix.trans), summed over the group's heads and held in
//      registers across the groups.
//   4. After the last head dk_rot goes through shared memory to a quad of
//      lanes a row for its rotation transpose and norm adjoint; dv is
//      cast and stored from the registers.
//   At S > 64 the accumulators of all 128 keys would not fit beside phase
//   A's registers, so the block makes two passes over the heads, each
//   accumulating dk and dv for 64 of the keys (phase A recomputed, dq
//   written in the first pass only).
// Whole 16-key tiles above a strip's causal diagonal and past the item's
// last real key are skipped in every product: p = 0 there exactly (a
// masked logit is -1e30, so exp underflows to 0 wherever the row has a
// real key), hence pb = dl = 0. A strip holding a row with no real key
// takes the whole key range, so that row's uniform softmax over the S
// keys comes out as the plain version's (the kept difference: an
// all-zero-mask item spreads over its own S keys).
// The norm-weight gradients sum over every token of every item. TPU grid
// steps run in order and accumulated them in one output block; blocks here
// run in parallel and in no order, so each block sums its part in a fixed
// order (quad shuffles, then per-warp rows in shared memory), writes its
// (Dh,) partials to scratch, and a second small kernel adds them in a
// fixed order: without atomics two launches on the same inputs give
// bit-equal outputs.
//
// Built with -fmad=false, so the f32 norm, RoPE and softmax chains round
// after every operation, as the plain PyTorch version's unfused ops do
// (the tensor cores sum the bf16 x bf16 products in another order than
// the plain version's einsum, so the two agree to a tolerance). The RMS
// statistics sum their squares in f64 and round to f32 once, as B2's
// forward and both plain versions do: the squares of bf16 values are
// exact, so every order gives the same f32 and the backward recomputes
// exactly the r of the forward.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int DH = 128;
constexpr int HALF = DH / 2;
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int STR = DH + 8;    // bf16 row of the staged tiles: 272 bytes
constexpr int FSTR = DH + 8;   // f32 row of the dk scratch
constexpr int RED_PARTS = 8;   // threads per column in the partial-sum kernel

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

__device__ __forceinline__ double quad_sum(double v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

// sum over the eight lanes of a warp that share tig (the 8 rows gq)
__device__ __forceinline__ float col_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 4);
  v += __shfl_xor_sync(0xffffffffu, v, 8);
  return v + __shfl_xor_sync(0xffffffffu, v, 16);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// c += a b: a 16 x 16 bf16 (row), b 16 x 8 bf16 (col), c 16 x 8 f32. Lane
// 4 * gq + tig holds c0, c1 = (row gq, cols 2 tig, 2 tig + 1), c2, c3 =
// (row gq + 8, the same cols).
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float2 bf2(uint32_t w) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w));
}

__device__ __forceinline__ void store_bf2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(smem)), "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// Rows 0..Sp-1 of a head's (S, Dh) slice (row stride `stride`) copied into
// dst (STR rows) with 16-byte cp.async copies by the whole block, rows
// S..Sp-1 zeroed; the caller waits (cp_async_wait_all) and syncs.
__device__ __forceinline__ void stage_copy(const __nv_bfloat16* __restrict__ src, size_t stride,
                                           int S, int Sp, __nv_bfloat16* dst) {
  for (int i = threadIdx.x; i < Sp * (DH / 8); i += THREADS) {
    const int row = i / (DH / 8), c = (i % (DH / 8)) * 8;
    if (row < S)
      cp_async16(dst + row * STR + c, src + (size_t)row * stride + c);
    else
      *reinterpret_cast<uint4*>(dst + row * STR + c) = make_uint4(0, 0, 0, 0);
  }
}

// Row helpers: a quad of lanes a row, eight rows a warp at once. Lane tig
// of a quad holds columns 16 tig .. 16 tig + 15 of each half, so RoPE's
// pairs d, d + Dh/2 sit in one lane and a row's sums are two quad
// shuffles; loads and stores are 16 bytes.
constexpr int QC = 16;   // columns of each half a lane holds

__device__ __forceinline__ void load16_bf16(const __nv_bfloat16* p, float (&x)[QC]) {
  const uint4 a = *reinterpret_cast<const uint4*>(p);
  const uint4 b = *reinterpret_cast<const uint4*>(p + 8);
  const uint32_t w[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float2 f = bf2(w[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void load16_f32(const float* p, float (&x)[QC]) {
#pragma unroll
  for (int i = 0; i < QC; i += 4) {
    const float4 v = *reinterpret_cast<const float4*>(p + i);
    x[i] = v.x;
    x[i + 1] = v.y;
    x[i + 2] = v.z;
    x[i + 3] = v.w;
  }
}

__device__ __forceinline__ void store16_bf16(__nv_bfloat16* p, const float (&y)[QC]) {
  uint32_t w[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(y[2 * i], y[2 * i + 1]);
    w[i] = *reinterpret_cast<const uint32_t*>(&v);
  }
  *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  *reinterpret_cast<uint4*>(p + 8) = make_uint4(w[4], w[5], w[6], w[7]);
}

// RMSNorm + RoPE (times post_scale) of a head's (S, Dh) slice (row stride
// `stride`; ctab, stab: the item's cos/sin rows, Dh/2 floats each) into
// dst, cast to bf16, rows S..Sp-1 zero.
__device__ __forceinline__ void stage_norm_rope(
    const __nv_bfloat16* __restrict__ src, size_t stride, const float* w, const float* ctab,
    const float* stab, int S, int Sp, float eps, float post_scale, __nv_bfloat16* dst,
    int warp, int lane) {
  const int qd = lane >> 2, c0 = QC * (lane & 3);
  float w1[QC], w2[QC];
  load16_f32(w + c0, w1);
  load16_f32(w + HALF + c0, w2);
  // every lane of a warp walks the same rows, so the quad shuffles converge
#pragma unroll 1
  for (int base = 8 * warp; base < Sp; base += 8 * WARPS) {
    const int row = base + qd;
    const bool ok = row < S;
    float x1[QC] = {}, x2[QC] = {}, c[QC] = {}, sn[QC] = {};
    if (ok) {
      load16_bf16(src + (size_t)row * stride + c0, x1);
      load16_bf16(src + (size_t)row * stride + HALF + c0, x2);
      load16_f32(ctab + row * HALF + c0, c);
      load16_f32(stab + row * HALF + c0, sn);
    }
    double ss = 0.0;
#pragma unroll
    for (int i = 0; i < QC; ++i) ss += (double)(x1[i] * x1[i]) + (double)(x2[i] * x2[i]);
    const float r = rsqrtf((float)quad_sum(ss) / (float)DH + eps);
    float y1[QC], y2[QC];
#pragma unroll
    for (int i = 0; i < QC; ++i) {
      const float a = x1[i] * r * w1[i];
      const float b = x2[i] * r * w2[i];
      y1[i] = (a * c[i] - b * sn[i]) * post_scale;
      y2[i] = (b * c[i] + a * sn[i]) * post_scale;
    }
    if (row < Sp) {   // rows S..Sp-1: x = 0, so y = 0
      store16_bf16(dst + row * STR + c0, y1);
      store16_bf16(dst + row * STR + HALF + c0, y2);
    }
  }
}

// Rows r0 .. r1-1 of dk: the gradient of the rotated, weighted, normed
// row (f32, from Fs) through the rotation's transpose and the RMSNorm
// adjoint against the raw row of src (row stride `stride`); dx written as
// bf16, dz * xn added to the lane's dw columns (c0 .. c0 + 15 of each half
// in dw1, dw2).
__device__ __forceinline__ void finish_rows(
    const float* Fs, int r0, int r1, const __nv_bfloat16* __restrict__ src, size_t stride,
    const float* w, const float* ctab, const float* stab, float eps,
    __nv_bfloat16* __restrict__ dst, float (&dw1)[QC], float (&dw2)[QC], int warp, int lane) {
  const int qd = lane >> 2, c0 = QC * (lane & 3);
  float w1[QC], w2[QC];
  load16_f32(w + c0, w1);
  load16_f32(w + HALF + c0, w2);
#pragma unroll 1
  for (int base = r0 + 8 * warp; base < r1; base += 8 * WARPS) {
    const int row = base + qd;
    const bool ok = row < r1;
    float x1[QC] = {}, x2[QC] = {}, c[QC] = {}, sn[QC] = {}, dy1[QC] = {}, dy2[QC] = {};
    if (ok) {
      load16_bf16(src + (size_t)row * stride + c0, x1);
      load16_bf16(src + (size_t)row * stride + HALF + c0, x2);
      load16_f32(ctab + row * HALF + c0, c);
      load16_f32(stab + row * HALF + c0, sn);
      load16_f32(Fs + row * FSTR + c0, dy1);
      load16_f32(Fs + row * FSTR + HALF + c0, dy2);
    }
    double ss = 0.0;
#pragma unroll
    for (int i = 0; i < QC; ++i) ss += (double)(x1[i] * x1[i]) + (double)(x2[i] * x2[i]);
    const float r = rsqrtf((float)quad_sum(ss) / (float)DH + eps);
    float proj = 0.0f;
#pragma unroll
    for (int i = 0; i < QC; ++i) {
      const float dz1 = dy1[i] * c[i] + dy2[i] * sn[i];
      const float dz2 = dy2[i] * c[i] - dy1[i] * sn[i];
      x1[i] = x1[i] * r;   // xn
      x2[i] = x2[i] * r;
      dw1[i] += dz1 * x1[i];
      dw2[i] += dz2 * x2[i];
      dy1[i] = dz1 * w1[i];   // dxn
      dy2[i] = dz2 * w2[i];
      proj += dy1[i] * x1[i];
      proj += dy2[i] * x2[i];
    }
    proj = quad_sum(proj) / (float)DH;
    if (ok) {
#pragma unroll
      for (int i = 0; i < QC; ++i) {
        dy1[i] = r * (dy1[i] - x1[i] * proj);
        dy2[i] = r * (dy2[i] - x2[i] * proj);
      }
      store16_bf16(dst + (size_t)row * stride + c0, dy1);
      store16_bf16(dst + (size_t)row * stride + HALF + c0, dy2);
    }
  }
}

// q heads a block stages and runs phase A for at once: as many as keep
// its warps busy, one query strip a warp
__host__ __device__ inline int head_group(int S, int rep) {
  const int tph = (S + 15) / 16;
  const int hg = WARPS / tph;
  return rep < hg ? rep : (hg > 1 ? hg : 1);
}

// tabs: the item's cos/sin rows staged in shared memory too
size_t smem_bytes(int S, int hg, bool tabs) {
  const size_t sp = (S + 15) & ~15;
  return (2 + 2 * (size_t)hg) * sp * STR * sizeof(__nv_bfloat16) +
         2 * (size_t)hg * sp * (sp + 8) * sizeof(__nv_bfloat16) + sp * sizeof(int32_t) +
         4 * sizeof(int32_t) + (2 * WARPS + 2) * DH * sizeof(float) +
         (tabs ? 2 * sp * HALF * sizeof(float) : 0);
}

// SMAX (32, 64 or 128) bounds S and sizes phase A's register arrays (NT
// key tiles of logits and dp a strip) and phase B's (KS key strips a
// pass, each warp a KS * 16-column slice of the head dim).
template <int SMAX>
__global__ void __launch_bounds__(THREADS, 1) qknorm_rope_attention_bwd_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const float* __restrict__ qw,
    const float* __restrict__ kw, const float* __restrict__ cosv,
    const float* __restrict__ sinv, const int32_t* __restrict__ mask,
    const __nv_bfloat16* __restrict__ gin, __nv_bfloat16* __restrict__ dq,
    __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
    float* __restrict__ partial, int S, int H, int Hk, float eps, float scale, int causal,
    int tabs) {
  constexpr int NT = SMAX / 16;            // key tiles of a strip
  constexpr int PASSES = SMAX == 128 ? 2 : 1;
  constexpr int KS = NT / PASSES;          // key strips a pass
  constexpr int CW = 16 * KS;              // head-dim columns a warp in phase B
  constexpr int NN = CW / 8;               // its n8 tiles
  extern __shared__ __align__(16) unsigned char smem[];
  const int Sp = (S + 15) & ~15;
  const int PSTR = Sp + 8;                 // bf16 row of the pb and dlb tiles
  const int rep = H / Hk;
  const int hg = head_group(S, rep);
  // Ks, Vs; then per head of a group its qh and g tiles (Sp x STR each),
  // then its pb and dlb tiles (Sp x PSTR each)
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Vs = Ks + Sp * STR;
  __nv_bfloat16* QG = Vs + Sp * STR;
  __nv_bfloat16* PD = QG + 2 * hg * Sp * STR;
  int32_t* Ms = reinterpret_cast<int32_t*>(PD + 2 * hg * Sp * PSTR);   // Sp
  int32_t* Lim = Ms + Sp;                                         // first, last real key
  float* redq = reinterpret_cast<float*>(Lim + 4);                // WARPS x DH
  float* redk = redq + WARPS * DH;                                // WARPS x DH
  float* Wq = redk + WARPS * DH;                                  // the norm weights, q then k
  float* Wk = Wq + DH;
  float* CS = Wk + DH;                                            // tabs: Sp x Dh/2 cos, then sin
  float* SN = CS + Sp * HALF;
  float* Fs = reinterpret_cast<float*>(QG);   // Sp x FSTR over head 0's qh and g, after the heads
  auto Qs = [&](int hh) { return QG + 2 * hh * Sp * STR; };
  auto Gs = [&](int hh) { return QG + (2 * hh + 1) * Sp * STR; };
  auto PB = [&](int hh) { return PD + 2 * hh * Sp * PSTR; };
  auto DL = [&](int hh) { return PD + (2 * hh + 1) * Sp * PSTR; };

  const int g = blockIdx.x;
  const int b = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int gq = lane >> 2, tig = lane & 3;
  const int mi = lane >> 3, mr = lane & 7;   // ldmatrix: matrix and row this lane addresses
  const size_t qstride = (size_t)H * DH;
  const size_t kstride = (size_t)Hk * DH;
  const int tph = Sp / 16;                   // strips (of queries or keys)

  if (warp == 0) {
    int first = Sp, last = -1;
    for (int c = 0; c < Sp; c += 32) {
      const int j = c + lane;
      const int m = j < S ? mask[(size_t)b * S + j] : 0;
      if (j < Sp) Ms[j] = m;
      const unsigned bal = __ballot_sync(0xffffffffu, m != 0);
      if (bal) {
        first = min(first, c + __ffs(bal) - 1);
        last = max(last, c + 31 - __clz(bal));
      }
    }
    if (lane == 0) {
      Lim[0] = first;
      Lim[1] = last;
    }
  }
  for (int i = threadIdx.x; i < WARPS * DH; i += THREADS) redq[i] = 0.0f;
  for (int i = threadIdx.x; i < 2 * DH; i += THREADS) Wq[i] = i < DH ? qw[i] : kw[i - DH];
  const size_t tok0 = (size_t)b * S;
  // the item's cos/sin rows: from device memory until the first barrier,
  // then from shared memory where they fit
  const float* cglob = cosv + tok0 * HALF;
  const float* sglob = sinv + tok0 * HALF;
  if (tabs) {
    for (int i = threadIdx.x; i < S * (HALF / 4); i += THREADS) {
      cp_async16(CS + 4 * i, cglob + 4 * i);
      cp_async16(SN + 4 * i, sglob + 4 * i);
    }
  }
  const float* ctab = tabs ? CS : cglob;
  const float* stab = tabs ? SN : sglob;
  stage_copy(v + tok0 * kstride + (size_t)g * DH, kstride, S, Sp, Vs);
  stage_norm_rope(k + tok0 * kstride + (size_t)g * DH, kstride, kw, cglob, sglob, S, Sp, eps,
                      1.0f, Ks, warp, lane);
  // a group's qh and g tiles (heads h0 .. h0 + nh - 1 of the kv head)
  auto stage_group = [&](int h0, int nh, const float* w, const float* ct, const float* st) {
    for (int hh = 0; hh < nh; ++hh)
      stage_copy(gin + tok0 * qstride + (size_t)(g * rep + h0 + hh) * DH, qstride, S, Sp, Gs(hh));
    for (int hh = 0; hh < nh; ++hh)
      stage_norm_rope(q + tok0 * qstride + (size_t)(g * rep + h0 + hh) * DH, qstride, w, ct,
                          st, S, Sp, eps, scale, Qs(hh), warp, lane);
  };
  stage_group(0, min(hg, rep), qw, cglob, sglob);   // the first group rides with k and v
  cp_async_wait_all();
  __syncthreads();
  const int first = Lim[0], last = Lim[1];
  // key tiles a query strip starting at row i0 needs
  auto strip_tiles = [&](int i0) {
    int n = tph;
    if (last >= 0 && !(causal && i0 < first))
      n = (causal ? min(last, i0 + 15) : last) / 16 + 1;
    return n;
  };

  float dwk1[QC] = {}, dwk2[QC] = {};   // the lane's dw columns of each half
#pragma unroll 1
  for (int pass = 0; pass < PASSES; ++pass) {
    const int j_strip = pass * KS + warp % KS;   // phase B: this warp's key strip
    const int c0 = (warp / KS) * CW;             // and head-dim columns
    float accv[NN][4], acck[NN][4];
#pragma unroll
    for (int n = 0; n < NN; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) accv[n][e] = acck[n][e] = 0.0f;

#pragma unroll 1
    for (int h0 = 0; h0 < rep; h0 += hg) {
      const int nh = min(hg, rep - h0);   // heads of this group
      if (pass > 0 || h0 > 0) {
        stage_group(h0, nh, Wq, ctab, stab);
        cp_async_wait_all();
        __syncthreads();
      }

      // ---- phase A: warp `warp` takes query strip warp % tph of head warp / tph ----
      const int ha = warp / tph;
      if (ha < nh) {
        const int h = g * rep + h0 + ha;
        const __nv_bfloat16* Qa = Qs(ha);
        const __nv_bfloat16* Ga = Gs(ha);
        __nv_bfloat16* PBa = PB(ha);
        __nv_bfloat16* DLa = DL(ha);
        const int i0 = 16 * (warp % tph);
        const int nkt = strip_tiles(i0);
        const int ra = i0 + gq, rb = ra + 8;
        // the raw q rows dq's norm adjoint needs, loaded now so that the
        // logits and the softmax cover their latency (bf16 pairs at
        // columns 8 n + 2 tig, kept packed)
        const bool oka = ra < S, okb = rb < S;
        const int tra = oka ? ra : 0, trb = okb ? rb : 0;
        uint32_t xa[16], xb[16];
        if (pass == 0) {
          const uint32_t* xra = reinterpret_cast<const uint32_t*>(
              q + (tok0 + tra) * qstride + (size_t)h * DH + 2 * tig);
          const uint32_t* xrb = reinterpret_cast<const uint32_t*>(
              q + (tok0 + trb) * qstride + (size_t)h * DH + 2 * tig);
#pragma unroll
          for (int n = 0; n < 16; ++n) {
            xa[n] = oka ? xra[4 * n] : 0u;
            xb[n] = okb ? xrb[4 * n] : 0u;
          }
        }
        float lg[2 * NT][4], dpv[2 * NT][4];
#pragma unroll
        for (int j = 0; j < 2 * NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) lg[j][e] = dpv[j][e] = 0.0f;
#pragma unroll 1
        for (int c = 0; c < DH / 16; ++c) {
          uint32_t qa[4], ga[4];
          ldsm_x4(qa, Qa + (i0 + (lane & 15)) * STR + 16 * c + (lane >> 4) * 8);
          ldsm_x4(ga, Ga + (i0 + (lane & 15)) * STR + 16 * c + (lane >> 4) * 8);
#pragma unroll
          for (int jp = 0; jp < NT; ++jp) {
            if (jp < nkt) {
              const int off = (16 * jp + (mi >> 1) * 8 + mr) * STR + 16 * c + (mi & 1) * 8;
              uint32_t kb[4], vb[4];
              ldsm_x4(kb, Ks + off);
              ldsm_x4(vb, Vs + off);
              mma_bf16(lg[2 * jp], qa, kb[0], kb[1]);
              mma_bf16(lg[2 * jp + 1], qa, kb[2], kb[3]);
              mma_bf16(dpv[2 * jp], ga, vb[0], vb[1]);
              mma_bf16(dpv[2 * jp + 1], ga, vb[2], vb[3]);
            }
          }
        }
        // mask, then each row's max and sum over the computed key range
        float ma = -CUDART_INF_F, mb = -CUDART_INF_F;
#pragma unroll
        for (int j = 0; j < 2 * NT; ++j) {
          if (j < 2 * nkt) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int key = 8 * j + 2 * tig + e;
              float la = -CUDART_INF_F, lb = -CUDART_INF_F;
              if (key < S) {
                const bool real = Ms[key] != 0;
                la = (real && (!causal || key <= ra)) ? lg[j][e] : -1e30f;
                lb = (real && (!causal || key <= rb)) ? lg[j][2 + e] : -1e30f;
              }
              lg[j][e] = la;
              lg[j][2 + e] = lb;
              ma = fmaxf(ma, la);
              mb = fmaxf(mb, lb);
            }
          }
        }
        ma = quad_max(ma);
        mb = quad_max(mb);
        float suma = 0.0f, sumb = 0.0f;
#pragma unroll
        for (int j = 0; j < 2 * NT; ++j) {
          if (j < 2 * nkt) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              lg[j][e] = expf(lg[j][e] - ma);
              lg[j][2 + e] = expf(lg[j][2 + e] - mb);
              suma += lg[j][e];
              sumb += lg[j][2 + e];
            }
          }
        }
        suma = quad_sum(suma);
        sumb = quad_sum(sumb);
        // p (rows past S: 0), and rowsum(dp p)
        const float ia = 1.0f / suma, ib = 1.0f / sumb;
        float ta = 0.0f, tb = 0.0f;
#pragma unroll
        for (int j = 0; j < 2 * NT; ++j) {
          if (j < 2 * nkt) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              lg[j][e] = oka ? lg[j][e] * ia : 0.0f;
              lg[j][2 + e] = okb ? lg[j][2 + e] * ib : 0.0f;
              ta += dpv[j][e] * lg[j][e];
              tb += dpv[j][2 + e] * lg[j][2 + e];
            }
          }
        }
        ta = quad_sum(ta);
        tb = quad_sum(tb);
        // pb and dlb rows of the computed tiles
#pragma unroll
        for (int j = 0; j < 2 * NT; ++j) {
          if (j < 2 * nkt) {
            const int col = 8 * j + 2 * tig;
            store_bf2(PBa + ra * PSTR + col, lg[j][0], lg[j][1]);
            store_bf2(PBa + rb * PSTR + col, lg[j][2], lg[j][3]);
            store_bf2(DLa + ra * PSTR + col, lg[j][0] * (dpv[j][0] - ta),
                      lg[j][1] * (dpv[j][1] - ta));
            store_bf2(DLa + rb * PSTR + col, lg[j][2] * (dpv[j][2] - tb),
                      lg[j][3] * (dpv[j][3] - tb));
          }
        }
        __syncwarp();

        if (pass == 0) {
          // dq_rot = dlb k: dlb rows as A, k (key-major) through ldmatrix.trans
          float acq[16][4];
#pragma unroll
          for (int n = 0; n < 16; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) acq[n][e] = 0.0f;
#pragma unroll 1
          for (int t = 0; t < nkt; ++t) {
            uint32_t da[4];
            ldsm_x4(da, DLa + (i0 + (lane & 15)) * PSTR + 16 * t + (lane >> 4) * 8);
            const __nv_bfloat16* kr = Ks + (16 * t + (mi & 1) * 8 + mr) * STR + (mi >> 1) * 8;
#pragma unroll
            for (int np = 0; np < 8; ++np) {
              uint32_t kf[4];
              ldsm_x4_t(kf, kr + 16 * np);
              mma_bf16(acq[2 * np], da, kf[0], kf[1]);
              mma_bf16(acq[2 * np + 1], da, kf[2], kf[3]);
            }
          }
          // rows ra and rb: the rotation's transpose and the norm adjoint.
          // Lane (gq, tig) holds columns d = 8 n + 2 tig + e, n < 8, of the
          // first half and d + 64 (n + 8) of the second, for both rows.
          double ssa = 0.0, ssb = 0.0;
#pragma unroll
          for (int n = 0; n < 16; ++n) {
            const float2 fa = bf2(xa[n]), fb = bf2(xb[n]);
            ssa += (double)(fa.x * fa.x) + (double)(fa.y * fa.y);
            ssb += (double)(fb.x * fb.x) + (double)(fb.y * fb.y);
          }
          const float r_a = rsqrtf((float)quad_sum(ssa) / (float)DH + eps);
          const float r_b = rsqrtf((float)quad_sum(ssb) / (float)DH + eps);
          const float* csa = ctab + tra * HALF + 2 * tig;
          const float* sna = stab + tra * HALF + 2 * tig;
          const float* csb = ctab + trb * HALF + 2 * tig;
          const float* snb = stab + trb * HALF + 2 * tig;
          float proja = 0.0f, projb = 0.0f;
#pragma unroll
          for (int n = 0; n < 8; ++n) {
            const float2 ca2 = *reinterpret_cast<const float2*>(csa + 8 * n);
            const float2 sa2 = *reinterpret_cast<const float2*>(sna + 8 * n);
            const float2 cb2 = *reinterpret_cast<const float2*>(csb + 8 * n);
            const float2 sb2 = *reinterpret_cast<const float2*>(snb + 8 * n);
            const float2 w1 = *reinterpret_cast<const float2*>(Wq + 8 * n + 2 * tig);
            const float2 w2 = *reinterpret_cast<const float2*>(Wq + HALF + 8 * n + 2 * tig);
            const float2 xa1 = bf2(xa[n]), xa2 = bf2(xa[n + 8]);
            const float2 xb1 = bf2(xb[n]), xb2 = bf2(xb[n + 8]);
            const float ca[2] = {ca2.x, ca2.y}, sa[2] = {sa2.x, sa2.y};
            const float cb[2] = {cb2.x, cb2.y}, sb[2] = {sb2.x, sb2.y};
            const float wa[2] = {w1.x, w1.y}, wb[2] = {w2.x, w2.y};
            const float x1a[2] = {xa1.x, xa1.y}, x2a[2] = {xa2.x, xa2.y};
            const float x1b[2] = {xb1.x, xb1.y}, x2b[2] = {xb2.x, xb2.y};
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int d = 8 * n + 2 * tig + e;
              // row a: accumulators e; row b: 2 + e. dxn goes in dy's place.
              const float dy1a = acq[n][e] * scale, dy2a = acq[n + 8][e] * scale;
              const float dy1b = acq[n][2 + e] * scale, dy2b = acq[n + 8][2 + e] * scale;
              const float dz1a = dy1a * ca[e] + dy2a * sa[e];
              const float dz2a = dy2a * ca[e] - dy1a * sa[e];
              const float dz1b = dy1b * cb[e] + dy2b * sb[e];
              const float dz2b = dy2b * cb[e] - dy1b * sb[e];
              const float xn1a = x1a[e] * r_a, xn2a = x2a[e] * r_a;
              const float xn1b = x1b[e] * r_b, xn2b = x2b[e] * r_b;
              acq[n][e] = dz1a * wa[e];
              acq[n + 8][e] = dz2a * wb[e];
              acq[n][2 + e] = dz1b * wa[e];
              acq[n + 8][2 + e] = dz2b * wb[e];
              proja += acq[n][e] * xn1a;
              proja += acq[n + 8][e] * xn2a;
              projb += acq[n][2 + e] * xn1b;
              projb += acq[n + 8][2 + e] * xn2b;
              // the two rows' dw terms, summed over the warp's 16 rows
              const float s1 = col_sum(dz1a * xn1a + dz1b * xn1b);
              const float s2 = col_sum(dz2a * xn2a + dz2b * xn2b);
              if (gq == 0) {
                redq[warp * DH + d] += s1;
                redq[warp * DH + HALF + d] += s2;
              }
            }
          }
          proja = quad_sum(proja) / (float)DH;
          projb = quad_sum(projb) / (float)DH;
          __nv_bfloat16* dsta = dq + (tok0 + tra) * qstride + (size_t)h * DH + 2 * tig;
          __nv_bfloat16* dstb = dq + (tok0 + trb) * qstride + (size_t)h * DH + 2 * tig;
#pragma unroll
          for (int n = 0; n < 16; ++n) {
            const float2 fa = bf2(xa[n]), fb = bf2(xb[n]);
            if (oka)
              store_bf2(dsta + 8 * n, r_a * (acq[n][0] - fa.x * r_a * proja),
                        r_a * (acq[n][1] - fa.y * r_a * proja));
            if (okb)
              store_bf2(dstb + 8 * n, r_b * (acq[n][2] - fb.x * r_b * projb),
                        r_b * (acq[n][3] - fb.y * r_b * projb));
          }
        }
      }
      __syncthreads();

      // ---- phase B: dv += pb^T g, dk_rot += dlb^T qh on (key strip, columns) ----
      if (j_strip < tph) {
        const int j0 = 16 * j_strip;
#pragma unroll 1
        for (int i = 0; i < nh * tph; ++i) {
          const int hb = i / tph, ib = i % tph;
          if (j_strip >= strip_tiles(16 * ib)) continue;   // pb = dlb = 0 there
          const int aoff = (16 * ib + (mi >> 1) * 8 + mr) * PSTR + j0 + (mi & 1) * 8;
          uint32_t pa[4], la[4];
          ldsm_x4_t(pa, PB(hb) + aoff);
          ldsm_x4_t(la, DL(hb) + aoff);
          const int boff = (16 * ib + (mi & 1) * 8 + mr) * STR + c0 + (mi >> 1) * 8;
#pragma unroll
          for (int np = 0; np < NN / 2; ++np) {
            uint32_t gf[4], qf[4];
            ldsm_x4_t(gf, Gs(hb) + boff + 16 * np);
            ldsm_x4_t(qf, Qs(hb) + boff + 16 * np);
            mma_bf16(accv[2 * np], pa, gf[0], gf[1]);
            mma_bf16(accv[2 * np + 1], pa, gf[2], gf[3]);
            mma_bf16(acck[2 * np], la, qf[0], qf[1]);
            mma_bf16(acck[2 * np + 1], la, qf[2], qf[3]);
          }
        }
      }
      __syncthreads();   // the next group's staging overwrites its tiles
    }

    // dv straight from the registers; dk_rot through shared memory to row warps
    if (j_strip < tph) {
      const int ka = 16 * j_strip + gq, kb = ka + 8;
#pragma unroll
      for (int n = 0; n < NN; ++n) {
        const int col = c0 + 8 * n + 2 * tig;
        if (ka < S)
          store_bf2(dv + ((size_t)b * S + ka) * kstride + (size_t)g * DH + col, accv[n][0],
                    accv[n][1]);
        if (kb < S)
          store_bf2(dv + ((size_t)b * S + kb) * kstride + (size_t)g * DH + col, accv[n][2],
                    accv[n][3]);
        *reinterpret_cast<float2*>(Fs + ka * FSTR + col) = make_float2(acck[n][0], acck[n][1]);
        *reinterpret_cast<float2*>(Fs + kb * FSTR + col) = make_float2(acck[n][2], acck[n][3]);
      }
    }
    __syncthreads();
    finish_rows(Fs, pass * KS * 16, min(S, (pass + 1) * KS * 16),
                    k + tok0 * kstride + (size_t)g * DH, kstride, Wk, ctab, stab, eps,
                    dk + tok0 * kstride + (size_t)g * DH, dwk1, dwk2, warp, lane);
    __syncthreads();   // the next pass restages Qs and Gs over Fs
  }

  // this block's partial norm-weight gradients, summed over its warps in order
  // the k weight's: summed over the warp's eight quads (lanes that share
  // tig), written by quad 0
#pragma unroll
  for (int i = 0; i < QC; ++i) {
    const float a = col_sum(dwk1[i]), b = col_sum(dwk2[i]);
    if (gq == 0) {
      redk[warp * DH + QC * tig + i] = a;
      redk[warp * DH + HALF + QC * tig + i] = b;
    }
  }
  __syncthreads();
  if (threadIdx.x < 2 * DH) {
    const int c = threadIdx.x & (DH - 1);
    const float* src = threadIdx.x < DH ? redq : redk;
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

template <int SMAX>
cudaError_t launch_bwd(const void* q, const void* k, const void* v, const void* qw,
                       const void* kw, const void* cosv, const void* sinv, const void* mask,
                       const void* g, void* dq, void* dk, void* dv, void* partial, int B,
                       int S, int H, int Hk, float eps, float scale, int causal,
                       cudaStream_t stream) {
  const int hg = head_group(S, H / Hk);
  const int tabs = smem_bytes(S, hg, true) <= 232448 && (uintptr_t)cosv % 16 == 0 &&
                   (uintptr_t)sinv % 16 == 0;
  const size_t smem = smem_bytes(S, hg, tabs);
  cudaError_t err = cudaFuncSetAttribute(qknorm_rope_attention_bwd_kernel<SMAX>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(Hk, B);
  qknorm_rope_attention_bwd_kernel<SMAX><<<grid, THREADS, smem, stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v,
      (const float*)qw, (const float*)kw, (const float*)cosv, (const float*)sinv,
      (const int32_t*)mask, (const __nv_bfloat16*)g, (__nv_bfloat16*)dq, (__nv_bfloat16*)dk,
      (__nv_bfloat16*)dv, (float*)partial, S, H, Hk, eps, scale, causal, tabs);
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
    err = launch_bwd<32>(q, k, v, qw, kw, cosv, sinv, mask, g, dq, dk, dv, partial, B, S, H, Hk,
                         eps, scale, causal, st);
  else if (S <= 64)
    err = launch_bwd<64>(q, k, v, qw, kw, cosv, sinv, mask, g, dq, dk, dv, partial, B, S, H, Hk,
                         eps, scale, causal, st);
  else
    err = launch_bwd<128>(q, k, v, qw, kw, cosv, sinv, mask, g, dq, dk, dv, partial, B, S, H,
                          Hk, eps, scale, causal, st);
  if (err != cudaSuccess) return (int)err;
  norm_weight_grad_sum_kernel<<<2, RED_PARTS * DH, 0, st>>>(
      (const float*)partial, (float*)dqw, (float*)dkw, B * Hk);
  return (int)cudaGetLastError();
}
