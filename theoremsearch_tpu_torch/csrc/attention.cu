// Fused encoder attention: per-head q/k RMSNorm, half-split RoPE, masked
// softmax(q k^T) v, GQA by head index.
//
// Replaces the TPU kernel theoremsearch_tpu/kernels/attention.py:_attn_kernel
// (driven by fused_qknorm_rope_attention), with that kernel's casts:
//   - the norm and RoPE in f32; the RMS statistic's sum of squares in f64,
//     rounded to f32 once (the squares of bf16 values are exact, so the
//     sum is the same f32 in any order: the plain version and B7's
//     recomputation take the same r bit for bit), r = rsqrtf(ss / DH + eps);
//   - q multiplied by `scale` before its bf16 cast; k normed, rotated, cast;
//   - logits f32 (bf16 x bf16 products, f32 sums) plus -1e30 where masked
//     (causal x key padding);
//   - f32 softmax over the whole key range (max and sum of each row, no
//     online rescaling), probabilities cast to bf16;
//   - P V accumulated in f32, the output cast to bf16.
//
// At S <= 128, two forms, one template on the head dim DH: the qwen form
// (DH = 128, causal, 1/sqrt(Dh)) and the gemma form (DH = 256,
// bidirectional, scale query_pre_attn_scalar^-1/2, the (1 + w) norm
// weights passed with the 1 already added), which
// theoremsearch_tpu/encoder/gemma.py:_make_attn_core reaches with the same
// TPU kernel. Above S = 128 the qwen form has a tiled kernel of its own
// (the long form, at the end of this note).
//
// What bounds it on an H100: bytes. At the encoder's (512, 64) batches the
// kernel must read q, k, v, the f32 cos/sin tables and the mask and write
// the output, ~419 MB in the qwen form (16/8 heads of 128): 0.125 ms at
// 3.35 TB/s; ~168 MB, 0.050 ms, in the gemma form (3/1 heads of 256). Its
// products are at most ~40 flops a byte at S = 64 (the causal form skips
// about half), far under the ~295 at which the bf16 tensor cores would
// bound it, so mma.sync (not wgmma) is enough: the goal is the bytes
// bound, not the tensor-core peak.
//
// The design. One block per (item, kv head), grid (Hk, B), takes all H/Hk
// q heads of its group, so each kv head's K is normed and rotated once and
// K and V are staged once in shared memory (rows padded to DH + 8 bf16,
// which keeps ldmatrix free of bank conflicts; rows S..Sp-1 of the padded
// length Sp = ceil16(S) zero). Each warp owns 16 query rows of one head
// (a strip) and runs both products on the tensor cores with mma.sync
// m16n8k16 bf16 -> f32: Q K^T with K rows loaded by ldmatrix as the
// column-major B operand, P V with V loaded by ldmatrix.trans. The strip's
// Q fragments are built in registers straight from device memory: the
// head-dim order inside K's shared rows is permuted (kpos) so that each
// lane's fragment elements are 8 consecutive elements of q, one 16-byte
// load, and RoPE's pairs d and d + DH/2 fall in the same lane; the RMS of
// a row comes from quad shuffles, then the norm, RoPE, the scale and the
// bf16 cast. The logits of a strip's whole key range stay in registers
// (16 x S f32 a warp); each row's max and sum come from quad shuffles
// over the accumulator fragments, and P = bf16(e / sum) goes straight
// into the A fragments of P V (the m16n8 C layout is the m16n8k16 A
// layout). P V runs in 64-column chunks of the output, so the
// head_dim-256 form holds 32 f32 accumulators a thread, not 128; V's
// columns are permuted in shared memory (vpos) so that each lane's
// accumulators are 16 consecutive output columns, two 16-byte stores.
//
// Masked work is skipped by whole 16-key tiles: tiles above a strip's
// causal diagonal and past the item's last real key. A masked key's logit
// is -1e30, which is what dot + (-1e30) rounds to in f32 for any |dot| <
// 3.8e22, so where a row has a real key a skipped key's probability is
// exactly 0 and adds +0. A strip holding a row with no real key (causal
// rows before the first real key, or an item with none) takes the whole
// key range instead, so that row's uniform softmax over the S keys comes
// out as the plain version's. No atomics: repeats are bit-equal.
//
// Built with -fmad=false, so the f32 norm, RoPE and softmax arithmetic
// rounds after every operation, as the plain PyTorch version's unfused
// ops do (the bf16 x bf16 products in the dots are exact in f32 either
// way; the tensor cores sum them in another order than the plain
// version's einsum, so the two agree to a tolerance, not bit for bit).
//
// Measured (chip_smoke.py's phase times on an NVIDIA H100 80GB HBM3 at
// 700.00 W): 0.317 ms at (512, 64) in the qwen form, 2.5x its 0.125 ms
// bound, and 0.125 ms in the gemma form, 2.5x its 0.050 ms bound. The
// design before this one (scalar f32 dots, one block per (item, q head))
// took 1.30-1.32 and 0.55 ms in tools/torch_kernel_ab.py's comparison on
// the same card.
//
// The long form (tiled_qknorm_rope_attention_kernel<128, SMAX>: the qwen
// form at 128 < S <= 512, the encoder's 256- and 512-wide buckets, SMAX
// the bucket width). It replaces no TPU kernel: the reference's dispatch
// (theoremsearch_tpu/encoder/model.py:_fused_ok) sends S > 128 to its XLA
// composition, which the port ran as float32 einsums over a (B, H, S, S)
// logits tensor. What bounds it: bytes, as above (~419 MB at (64, 512):
// 0.125 ms at 3.35 TB/s); its products stay under the tensor cores' ~295
// flops a byte. A strip's logits over the whole key range no longer fit
// in registers (16 x S f32 a warp: 256 registers a lane at S = 512), so:
//   - the grid is (Hk, B, query tiles). A block of 16 warps takes 16
//     strips of the kv group, strip st being rows 16 (st / G) .. + 15 of
//     q head st % G (128 query rows at H/Hk = 2), so small batches still
//     fill the card; the blocks whose rows see the most keys start first;
//   - the strips' q rows are normed, rotated and scaled once into shared
//     memory (8 lanes a row), read by ldmatrix as the A operand;
//   - K and V stream through shared memory in 64-key tiles: cp.async
//     stages tile t + 2's raw K rows, their cos and sin, and its V rows
//     while tile t is computed; the block then norms and rotates the
//     staged K rows (a warp four rows, the q/k statistic as above) into
//     the other of two K stages. Device memory's latency stays off the
//     critical path, and each K row is normed once for 128 query rows;
//   - a running softmax in 32-key steps (16 x 32 f32 logits a warp): the
//     step's logits with -1e30 where masked, a larger row max rescales
//     the row sum and the 16 x 128 f32 output, p = exp(l - max) in f32
//     joins the sum, bf16(p) goes straight into the A fragments of P V;
//     out = bf16(o / sum). So P is rounded to bf16 before the division,
//     not after as above: the form's own plain version
//     (kernels/attention.py:fused_qknorm_rope_attention_long_plain) takes
//     the same steps;
//   - steps above a strip's causal diagonal and past the item's last real
//     key are skipped (they would leave it unchanged); a strip holding a
//     row with no real key takes the whole key range, as above;
//   - the output goes through the strip's own q rows in shared memory to
//     16-byte stores. The only atomics are the integer min and max of the
//     mask scan: repeats are bit-equal.
//
// Measured (tools/torch_kernel_ab.py on an NVIDIA H100 80GB HBM3 at 700.00
// W, lengths uniform in [S/2, S]): 0.56 ms at (64, 512), 4.5x its 0.125 ms
// bound, and 0.20 ms at (64, 256), 3.2x its 0.0626 ms bound; the plain
// composition it replaces took ~12.5 ms a layer at (64, 512). Two blocks
// of 8 warps an SM with 32-key tiles ran as fast, two strips a warp (244
// registers, 8 warps an SM) 10% slower; overlapping tile 0's copies with
// the mask scan and the q rows saved 13%.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int WARPS = 8;   // a block: 8 strips at S = 64 in the qwen form, 12 in the gemma form
constexpr int THREADS = WARPS * 32;

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

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
// (row gq + 8, the same cols); a0 = (row gq, k 2 tig..+1), a1 = (row gq + 8,
// k 2 tig..+1), a2, a3 = the same rows at k 8 + 2 tig; b0 = (k 2 tig..+1,
// col gq), b1 = (k 8 + 2 tig..+1, col gq).
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float2 load_bf2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// Position in a shared K row of the head-dim element d. Q K^T sums over d
// in any order, so K and Q may share any permutation of it: each group
// of 32 is laid out so that lane tig's A fragments of the two 16-wide k
// chunks of the group (k = 2 tig, 2 tig + 1, 8 + 2 tig, 9 + 2 tig in each)
// hold the 8 consecutive elements d = 32 c + 8 tig + j, j = 0..7 (chunk
// 2c + j / 4), which a lane then reads from device memory in one 16-byte
// load. Pairs (d, d + 1), d even, stay adjacent.
__device__ __forceinline__ int kpos(int d) {
  const int t = (d >> 3) & 3, j = d & 7;
  return 16 * (2 * (d >> 5) + (j >> 2)) + 2 * t + (j & 1) + ((j >> 1) & 1) * 8;
}

// Position in a shared V row of the output column d. P V's C fragments
// give lane tig the columns 8 n + 2 tig + e (n = 0..7, e = 0, 1) of each
// 64-column chunk; V's columns are laid out so that those are the 16
// consecutive output columns d = 16 tig + 2 n + e, stored in two 16-byte
// stores.
__device__ __forceinline__ int vpos(int d) {
  const int dd = d & 63;
  return (d & ~63) + 8 * ((dd & 15) >> 1) + 2 * (dd >> 4) + (dd & 1);
}

// RMSNorm (f64 sum of squares) + half-split RoPE of one DH row of K held by a warp:
// lane l holds E = DH / 64 consecutive elements of each half, x1[e] =
// x[E l + e] and x2[e] = x[DH/2 + E l + e] (2 + 2 at DH 128, 4 + 4 at DH
// 256), written at their kpos. A row past S (ok false) has x zero and
// writes zeros.
template <int DH>
__device__ __forceinline__ void rope_row(const float (&x1)[DH / 64], const float (&x2)[DH / 64],
                                         const float* __restrict__ w,
                                         const float* __restrict__ cs,
                                         const float* __restrict__ sn, float eps, bool ok,
                                         __nv_bfloat16* dst, int lane) {
  constexpr int HALF = DH / 2;
  constexpr int E = DH / 64;
  const int d = E * lane;
  double ss = 0.0;
#pragma unroll
  for (int e = 0; e < E; ++e) ss += (double)(x1[e] * x1[e]) + (double)(x2[e] * x2[e]);
  const float r = rsqrtf((float)warp_sum(ss) / (float)DH + eps);   // torch.rsqrt's CUDA form
#pragma unroll
  for (int e = 0; e < E; e += 2) {
    float y1[2], y2[2];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const float a = x1[e + u] * r * w[d + e + u];
      const float b = x2[e + u] * r * w[HALF + d + e + u];
      const float c = ok ? cs[d + e + u] : 0.0f, s = ok ? sn[d + e + u] : 0.0f;
      y1[u] = a * c - b * s;
      y2[u] = b * c + a * s;
    }
    const int p = kpos(d + e);
    *reinterpret_cast<__nv_bfloat162*>(dst + p) = __floats2bfloat162_rn(y1[0], y1[1]);
    *reinterpret_cast<__nv_bfloat162*>(dst + HALF + p) = __floats2bfloat162_rn(y2[0], y2[1]);
  }
}

__device__ __forceinline__ void unpack8(const uint4& raw, float (&x)[8]) {
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void load_f8(const float* p, float (&x)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}

// Shared memory of a block: K and V (Sp rows of DH + 8 bf16 each), the q
// norm weights, the mask and the item's first and last real key.
template <int DH>
size_t smem_bytes(int S) {
  const int sp = (S + 15) & ~15;
  return (size_t)2 * sp * (DH + 8) * sizeof(__nv_bfloat16) + DH * sizeof(float) +
         (size_t)sp * sizeof(int32_t) + 2 * sizeof(int32_t);
}

// SMAX (64 or 128) bounds S and sizes the register arrays of the logits
// and probabilities. Blocks an SM the register file must hold, chosen by
// timing at (512, 64) on an H100: three of the qwen form at S <= 64 (<= 80
// registers a thread, with a few spilled: two blocks without spills ran
// slower), two of the gemma form (<= 128 registers; four-warp blocks,
// three an SM, ran slower) and of the qwen form at S > 64.
template <int DH, int SMAX>
__global__ void __launch_bounds__(THREADS, (DH == 128 && SMAX == 64) ? 3 : 2)
qknorm_rope_attention_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const float* __restrict__ qw,
    const float* __restrict__ kw, const float* __restrict__ cosv,
    const float* __restrict__ sinv, const int32_t* __restrict__ mask,
    __nv_bfloat16* __restrict__ out, int S, int H, int Hk, float eps,
    float scale, int causal) {
  constexpr int HALF = DH / 2;
  constexpr int STR = DH + 8;        // 272 / 528 bytes: 8 rows hit 8 bank groups
  constexpr int NT = SMAX / 16;      // key tiles of 16
  constexpr int NG = HALF / 32;      // groups of 32 head-dim elements in a half
  extern __shared__ __align__(16) unsigned char smem[];
  const int Sp = (S + 15) & ~15;
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem);   // Sp x STR, kpos order
  __nv_bfloat16* Vs = Ks + Sp * STR;                             // Sp x STR, vpos order
  float* Wq = reinterpret_cast<float*>(Vs + Sp * STR);           // DH
  int32_t* Ms = reinterpret_cast<int32_t*>(Wq + DH);             // Sp
  int32_t* Lim = Ms + Sp;                                        // first, last real key

  const int g = blockIdx.x;
  const int b = blockIdx.y;
  const int G = H / Hk;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const size_t qstride = (size_t)H * DH;
  const size_t kstride = (size_t)Hk * DH;

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
  for (int j = threadIdx.x; j < DH; j += THREADS) Wq[j] = qw[j];

  // K rows normed and rotated (one warp a row, KR rows in flight a warp),
  // V rows copied into vpos order; rows S..Sp-1 come out zero
  constexpr int KR = 2;
  constexpr int E = DH / 64;     // elements of each half a lane holds
  for (int s0 = warp; s0 < Sp; s0 += WARPS * KR) {
    float x1[KR][E], x2[KR][E];
    uint4 vv[KR];
#pragma unroll
    for (int u = 0; u < KR; ++u) {
      const int s = s0 + u * WARPS;
      const bool ok = s < S;
      const size_t tok = (size_t)b * S + (ok ? s : 0);
      const __nv_bfloat16* src = k + tok * kstride + (size_t)g * DH + E * lane;
#pragma unroll
      for (int e = 0; e < E; e += 2) {
        const float2 lo = ok ? load_bf2(src + e) : make_float2(0.0f, 0.0f);
        const float2 hi = ok ? load_bf2(src + HALF + e) : make_float2(0.0f, 0.0f);
        x1[u][e] = lo.x;
        x1[u][e + 1] = lo.y;
        x2[u][e] = hi.x;
        x2[u][e + 1] = hi.y;
      }
      // lane l copies V's 16-byte piece l (d = 8 l .. 8 l + 7)
      const uint4* vsrc = reinterpret_cast<const uint4*>(v + tok * kstride + (size_t)g * DH);
      vv[u] = (ok && lane < DH / 8) ? vsrc[lane] : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int u = 0; u < KR; ++u) {
      const int s = s0 + u * WARPS;
      if (s < Sp) {
        const size_t tok = (size_t)b * S + (s < S ? s : 0);
        rope_row<DH>(x1[u], x2[u], kw, cosv + tok * HALF, sinv + tok * HALF, eps, s < S,
                     Ks + s * STR, lane);
        if (lane < DH / 8) {
          const uint32_t w4[4] = {vv[u].x, vv[u].y, vv[u].z, vv[u].w};
          uint32_t* vrow = reinterpret_cast<uint32_t*>(Vs + s * STR);
#pragma unroll
          for (int i = 0; i < 4; ++i) vrow[vpos(8 * lane + 2 * i) / 2] = w4[i];
        }
      }
    }
  }
  __syncthreads();

  const int first = Lim[0], last = Lim[1];
  const int tph = Sp / 16;   // strips a head
  const int gq = lane >> 2, tig = lane & 3;
  const int mi = lane >> 3, mr = lane & 7;   // ldmatrix: matrix and row this lane addresses
  for (int st = warp; st < G * tph; st += WARPS) {
    const int gh = st / tph, i0 = (st % tph) * 16;
    const int h = g * G + gh;
    // key tiles this strip computes
    int nkt = tph;
    if (last >= 0 && !(causal && i0 < first))
      nkt = (causal ? min(last, i0 + 15) : last) / 16 + 1;

    // the strip's rows ia = i0 + gq and ib = ia + 8 (rows past S are zero
    // and never stored); lane tig takes elements 32 c + 8 tig .. + 7 of
    // each group c of 32
    const int ia = i0 + gq, ib = ia + 8;
    const bool va = ia < S, vb = ib < S;
    const size_t ta = (size_t)b * S + (va ? ia : 0), tb = (size_t)b * S + (vb ? ib : 0);
    const __nv_bfloat16* qa = q + ta * qstride + (size_t)h * DH + 8 * tig;
    const __nv_bfloat16* qb = q + tb * qstride + (size_t)h * DH + 8 * tig;
    double ssa = 0.0, ssb = 0.0;
#pragma unroll
    for (int c = 0; c < DH / 32; ++c) {
      float xa[8], xb[8];
      unpack8(va ? *reinterpret_cast<const uint4*>(qa + 32 * c) : make_uint4(0, 0, 0, 0), xa);
      unpack8(vb ? *reinterpret_cast<const uint4*>(qb + 32 * c) : make_uint4(0, 0, 0, 0), xb);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        ssa += (double)(xa[j] * xa[j]);
        ssb += (double)(xb[j] * xb[j]);
      }
    }
    const float ra = rsqrtf((float)quad_sum(ssa) / (float)DH + eps);
    const float rb = rsqrtf((float)quad_sum(ssb) / (float)DH + eps);

    float lg[2 * NT][4];
#pragma unroll
    for (int j = 0; j < 2 * NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) lg[j][e] = 0.0f;

#pragma unroll 1
    for (int c = 0; c < NG; ++c) {
      // A fragments of k chunks 2c, 2c + 1 (group c of the first half:
      // af[0], af[1]) and of the same chunks of the second half (af[2], af[3])
      uint32_t af[4][4];
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const bool ok = rr ? vb : va;
        const __nv_bfloat16* qr = (rr ? qb : qa) + 32 * c;
        const size_t tok = rr ? tb : ta;
        const int d = 32 * c + 8 * tig;
        const float r = rr ? rb : ra;
        float x1[8], x2[8], cc[8], sn[8];
        unpack8(ok ? *reinterpret_cast<const uint4*>(qr) : make_uint4(0, 0, 0, 0), x1);
        unpack8(ok ? *reinterpret_cast<const uint4*>(qr + HALF) : make_uint4(0, 0, 0, 0), x2);
        load_f8(cosv + tok * HALF + d, cc);
        load_f8(sinv + tok * HALF + d, sn);
        float y1[8], y2[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float a = x1[j] * r * Wq[d + j];
          const float bb = x2[j] * r * Wq[HALF + d + j];
          y1[j] = (a * cc[j] - bb * sn[j]) * scale;
          y2[j] = (bb * cc[j] + a * sn[j]) * scale;
        }
        // j = 0, 1 -> a0 / a1 of chunk 2c; 2, 3 -> a2 / a3; 4..7 the same of chunk 2c + 1
#pragma unroll
        for (int hc = 0; hc < 2; ++hc) {
          af[hc][rr] = pack_bf16(y1[4 * hc], y1[4 * hc + 1]);
          af[hc][rr + 2] = pack_bf16(y1[4 * hc + 2], y1[4 * hc + 3]);
          af[2 + hc][rr] = pack_bf16(y2[4 * hc], y2[4 * hc + 1]);
          af[2 + hc][rr + 2] = pack_bf16(y2[4 * hc + 2], y2[4 * hc + 3]);
        }
      }
#pragma unroll
      for (int jp = 0; jp < NT; ++jp) {
        if (jp < nkt) {
          const __nv_bfloat16* kr = Ks + (16 * jp + (mi >> 1) * 8 + mr) * STR + (mi & 1) * 8;
#pragma unroll
          for (int f = 0; f < 4; ++f) {
            // k chunk of fragment f: 2c + (f & 1), plus HALF / 16 in the second half
            uint32_t kb[4];
            ldsm_x4(kb, kr + 32 * c + 16 * (f & 1) + (f >> 1) * HALF);
            mma_bf16(lg[2 * jp], af[f], kb[0], kb[1]);
            mma_bf16(lg[2 * jp + 1], af[f], kb[2], kb[3]);
          }
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
            la = (real && (!causal || key <= ia)) ? lg[j][e] : -1e30f;
            lb = (real && (!causal || key <= ib)) ? lg[j][2 + e] : -1e30f;
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
    // P = bf16(e / sum), laid out as the A fragments of P V
    uint32_t pf[NT][4];
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      pf[t][0] = pack_bf16(lg[2 * t][0] / suma, lg[2 * t][1] / suma);
      pf[t][1] = pack_bf16(lg[2 * t][2] / sumb, lg[2 * t][3] / sumb);
      pf[t][2] = pack_bf16(lg[2 * t + 1][0] / suma, lg[2 * t + 1][1] / suma);
      pf[t][3] = pack_bf16(lg[2 * t + 1][2] / sumb, lg[2 * t + 1][3] / sumb);
    }

    __nv_bfloat16* oa = out + ta * qstride + (size_t)h * DH + 16 * tig;
    __nv_bfloat16* ob = out + tb * qstride + (size_t)h * DH + 16 * tig;
#pragma unroll 1
    for (int ch = 0; ch < DH / 64; ++ch) {
      float o[8][4];
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[n][e] = 0.0f;
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        if (t < nkt) {
          const __nv_bfloat16* vr =
              Vs + (16 * t + (mi & 1) * 8 + mr) * STR + 64 * ch + (mi >> 1) * 8;
#pragma unroll
          for (int np = 0; np < 4; ++np) {
            uint32_t vf[4];
            ldsm_x4_t(vf, vr + 16 * np);
            mma_bf16(o[2 * np], pf[t], vf[0], vf[1]);
            mma_bf16(o[2 * np + 1], pf[t], vf[2], vf[3]);
          }
        }
      }
      // lane tig holds output columns 64 ch + 16 tig .. + 15 of rows ia, ib
      uint32_t wa[8], wb[8];
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        wa[n] = pack_bf16(o[n][0], o[n][1]);
        wb[n] = pack_bf16(o[n][2], o[n][3]);
      }
      if (va) {
        uint4* dst = reinterpret_cast<uint4*>(oa + 64 * ch);
        dst[0] = make_uint4(wa[0], wa[1], wa[2], wa[3]);
        dst[1] = make_uint4(wa[4], wa[5], wa[6], wa[7]);
      }
      if (vb) {
        uint4* dst = reinterpret_cast<uint4*>(ob + 64 * ch);
        dst[0] = make_uint4(wb[0], wb[1], wb[2], wb[3]);
        dst[1] = make_uint4(wb[4], wb[5], wb[6], wb[7]);
      }
    }
  }
}

template <int DH, int SMAX>
int launch(const void* q, const void* k, const void* v, const void* qw, const void* kw,
           const void* cosv, const void* sinv, const void* mask, void* out, int B, int S,
           int H, int Hk, float eps, float scale, int causal, cudaStream_t stream) {
  const size_t smem = smem_bytes<DH>(S);
  cudaError_t err = cudaFuncSetAttribute(qknorm_rope_attention_kernel<DH, SMAX>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(Hk, B);
  qknorm_rope_attention_kernel<DH, SMAX><<<grid, THREADS, smem, stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v,
      (const float*)qw, (const float*)kw, (const float*)cosv, (const float*)sinv,
      (const int32_t*)mask, (__nv_bfloat16*)out, S, H, Hk, eps, scale, causal);
  return (int)cudaGetLastError();
}

template <int DH>
int launch_dh(const void* q, const void* k, const void* v, const void* qw, const void* kw,
              const void* cosv, const void* sinv, const void* mask, void* out, int B, int S,
              int H, int Hk, float eps, float scale, int causal, cudaStream_t stream) {
  if (S <= 64)
    return launch<DH, 64>(q, k, v, qw, kw, cosv, sinv, mask, out, B, S, H, Hk, eps, scale,
                          causal, stream);
  return launch<DH, 128>(q, k, v, qw, kw, cosv, sinv, mask, out, B, S, H, Hk, eps, scale,
                         causal, stream);
}

// ---------------------------------------------------------------------------
// The long form: 128 < S <= 512, DH = 128 (see the note at the head).

constexpr int LWARPS = 16;              // a block: 16 strips of 16 rows
constexpr int LTHREADS = LWARPS * 32;
constexpr int LKT = 4 * LWARPS;         // keys a tile: four rows a warp to norm and rotate
constexpr int LSUB = 32;                // keys a compute step: 16 x 32 f32 logits a warp
constexpr int LSTR = 128 + 8;           // shared row stride in bf16: 272 bytes, 8 rows on 8 bank groups

// 16 bytes from gmem to smem, or 16 zero bytes where ok is false (a
// source size of 0 reads nothing).
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(smem)),
               "l"(gmem), "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// What a lane holds of one 128-wide row of q or k when 8 lanes share the
// row: elements 8 j .. 8 j + 7 of each half (j = lane & 7) and the same 8
// of the token's cos and sin.
struct RowIn {
  uint4 x1, x2;
  float4 c0, c1, s0, s1;
};

// One row (8 lanes) normed and rotated with the S <= 128 form's
// arithmetic (the f64 sum of squares, r = rsqrtf(ss / 128 + eps), (x r) w,
// the rotation, for q the scale), cast to bf16 and written to the row dst
// in natural order; w (the norm weights) in shared memory.
template <bool SCALED>
__device__ __forceinline__ void norm_rope_row(const RowIn& in, const float* w, float eps,
                                              float scale, __nv_bfloat16* dst, int lane) {
  constexpr int HALF = 64;
  const int j = lane & 7;
  float x1[8], x2[8], wa[8], wb[8];
  unpack8(in.x1, x1);
  unpack8(in.x2, x2);
  const float c[8] = {in.c0.x, in.c0.y, in.c0.z, in.c0.w, in.c1.x, in.c1.y, in.c1.z, in.c1.w};
  const float sn[8] = {in.s0.x, in.s0.y, in.s0.z, in.s0.w, in.s1.x, in.s1.y, in.s1.z, in.s1.w};
  double ss = 0.0;
#pragma unroll
  for (int e = 0; e < 8; ++e) ss += (double)(x1[e] * x1[e]) + (double)(x2[e] * x2[e]);
#pragma unroll
  for (int o = 1; o < 8; o <<= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
  const float r = rsqrtf((float)ss / 128.0f + eps);
  load_f8(w + 8 * j, wa);
  load_f8(w + HALF + 8 * j, wb);
  uint32_t y1[4], y2[4];
#pragma unroll
  for (int e = 0; e < 8; e += 2) {
    float p[2], q[2];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const float a = x1[e + u] * r * wa[e + u];
      const float bb = x2[e + u] * r * wb[e + u];
      p[u] = a * c[e + u] - bb * sn[e + u];
      q[u] = bb * c[e + u] + a * sn[e + u];
      if (SCALED) {
        p[u] = p[u] * scale;
        q[u] = q[u] * scale;
      }
    }
    y1[e / 2] = pack_bf16(p[0], p[1]);
    y2[e / 2] = pack_bf16(q[0], q[1]);
  }
  *reinterpret_cast<uint4*>(dst + 8 * j) = make_uint4(y1[0], y1[1], y1[2], y1[3]);
  *reinterpret_cast<uint4*>(dst + HALF + 8 * j) = make_uint4(y2[0], y2[1], y2[2], y2[3]);
}

// A warp's 16 q rows i0 .. i0 + 15 of head h, scaled, into dst (16 rows),
// read from device memory four rows a warp instruction, two groups of
// four in flight; rows past S come out zero.
__device__ __forceinline__ void q_strip(const __nv_bfloat16* __restrict__ q,
                                        const float* __restrict__ cosv,
                                        const float* __restrict__ sinv, const float* w, int b,
                                        int S, int H, int h, int i0, float eps, float scale,
                                        __nv_bfloat16* dst, int lane) {
  constexpr int DH = 128, HALF = 64, NF = 2;
  const int j = lane & 7, rg = lane >> 3;
  const uint4 zu = make_uint4(0, 0, 0, 0);
  const float4 zf = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
  for (int g0 = 0; g0 < 4; g0 += NF) {
    RowIn in[NF];
#pragma unroll
    for (int f = 0; f < NF; ++f) {
      const int row = i0 + 4 * (g0 + f) + rg;
      const bool ok = row < S;
      const size_t tok = (size_t)b * S + (ok ? row : 0);
      const __nv_bfloat16* src = q + (tok * H + h) * DH + 8 * j;
      const float* cs = cosv + tok * HALF + 8 * j;
      const float* sn = sinv + tok * HALF + 8 * j;
      in[f].x1 = ok ? *reinterpret_cast<const uint4*>(src) : zu;
      in[f].x2 = ok ? *reinterpret_cast<const uint4*>(src + HALF) : zu;
      in[f].c0 = ok ? *reinterpret_cast<const float4*>(cs) : zf;
      in[f].c1 = ok ? *reinterpret_cast<const float4*>(cs + 4) : zf;
      in[f].s0 = ok ? *reinterpret_cast<const float4*>(sn) : zf;
      in[f].s1 = ok ? *reinterpret_cast<const float4*>(sn + 4) : zf;
    }
#pragma unroll
    for (int f = 0; f < NF; ++f)
      norm_rope_row<true>(in[f], w, eps, scale, dst + (4 * (g0 + f) + rg) * LSTR, lane);
  }
}

// cp.async copies of one key tile (keys key0 .. key0 + LKT - 1 of kv head
// kg / vg) by the whole block, one commit group: the raw K rows into kraw
// (LKT x 128 bf16), their tokens' cos and sin into cs (LKT x (64 + 64)
// f32) and, where vdst is set, the V rows into vdst (LKT rows of LSTR);
// rows past S come out zero.
__device__ __forceinline__ void stage_tile(const __nv_bfloat16* __restrict__ kg,
                                           const __nv_bfloat16* __restrict__ vg, size_t kstride,
                                           const float* __restrict__ cosv,
                                           const float* __restrict__ sinv, int b, int S,
                                           int key0, __nv_bfloat16* kraw, float* cs,
                                           __nv_bfloat16* vdst) {
  for (int i = threadIdx.x; i < LKT * 16; i += LTHREADS) {
    const int r = i >> 4, c = i & 15;
    const int key = key0 + r;
    const bool ok = key < S;
    const size_t tok = (size_t)b * S + (ok ? key : 0);
    cp_async16(kraw + r * 128 + 8 * c, kg + tok * kstride + 8 * c, ok);
    cp_async16(cs + r * 128 + 4 * c, cosv + tok * 64 + 4 * c, ok);
    cp_async16(cs + r * 128 + 64 + 4 * c, sinv + tok * 64 + 4 * c, ok);
    if (vdst) cp_async16(vdst + r * LSTR + 8 * c, vg + tok * kstride + 8 * c, ok);
  }
  cp_async_commit();
}

// The staged tile's K rows 4 warp .. 4 warp + 3 normed and rotated into kdst.
__device__ __forceinline__ void k_from_stage(const __nv_bfloat16* kraw, const float* cs,
                                             const float* w, float eps, __nv_bfloat16* kdst,
                                             int warp, int lane) {
  const int j = lane & 7, r = 4 * warp + (lane >> 3);
  RowIn in;
  in.x1 = *reinterpret_cast<const uint4*>(kraw + r * 128 + 8 * j);
  in.x2 = *reinterpret_cast<const uint4*>(kraw + r * 128 + 64 + 8 * j);
  in.c0 = *reinterpret_cast<const float4*>(cs + r * 128 + 8 * j);
  in.c1 = *reinterpret_cast<const float4*>(cs + r * 128 + 8 * j + 4);
  in.s0 = *reinterpret_cast<const float4*>(cs + r * 128 + 64 + 8 * j);
  in.s1 = *reinterpret_cast<const float4*>(cs + r * 128 + 64 + 8 * j + 4);
  norm_rope_row<false>(in, w, eps, 1.0f, kdst + r * LSTR, lane);
}

// Shared memory of a block: the strips' q rows, K (normed) and V in two
// stages of LKT rows, one staged tile of raw K with its cos and sin, the
// q and k norm weights, the mask, the item's first and last real key and
// a flag a 32-key step: every key real.
template <int DH, int SMAX>
constexpr size_t long_smem_bytes() {
  return (size_t)(LWARPS * 16 + 4 * LKT) * LSTR * sizeof(__nv_bfloat16) +
         (size_t)LKT * 128 * (sizeof(__nv_bfloat16) + sizeof(float)) + 2 * DH * sizeof(float) +
         (size_t)(SMAX + 2 + SMAX / 32) * sizeof(int32_t);
}

// One block an SM (187 KB of shared memory), <= 128 registers a thread
// (the 16 x 128 f32 output a warp is 64 of them).
template <int DH, int SMAX>
__global__ void __launch_bounds__(LTHREADS, 1)
tiled_qknorm_rope_attention_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const float* __restrict__ qw,
    const float* __restrict__ kw, const float* __restrict__ cosv,
    const float* __restrict__ sinv, const int32_t* __restrict__ mask,
    __nv_bfloat16* __restrict__ out, int S, int H, int Hk, float eps, float scale,
    int causal) {
  static_assert(DH == 128, "the long form is the qwen form");
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);   // LWARPS x 16 rows: a warp's strip
  __nv_bfloat16* Ks = Qs + LWARPS * 16 * LSTR;                   // 2 stages x LKT rows, normed
  __nv_bfloat16* Vs = Ks + 2 * LKT * LSTR;                       // 2 stages x LKT rows
  __nv_bfloat16* Kraw = Vs + 2 * LKT * LSTR;                     // LKT x 128, staged
  float* CS = reinterpret_cast<float*>(Kraw + LKT * 128);        // LKT x (cos 64, sin 64), staged
  float* Wq = CS + LKT * 128;                                    // DH, then Wk
  float* Wk = Wq + DH;
  int32_t* Ms = reinterpret_cast<int32_t*>(Wk + DH);             // SMAX
  int32_t* Lim = Ms + SMAX;                                      // first, last real key
  int32_t* Full = Lim + 2;                                       // SMAX / 32

  const int g = blockIdx.x;
  const int b = blockIdx.y;
  const int z = gridDim.z - 1 - blockIdx.z;   // the blocks that see the most keys start first
  const int G = H / Hk;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int gq = lane >> 2, tig = lane & 3;
  const int mi = lane >> 3, mr = lane & 7;   // ldmatrix: matrix and row this lane addresses
  const size_t qstride = (size_t)H * DH;
  const size_t kstride = (size_t)Hk * DH;
  // strip st of the kv group: rows 16 (st / G) .. + 15 of q head g G + st % G
  const int nst = G * ((S + 15) >> 4);
  const int st = z * LWARPS + warp;
  const bool has = st < nst;
  const int i0 = (st / G) * 16;
  const int h = g * G + st % G;

  const __nv_bfloat16* kg = k + (size_t)g * DH;
  const __nv_bfloat16* vg = v + (size_t)g * DH;
  // tile 0's copies go out first; each warp scans 32 keys of the mask at a
  // time (a 32-key step's flag: every key real), then the first and last
  // real key of the item are reduced over the warps' partial ones
  stage_tile(kg, vg, kstride, cosv, sinv, b, S, 0, Kraw, CS, Vs);
  if (warp == 0 && lane < 2) Lim[lane] = lane ? -1 : S;
  for (int j = threadIdx.x; j < 2 * DH; j += LTHREADS) Wq[j] = j < DH ? qw[j] : kw[j - DH];
  __syncthreads();
  for (int c = 32 * warp; c < S; c += 32 * LWARPS) {
    const int j = c + lane;
    const int m = j < S ? mask[(size_t)b * S + j] : 0;
    if (j < S) Ms[j] = m;
    const unsigned bal = __ballot_sync(0xffffffffu, m != 0);
    if (lane == 0) {
      Full[c >> 5] = bal == 0xffffffffu;
      if (bal) {
        atomicMin(&Lim[0], c + __ffs(bal) - 1);
        atomicMax(&Lim[1], c + 31 - __clz(bal));
      }
    }
  }
  if (has) q_strip(q, cosv, sinv, Wq, b, S, H, h, i0, eps, scale, Qs + warp * 16 * LSTR, lane);
  __syncthreads();

  // the last key a strip's rows see: the whole range for a strip holding a
  // row with no real key, else its causal diagonal or the last real key
  const int first = Lim[0], last = Lim[1];
  auto klim = [&](int r0) {
    if (last < 0 || (causal && r0 < first)) return S - 1;
    return causal ? min(last, r0 + 15) : last;
  };
  const int lo = (z * LWARPS) / G * 16;
  const int hi = (min(z * LWARPS + LWARPS, nst) - 1) / G * 16;
  const int nkt = max(klim(lo), klim(hi)) / LKT + 1;   // klim is largest at one end
  const int mylim = has ? klim(i0) : -1;

  const __nv_bfloat16* qrow = Qs + (warp * 16 + (mi & 1) * 8 + mr) * LSTR + (mi >> 1) * 8;
  const int ia = i0 + gq, ib = ia + 8;
  // running max and sum of exp(l - max) of rows ia, ib (the sum over this
  // lane's keys until the end); the output's 16 x 128 f32, unnormalized
  float ma = -CUDART_INF_F, mb = -CUDART_INF_F, la = 0.0f, lb = 0.0f;
  float o[16][4];
#pragma unroll
  for (int n = 0; n < 16; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.0f;

  // tile 0 normed into stage 0, tile 1 staged; tile t + 2 is staged while
  // tile t is computed, and normed into the other stage after it
  cp_async_wait_all();
  __syncthreads();
  k_from_stage(Kraw, CS, Wk, eps, Ks, warp, lane);
  __syncthreads();
  if (nkt > 1) stage_tile(kg, vg, kstride, cosv, sinv, b, S, LKT, Kraw, CS, Vs + LKT * LSTR);
#pragma unroll 1
  for (int t = 0; t < nkt; ++t) {
    const int cur = t & 1;
    const __nv_bfloat16* Kt = Ks + cur * LKT * LSTR;
    const __nv_bfloat16* Vt = Vs + cur * LKT * LSTR;
#pragma unroll 1
    for (int u = 0; u < LKT / LSUB; ++u) {
      const int kb = t * LKT + u * LSUB;
      if (kb > mylim) break;
      float sc[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[j][e] = 0.0f;
      const __nv_bfloat16* krow = Kt + (u * LSUB + (mi >> 1) * 8 + mr) * LSTR + (mi & 1) * 8;
#pragma unroll
      for (int kc = 0; kc < DH / 16; ++kc) {
        uint32_t a[4];
        ldsm_x4(a, qrow + 16 * kc);
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          uint32_t kf[4];
          ldsm_x4(kf, krow + 16 * np * LSTR + 16 * kc);
          mma_bf16(sc[2 * np], a, kf[0], kf[1]);
          mma_bf16(sc[2 * np + 1], a, kf[2], kf[3]);
        }
      }
      // mask (-1e30 where masked, -inf past S; nothing where every key of
      // the step is real and seen by every row of the strip), the step's
      // row max
      float ta = -CUDART_INF_F, tb = -CUDART_INF_F;
      if (Full[kb >> 5] && (!causal || kb + LSUB - 1 <= i0)) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          ta = fmaxf(ta, fmaxf(sc[j][0], sc[j][1]));
          tb = fmaxf(tb, fmaxf(sc[j][2], sc[j][3]));
        }
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int key = kb + 8 * j + 2 * tig + e;
            float xa = -CUDART_INF_F, xb = -CUDART_INF_F;
            if (key < S) {
              const bool real = Ms[key] != 0;
              xa = (real && (!causal || key <= ia)) ? sc[j][e] : -1e30f;
              xb = (real && (!causal || key <= ib)) ? sc[j][2 + e] : -1e30f;
            }
            sc[j][e] = xa;
            sc[j][2 + e] = xb;
            ta = fmaxf(ta, xa);
            tb = fmaxf(tb, xb);
          }
        }
      }
      // the running softmax: a larger max rescales the sum and the output
      const float na = fmaxf(ma, quad_max(ta)), nb = fmaxf(mb, quad_max(tb));
      if (__any_sync(0xffffffffu, na != ma || nb != mb)) {
        const float ra = expf(ma - na), rb = expf(mb - nb);
        la = la * ra;
        lb = lb * rb;
#pragma unroll
        for (int n = 0; n < 16; ++n) {
          o[n][0] = o[n][0] * ra;
          o[n][1] = o[n][1] * ra;
          o[n][2] = o[n][2] * rb;
          o[n][3] = o[n][3] * rb;
        }
        ma = na;
        mb = nb;
      }
      // p = exp(l - max) in f32 into the sums, bf16(p) laid out as the A
      // fragments of P V (two 16-key chunks), then P V over the 32 keys
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          sc[j][e] = expf(sc[j][e] - ma);
          sc[j][2 + e] = expf(sc[j][2 + e] - mb);
          la += sc[j][e];
          lb += sc[j][2 + e];
        }
      }
      uint32_t pf[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        pf[j][0] = pack_bf16(sc[2 * j][0], sc[2 * j][1]);
        pf[j][1] = pack_bf16(sc[2 * j][2], sc[2 * j][3]);
        pf[j][2] = pack_bf16(sc[2 * j + 1][0], sc[2 * j + 1][1]);
        pf[j][3] = pack_bf16(sc[2 * j + 1][2], sc[2 * j + 1][3]);
      }
      const __nv_bfloat16* vrow = Vt + (u * LSUB + (mi & 1) * 8 + mr) * LSTR + (mi >> 1) * 8;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
#pragma unroll
        for (int np = 0; np < 8; ++np) {
          uint32_t vf[4];
          ldsm_x4_t(vf, vrow + 16 * j * LSTR + 16 * np);
          mma_bf16(o[2 * np], pf[j], vf[0], vf[1]);
          mma_bf16(o[2 * np + 1], pf[j], vf[2], vf[3]);
        }
      }
    }
    if (t + 1 < nkt) {
      cp_async_wait_all();
      __syncthreads();   // tile t + 1 staged, its V in; every warp done with tile t
      k_from_stage(Kraw, CS, Wk, eps, Ks + (cur ^ 1) * LKT * LSTR, warp, lane);
      __syncthreads();   // the staging area free; tile t + 1 normed
      if (t + 2 < nkt)
        stage_tile(kg, vg, kstride, cosv, sinv, b, S, (t + 2) * LKT, Kraw, CS,
                   Vs + cur * LKT * LSTR);
    }
  }

  if (!has) return;
  // out = bf16(o / sum), through the strip's own q rows (read by no other
  // warp) to 16-byte stores
  la = quad_sum(la);
  lb = quad_sum(lb);
  __nv_bfloat16* os = Qs + warp * 16 * LSTR;
  __syncwarp();
#pragma unroll
  for (int n = 0; n < 16; ++n) {
    *reinterpret_cast<__nv_bfloat162*>(os + gq * LSTR + 8 * n + 2 * tig) =
        __floats2bfloat162_rn(o[n][0] / la, o[n][1] / la);
    *reinterpret_cast<__nv_bfloat162*>(os + (gq + 8) * LSTR + 8 * n + 2 * tig) =
        __floats2bfloat162_rn(o[n][2] / lb, o[n][3] / lb);
  }
  __syncwarp();
  for (int i = lane; i < 16 * 16; i += 32) {
    const int r = i >> 4, c = (i & 15) * 8, row = i0 + r;
    if (row < S)
      *reinterpret_cast<uint4*>(out + ((size_t)b * S + row) * qstride + (size_t)h * DH + c) =
          *reinterpret_cast<const uint4*>(os + r * LSTR + c);
  }
}

template <int DH, int SMAX>
int launch_long(const void* q, const void* k, const void* v, const void* qw, const void* kw,
                const void* cosv, const void* sinv, const void* mask, void* out, int B, int S,
                int H, int Hk, float eps, float scale, int causal, cudaStream_t stream) {
  constexpr size_t smem = long_smem_bytes<DH, SMAX>();
  cudaError_t err = cudaFuncSetAttribute(tiled_qknorm_rope_attention_kernel<DH, SMAX>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int strips = (H / Hk) * ((S + 15) / 16);
  dim3 grid(Hk, B, (strips + LWARPS - 1) / LWARPS);
  tiled_qknorm_rope_attention_kernel<DH, SMAX><<<grid, LTHREADS, smem, stream>>>(
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
  if (S < 1 || S > 128 || Hk < 1 || H % Hk || B < 1 || B > 65535) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (Dh == 128)
    return launch_dh<128>(q, k, v, qw, kw, cosv, sinv, mask, out, B, S, H, Hk, eps, scale,
                          causal, st);
  if (Dh == 256)
    return launch_dh<256>(q, k, v, qw, kw, cosv, sinv, mask, out, B, S, H, Hk, eps, scale,
                          causal, st);
  return (int)cudaErrorInvalidValue;
}

// The long form: Dh 128, 128 < S <= 512; q, k, v and out 16-byte aligned.
extern "C" int ts_qknorm_rope_attention_long(
    const void* q, const void* k, const void* v, const void* qw, const void* kw,
    const void* cosv, const void* sinv, const void* mask, void* out, int B, int S,
    int H, int Hk, int Dh, float eps, float scale, int causal, void* stream) {
  if (Dh != 128 || S <= 128 || S > 512 || Hk < 1 || H % Hk || B < 1 || B > 65535)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (S <= 256)
    return launch_long<128, 256>(q, k, v, qw, kw, cosv, sinv, mask, out, B, S, H, Hk, eps,
                                 scale, causal, st);
  return launch_long<128, 512>(q, k, v, qw, kw, cosv, sinv, mask, out, B, S, H, Hk, eps, scale,
                               causal, st);
}
