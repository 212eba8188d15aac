// BERT's attention core: masked softmax(q k^T / 8) v over heads of 64,
// bidirectional, under a padding-only mask, every head its own K and V.
//
// It replaces no TPU kernel: the reference runs BERT on its XLA
// composition (theoremsearch_tpu/encoder/bert.py: einsums over a (B, H, S,
// S) f32 logits tensor), which the port ran as float32 einsums with TF32
// off (encoder/bert.py:_attention_core, still the path of fused="off" and
// of training). The kernel keeps that composition's rounding points:
//   - the projections' bias adds, where the caller passes the biases:
//     bf16(float(x) + float(bf16(b))), as `x @ w + b.to(bf16)` rounds;
//   - logits in f32: bf16 x bf16 products (exact in f32) summed in f32,
//     scaled by 1/8 (q scaled before the products, exact in bf16), -1e30
//     at padded keys;
//   - the softmax in f32 over the whole key row, normalized before the
//     bf16 cast: a first pass over the key tiles takes each row's max and
//     sum (a larger max rescales the sum), a second recomputes the logits,
//     p = exp(l - max) * (1 / sum), rounds p to bf16 and sums P V in f32;
//   - the output rounded to bf16. Rows of padded queries are written as 0:
//     the pooling multiplies them by 0, and the plain version
//     (kernels/attention_bert.py:bert_attention_plain) writes 0 there too.
// exp(x) is ex2.approx(x log2(e)): an f32 rounding, far under the bf16
// rounding of p that follows.
//
// What bounds it on an H100: the softmax's exponentials. At the encoder's
// (64, 512) sub-batch, 12 heads: q, k, v and the output are 201 MB (0.060
// ms at 3.35 TB/s) and the two products 51.5 GFLOP (0.052 ms at 989
// TFLOP/s), but two passes take 2 x 201M exponentials, 0.11 ms at the
// SFU's 16 a clock an SM. So mma.sync is enough for the products, and the
// design keeps every other step off the exponentials' path:
//   - grid (query blocks, B, H): a block of W warps (4 at S <= 64, 8 at S
//     <= 128, else 16) takes 16 W query rows of one (item, head), each warp
//     a strip of 16 rows; blocks of one (item, head) are neighbours, so
//     their K and V come from L2;
//   - the block stages the whole key range it needs (up to the item's last
//     real key) of K and V in shared memory by cp.async: K in 64-key
//     tiles, one commit group each, then V in one group, so the first pass
//     starts on tile 0 while the rest and V are still in flight (147 KB at
//     S = 512, one block of 16 warps an SM);
//   - the strip's q rows go straight from device memory into the A
//     fragments of m16n8k16 (bias added, scaled); K is read by ldmatrix,
//     V by ldmatrix.trans; the logits of a 32-key step stay in registers;
//   - work on padding is skipped: keys past the item's last real key (they
//     would add exactly 0), strips and blocks whose query rows are all
//     padded (written as 0). A 32-key step whose keys are all real takes
//     no mask at all.
// No atomics but the mask scan's integer max: repeats are bit-equal.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int DH = 64;
constexpr int STR = DH + 8;    // shared row stride in bf16: 144 bytes, 8 rows on 8 bank quads
constexpr int KT = 64;         // keys a staged tile of K (one commit group)
constexpr int STEP = 32;       // keys a compute step: 16 x 32 f32 logits a warp
constexpr int MAX_S = 512;
constexpr float LOG2E = 1.4426950408889634f;

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
// 4 gq + tig holds c0, c1 = (row gq, cols 2 tig, 2 tig + 1), c2, c3 = (row
// gq + 8, the same cols); a0 = (row gq, k 2 tig..+1), a1 = (row gq + 8, k
// 2 tig..+1), a2, a3 = the same rows at k 8 + 2 tig; b0 = (k 2 tig..+1,
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

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// 16 bytes from gmem to smem, or 16 zero bytes where ok is false (a
// source size of 0 reads nothing).
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(smem)),
               "l"(gmem), "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most n of this thread's commit groups are pending (n <= 8:
// at most MAX_S / KT tiles of K and the group of V).
__device__ __forceinline__ void cp_async_wait(int n) {
  switch (n) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    case 3: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
    case 4: asm volatile("cp.async.wait_group 4;\n" ::: "memory"); break;
    case 5: asm volatile("cp.async.wait_group 5;\n" ::: "memory"); break;
    case 6: asm volatile("cp.async.wait_group 6;\n" ::: "memory"); break;
    case 7: asm volatile("cp.async.wait_group 7;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 8;\n" ::: "memory"); break;
  }
}

// The 8 bias values of columns c .. c + 7, rounded to bf16 (zeros without
// a bias).
__device__ __forceinline__ void bias8(const float* __restrict__ b, int c, float (&out)[8]) {
#pragma unroll
  for (int e = 0; e < 8; ++e) out[e] = b ? bf16_round(b[c + e]) : 0.0f;
}

// 8 bf16 in shared memory, in place: bf16(x + b), the bias add's rounding.
__device__ __forceinline__ void add_bias8(__nv_bfloat16* p, const float (&bb)[8]) {
  uint4 raw = *reinterpret_cast<const uint4*>(p);
  uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    w[i] = pack_bf16(f.x + bb[2 * i], f.y + bb[2 * i + 1]);
  }
  *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
}

// The strip's logits over the 32 keys at krow (its K rows as this lane
// addresses them for ldmatrix): sc[j] the keys 8 j .. 8 j + 7.
__device__ __forceinline__ void step_logits(float (&sc)[4][4], const uint32_t (&qf)[4][4],
                                            const __nv_bfloat16* krow) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) sc[j][e] = 0.0f;
#pragma unroll
  for (int kc = 0; kc < DH / 16; ++kc) {
#pragma unroll
    for (int np = 0; np < 2; ++np) {
      uint32_t kf[4];
      ldsm_x4(kf, krow + 16 * np * STR + 16 * kc);
      mma_bf16(sc[2 * np], qf[kc], kf[0], kf[1]);
      mma_bf16(sc[2 * np + 1], qf[kc], kf[2], kf[3]);
    }
  }
}

// -1e30 at the step's padded keys (nothing where all 32 are real); the
// step's max of this lane's keys in rows gq (ta) and gq + 8 (tb).
__device__ __forceinline__ void step_mask(float (&sc)[4][4], int kb, const int32_t* Ms,
                                          bool full, int tig, float& ta, float& tb) {
  ta = -CUDART_INF_F;
  tb = -CUDART_INF_F;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      if (!full && !Ms[kb + 8 * j + 2 * tig + e]) {
        sc[j][e] = -1e30f;
        sc[j][2 + e] = -1e30f;
      }
      ta = fmaxf(ta, sc[j][e]);
      tb = fmaxf(tb, sc[j][2 + e]);
    }
  }
}

// Shared memory of a block at width S (sp = S rounded up to KT): K and V
// (sp rows of STR), the mask (sp), a flag a step (every key real), the
// last real key and a flag (a real query row in the block).
size_t smem_bytes(int S) {
  const int sp = (S + KT - 1) / KT * KT;
  return (size_t)2 * sp * STR * sizeof(__nv_bfloat16) +
         (size_t)(sp + sp / STEP + 2) * sizeof(int32_t);
}

// <= 128 registers a thread at every W (the strip's 16 x 64 f32 output is
// 32 of them, its q fragments 16).
template <int W>
__global__ void __launch_bounds__(W * 32, 16 / W)
bert_attention_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v, const float* __restrict__ bq,
                      const float* __restrict__ bk, const float* __restrict__ bv,
                      const int32_t* __restrict__ mask, __nv_bfloat16* __restrict__ out, int S,
                      int H) {
  constexpr int NT = W * 32;
  constexpr int ROWS = W * 16;
  extern __shared__ __align__(16) unsigned char smem[];
  const int sp = (S + KT - 1) / KT * KT;
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem);   // sp rows
  __nv_bfloat16* Vs = Ks + sp * STR;                             // sp rows
  int32_t* Ms = reinterpret_cast<int32_t*>(Vs + sp * STR);       // 1 a real key, 0 padded or past S
  int32_t* Full = Ms + sp;                                       // sp / STEP
  int32_t* Lim = Full + sp / STEP;                               // last real key, a real row here

  const int r0 = blockIdx.x * ROWS;
  const int b = blockIdx.y;
  const int col = blockIdx.z * DH;   // the head's first column
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int gq = lane >> 2, tig = lane & 3;
  const int mi = lane >> 3, mr = lane & 7;   // ldmatrix: matrix and row this lane addresses
  const size_t rs = (size_t)H * DH;           // row stride of q, k, v and out
  const size_t tok0 = (size_t)b * S;          // the item's first token

  // the mask: each warp scans 32 keys at a time (a step's flag: every key
  // real), the item's last real key and whether a query row of the block
  // is real
  if (threadIdx.x == 0) {
    Lim[0] = -1;
    Lim[1] = 0;
  }
  __syncthreads();
  for (int c = STEP * warp; c < sp; c += STEP * W) {
    const int j = c + lane;
    const int m = (j < S && mask[tok0 + j] != 0) ? 1 : 0;
    Ms[j] = m;
    const unsigned bal = __ballot_sync(0xffffffffu, m);
    const unsigned mine = __ballot_sync(0xffffffffu, m && j >= r0 && j < r0 + ROWS);
    if (lane == 0) {
      Full[c / STEP] = bal == 0xffffffffu;
      if (bal) atomicMax(&Lim[0], c + 31 - __clz(bal));
      if (mine) Lim[1] = 1;
    }
  }
  __syncthreads();
  const int last = Lim[0];
  if (!Lim[1]) {   // every query row of the block padded
    for (int i = threadIdx.x; i < ROWS * 8; i += NT) {
      const int row = r0 + (i >> 3);
      if (row < S)
        *reinterpret_cast<uint4*>(out + (tok0 + row) * rs + col + 8 * (i & 7)) =
            make_uint4(0, 0, 0, 0);
    }
    return;
  }

  // K tiles 0 .. nkt - 1 (up to the last real key; a real query row is a
  // real key), one commit group each, then V's rows in one group; rows
  // past S come in as zeros. A thread copies the same 16-byte chunk cc of
  // every row it takes (NT is a multiple of 8).
  const int nkt = last / KT + 1;
  const int cc = threadIdx.x & 7;
  for (int t = 0; t < nkt; ++t) {
    for (int i = threadIdx.x; i < KT * 8; i += NT) {
      const int key = t * KT + (i >> 3);
      const bool ok = key < S;
      cp_async16(Ks + key * STR + 8 * cc, k + (tok0 + (ok ? key : 0)) * rs + col + 8 * cc, ok);
    }
    cp_async_commit();
  }
  for (int i = threadIdx.x; i < nkt * KT * 8; i += NT) {
    const int key = i >> 3;
    const bool ok = key < S;
    cp_async16(Vs + key * STR + 8 * cc, v + (tok0 + (ok ? key : 0)) * rs + col + 8 * cc, ok);
  }
  cp_async_commit();

  // the strip: rows ia = i0 + gq and ib = ia + 8; a warp whose 16 rows are
  // all padded computes nothing and writes zeros
  const int i0 = r0 + 16 * warp;
  const int ia = i0 + gq, ib = ia + 8;
  const bool real_a = ia < S && Ms[ia], real_b = ib < S && Ms[ib];
  const bool act = __any_sync(0xffffffffu, real_a || real_b);

  // q's A fragments from device memory: qf[kc][2 hf + rr] holds row (rr ?
  // ib : ia), head columns d, d + 1 with d = 16 kc + 8 hf + 2 tig; the bias
  // add rounded to bf16, then the scale 1/8 (exact)
  uint32_t qf[4][4];
  if (act) {
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int d = col + 16 * kc + 8 * hf + 2 * tig;
        const float b0 = bq ? bf16_round(bq[d]) : 0.0f, b1 = bq ? bf16_round(bq[d + 1]) : 0.0f;
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const int row = rr ? ib : ia;
          uint32_t w = 0;
          if (row < S) {
            const float2 x = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(q + (tok0 + row) * rs + d));
            const float x0 = bq ? bf16_round(x.x + b0) : x.x;
            const float x1 = bq ? bf16_round(x.y + b1) : x.y;
            w = pack_bf16(x0 * 0.125f, x1 * 0.125f);
          }
          qf[kc][2 * hf + rr] = w;
        }
      }
    }
  }

  // first pass: each row's max and sum of exp(l - max), tile by tile as
  // the tiles land (the bias added by the thread that copied each chunk,
  // before the block reads the tile)
  float kb8[8], vb8[8];
  bias8(bk, col + 8 * cc, kb8);
  bias8(bv, col + 8 * cc, vb8);
  const __nv_bfloat16* krow = Ks + ((mi >> 1) * 8 + mr) * STR + (mi & 1) * 8;
  float ma = -CUDART_INF_F, mb = -CUDART_INF_F, la = 0.0f, lb = 0.0f;
#pragma unroll 1
  for (int t = 0; t < nkt; ++t) {
    cp_async_wait(nkt - t);   // K tiles 0 .. t in; later tiles and V may be pending
    if (bk)
      for (int i = threadIdx.x; i < KT * 8; i += NT)
        add_bias8(Ks + (t * KT + (i >> 3)) * STR + 8 * cc, kb8);
    __syncthreads();
    if (!act) continue;
#pragma unroll
    for (int u = 0; u < KT / STEP; ++u) {
      const int kb = t * KT + u * STEP;
      if (kb > last) break;
      float sc[4][4], ta, tb;
      step_logits(sc, qf, krow + kb * STR);
      step_mask(sc, kb, Ms, Full[kb / STEP] != 0, tig, ta, tb);
      const float na = fmaxf(ma, quad_max(ta)), nb = fmaxf(mb, quad_max(tb));
      la *= ex2((ma - na) * LOG2E);   // 0 while the max was -inf
      lb *= ex2((mb - nb) * LOG2E);
      ma = na;
      mb = nb;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          la += ex2((sc[j][e] - ma) * LOG2E);
          lb += ex2((sc[j][2 + e] - mb) * LOG2E);
        }
      }
    }
  }

  cp_async_wait(0);
  if (bv)
    for (int i = threadIdx.x; i < nkt * KT * 8; i += NT)
      add_bias8(Vs + (i >> 3) * STR + 8 * cc, vb8);
  __syncthreads();

  const size_t oa = (tok0 + ia) * rs + col + 2 * tig, ob = (tok0 + ib) * rs + col + 2 * tig;
  if (!act) {
#pragma unroll
    for (int n = 0; n < DH / 8; ++n) {
      if (ia < S) *reinterpret_cast<uint32_t*>(out + oa + 8 * n) = 0u;
      if (ib < S) *reinterpret_cast<uint32_t*>(out + ob + 8 * n) = 0u;
    }
    return;
  }

  // second pass: the same logits, p = bf16(exp(l - max) / sum), P V in f32
  la = quad_sum(la);
  lb = quad_sum(lb);
  const float ra = 1.0f / la, rb = 1.0f / lb;
  float o[DH / 8][4];
#pragma unroll
  for (int n = 0; n < DH / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.0f;
  const __nv_bfloat16* vrow = Vs + ((mi & 1) * 8 + mr) * STR + (mi >> 1) * 8;
#pragma unroll 1
  for (int kb = 0; kb <= last; kb += STEP) {
    float sc[4][4], ta, tb;
    step_logits(sc, qf, krow + kb * STR);
    step_mask(sc, kb, Ms, Full[kb / STEP] != 0, tig, ta, tb);
    // p laid out as the A fragments of P V (two 16-key chunks)
    uint32_t pf[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const float (&s)[4] = sc[2 * j + hh];
        pf[j][2 * hh] = pack_bf16(ex2((s[0] - ma) * LOG2E) * ra, ex2((s[1] - ma) * LOG2E) * ra);
        pf[j][2 * hh + 1] = pack_bf16(ex2((s[2] - mb) * LOG2E) * rb,
                                      ex2((s[3] - mb) * LOG2E) * rb);
      }
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int np = 0; np < DH / 16; ++np) {
        uint32_t vf[4];
        ldsm_x4_t(vf, vrow + (kb + 16 * j) * STR + 16 * np);
        mma_bf16(o[2 * np], pf[j], vf[0], vf[1]);
        mma_bf16(o[2 * np + 1], pf[j], vf[2], vf[3]);
      }
    }
  }

  // out = bf16(o), 0 on padded query rows
#pragma unroll
  for (int n = 0; n < DH / 8; ++n) {
    if (ia < S)
      *reinterpret_cast<uint32_t*>(out + oa + 8 * n) = real_a ? pack_bf16(o[n][0], o[n][1]) : 0u;
    if (ib < S)
      *reinterpret_cast<uint32_t*>(out + ob + 8 * n) = real_b ? pack_bf16(o[n][2], o[n][3]) : 0u;
  }
}

template <int W>
int launch(const void* q, const void* k, const void* v, const void* bq, const void* bk,
           const void* bv, const void* mask, void* out, int B, int S, int H, cudaStream_t stream) {
  const size_t smem = smem_bytes(S);
  cudaError_t err = cudaFuncSetAttribute(bert_attention_kernel<W>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((S + 16 * W - 1) / (16 * W), B, H);
  bert_attention_kernel<W><<<grid, W * 32, smem, stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v,
      (const float*)bq, (const float*)bk, (const float*)bv, (const int32_t*)mask,
      (__nv_bfloat16*)out, S, H);
  return (int)cudaGetLastError();
}

}  // namespace

// q, k, v, out (B, S, H * 64) bf16, 16-byte aligned; bq, bk, bv (H * 64)
// f32 or null (no bias add); mask (B, S) int32; 1 <= S <= 512.
extern "C" int ts_bert_attention(const void* q, const void* k, const void* v, const void* bq,
                                 const void* bk, const void* bv, const void* mask, void* out,
                                 int B, int S, int H, void* stream) {
  if (S < 1 || S > MAX_S || B < 1 || B > 65535 || H < 1 || H > 65535)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (S <= 64) return launch<4>(q, k, v, bq, bk, bv, mask, out, B, S, H, st);
  if (S <= 128) return launch<8>(q, k, v, bq, bk, bv, mask, out, B, S, H, st);
  return launch<16>(q, k, v, bq, bk, bv, mask, out, B, S, H, st);
}
