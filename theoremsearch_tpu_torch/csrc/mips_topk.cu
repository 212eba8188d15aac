// Fused scores + exact top-k over corpus chunks: the exact route's scan.
//
// Replaces the TPU kernel theoremsearch_tpu/kernels/mips.py:_mips_kernel
// (driven by fused_mips_topk). For query b and corpus row r it scores
//
//     s = float(q[b] . corpus[r]) [* scales[r]] [+ bias[r]]     (f32, in that order)
//
// with rows >= n_valid at -inf, and keeps each query's k best per chunk of
// corpus rows. Corpus kinds: int8 codes with per-row scales (queries are
// per-query int8 codes; the per-query factor multiplies the emitted scores
// later, outside), bf16, f32. The output is (B, n_chunks * k) int64 keys:
// the order-preserving int32 image of the score above 2^31 - 1 - row, so
// one top-k over the keys (kernels/mips.py:mips_topk) merges the chunks
// with ties going to the lower row. Unfilled slots hold (-inf, row -1).
//
// What bounds it on an H100: 2*B*N*D products against N*D corpus bytes;
// at B = 512 on 1M x 1024 int8 that is 1.1e12 int8 operations (0.55 ms
// at the 1,979 TOP/s dense peak) against 1 GB (0.32 ms at 3.35 TB/s), so
// the tensor cores bound it; bf16 doubles both. The TPU kernel carried a
// running top-k across a sequential grid; blocks here run in parallel, so
// each block owns one (query tile, corpus chunk) pair and a second pass
// merges the chunks. Design: products on the tensor cores with B1's
// staging (a two-stage cp.async ring of 64-byte K slices, rows padded to
// 80 bytes), mma.sync m16n8k32 s8 or m16n8k16 bf16 with f32 sums; f32
// corpora take fmaf on the CUDA cores. Per 128-row group the block writes
// its (queries x 128) scores to shared memory, then one warp per query
// tests each score against the query's current k-th best (the reference's
// threshold test: only a score strictly above it is inserted, so an equal
// later row never displaces an earlier one) and inserts the survivors into
// a sorted per-query list in shared memory. k <= 64 uses 64-query tiles,
// larger k (up to 1024) 16-query tiles so the lists fit.
//
// Arithmetic: float(acc) * scale + bias uses __fmul_rn / __fadd_rn (never
// contracted into an fma), the reference's order, so int8 scores are
// bit-equal to the plain version's.

#include <cstdint>
#include <type_traits>
#include <cuda_runtime.h>

#include "int8_mma.cuh"

namespace {

constexpr int BN = 128;         // corpus rows per group
constexpr int BKB = 64;         // K bytes per pipeline stage
constexpr int SSTR = BKB + 16;  // padded shared row (bytes)
constexpr int THREADS = 128;    // 4 warps
constexpr int SST = BN + 4;     // score tile row stride (floats)
constexpr int KMAX = 1024;
constexpr int SMALL_K = 64;     // k <= SMALL_K: 64-query tiles, else 16
constexpr int CHUNK_SMALL = 8192, CHUNK_LARGE = 16384;   // rows per block
constexpr unsigned FULL = 0xffffffffu;

enum { KIND_I8 = 0, KIND_BF16 = 1, KIND_F32 = 2 };

// warp layout of the mma path (WM x WN warps, each 16*MT queries x 8*NT
// rows) and thread tile of the f32 path (TQ queries x TN rows)
template <int QT> struct Tile;
template <> struct Tile<64> { static constexpr int WM = 2, WN = 2, MT = 2, NT = 8, TQ = 8, TN = 8; };
template <> struct Tile<16> { static constexpr int WM = 1, WN = 4, MT = 1, NT = 4, TQ = 4, TN = 4; };

__device__ __forceinline__ void mma(int32_t (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  mma_s8(c, a, b0, b1);
}

__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

__device__ __forceinline__ float row_score(float v, long long row, int n_valid,
                                           const float* __restrict__ scales,
                                           const float* __restrict__ bias) {
  if (row >= n_valid) return neg_inf();
  if (scales != nullptr) v = __fmul_rn(v, __ldg(scales + row));
  if (bias != nullptr) v = __fadd_rn(v, __ldg(bias + row));
  return v;
}

__device__ __forceinline__ long long pack_key(float s, int row) {
  if (s == 0.f) s = 0.f;  // -0.0 counts as +0.0
  const int bits = __float_as_int(s);
  const int ord = bits < 0 ? bits ^ 0x7fffffff : bits;
  return (long long)(((unsigned long long)(unsigned)ord << 32) |
                     (unsigned long long)(0x7fffffffu - (unsigned)row));
}

template <int KIND, int QT>
__global__ void __launch_bounds__(THREADS) mips_topk_kernel(
    const int8_t* __restrict__ q, const int8_t* __restrict__ corpus,
    const float* __restrict__ scales, const float* __restrict__ bias,
    long long* __restrict__ part, int B, int row_bytes, int n_pad, int n_valid, int k,
    int chunk_rows) {
  using T = Tile<QT>;
  extern __shared__ __align__(16) unsigned char smem[];
  int8_t* As = reinterpret_cast<int8_t*>(smem);             // [2][QT * SSTR]
  int8_t* Bs = As + 2 * QT * SSTR;                            // [2][BN * SSTR]
  float* S = reinterpret_cast<float*>(Bs + 2 * BN * SSTR);    // [QT][SST]
  float* Ls = S + QT * SST;                                   // [QT][k], descending
  int* Lr = reinterpret_cast<int*>(Ls + QT * k);              // [QT][k]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int q0 = blockIdx.x * QT;
  const long long c0 = (long long)blockIdx.y * chunk_rows;
  const long long live = (long long)n_valid - c0;
  int n_groups = (int)(min((long long)chunk_rows, (long long)n_pad - c0) / BN);
  n_groups = live <= 0 ? 0 : (int)min((long long)n_groups, (live + BN - 1) / BN);
  const int nk = (row_bytes + BKB - 1) / BKB;

  for (int i = tid; i < QT * k; i += THREADS) {
    Ls[i] = neg_inf();
    Lr[i] = -1;
  }

  for (int g = 0; g < n_groups; ++g) {
    const long long row0 = c0 + (long long)g * BN;

    // one K slice of the query tile and the group's 128 corpus rows into
    // stage `st`; bytes past the row or past the batch are zero-filled
    auto load = [&](int st, int k0) {
      for (int idx = tid; idx < QT * 4; idx += THREADS) {
        const int r = idx >> 2, kb = k0 + (idx & 3) * 16;
        const bool ok = q0 + r < B && kb < row_bytes;
        cp_async16(As + st * QT * SSTR + r * SSTR + (idx & 3) * 16,
                   ok ? q + (size_t)(q0 + r) * row_bytes + kb : q, ok ? 16 : 0);
      }
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        const int idx = tid + s * THREADS, r = idx >> 2, kb = k0 + (idx & 3) * 16;
        const bool ok = kb < row_bytes;
        cp_async16(Bs + st * BN * SSTR + r * SSTR + (idx & 3) * 16,
                   ok ? corpus + (size_t)(row0 + r) * row_bytes + kb : corpus, ok ? 16 : 0);
      }
      cp_async_commit();
    };

    if constexpr (KIND == KIND_F32) {
      constexpr int NQG = QT / T::TQ, NCG = BN / T::TN;   // NQG * NCG == THREADS
      constexpr int FSTR = SSTR / 4;
      const int qg = tid / NCG, cg = tid % NCG;
      float acc[T::TQ][T::TN];
#pragma unroll
      for (int i = 0; i < T::TQ; ++i)
#pragma unroll
        for (int j = 0; j < T::TN; ++j) acc[i][j] = 0.f;
      load(0, 0);
      for (int kc = 0; kc < nk; ++kc) {
        const int st = kc & 1;
        if (kc + 1 < nk) {
          load(st ^ 1, (kc + 1) * BKB);
          cp_async_wait<1>();
        } else {
          cp_async_wait<0>();
        }
        __syncthreads();
        const float* Af = reinterpret_cast<const float*>(As + st * QT * SSTR);
        const float* Bf = reinterpret_cast<const float*>(Bs + st * BN * SSTR);
#pragma unroll 4
        for (int kk = 0; kk < BKB / 4; ++kk) {
          float a[T::TQ], b[T::TN];
#pragma unroll
          for (int i = 0; i < T::TQ; ++i) a[i] = Af[(qg + NQG * i) * FSTR + kk];
#pragma unroll
          for (int j = 0; j < T::TN; ++j) b[j] = Bf[(cg + NCG * j) * FSTR + kk];
#pragma unroll
          for (int i = 0; i < T::TQ; ++i)
#pragma unroll
            for (int j = 0; j < T::TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
        }
        __syncthreads();  // the next iteration's load overwrites this stage
      }
#pragma unroll
      for (int i = 0; i < T::TQ; ++i)
#pragma unroll
        for (int j = 0; j < T::TN; ++j) {
          const int c = cg + NCG * j;
          S[(qg + NQG * i) * SST + c] = row_score(acc[i][j], row0 + c, n_valid, scales, bias);
        }
    } else {
      using Acc = std::conditional_t<KIND == KIND_I8, int32_t, float>;
      const int wm = warp % T::WM, wn = warp / T::WM;
      const int gq = lane >> 2, tig = lane & 3;
      Acc acc[T::MT][T::NT][4];
#pragma unroll
      for (int mt = 0; mt < T::MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < T::NT; ++nt)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0;
      load(0, 0);
      for (int kc = 0; kc < nk; ++kc) {
        const int st = kc & 1;
        if (kc + 1 < nk) {
          load(st ^ 1, (kc + 1) * BKB);
          cp_async_wait<1>();
        } else {
          cp_async_wait<0>();
        }
        __syncthreads();
        const int8_t* Ast = As + st * QT * SSTR;
        const int8_t* Bst = Bs + st * BN * SSTR;
        // 32 bytes per mma: k32 of int8 or k16 of bf16, with the same
        // fragment byte offsets
#pragma unroll
        for (int ks = 0; ks < BKB; ks += 32) {
          uint32_t a[T::MT][4];
#pragma unroll
          for (int mt = 0; mt < T::MT; ++mt) {
            const int8_t* p = Ast + (wm * 16 * T::MT + mt * 16 + gq) * SSTR + ks + tig * 4;
            a[mt][0] = *reinterpret_cast<const uint32_t*>(p);
            a[mt][1] = *reinterpret_cast<const uint32_t*>(p + 8 * SSTR);
            a[mt][2] = *reinterpret_cast<const uint32_t*>(p + 16);
            a[mt][3] = *reinterpret_cast<const uint32_t*>(p + 8 * SSTR + 16);
          }
#pragma unroll
          for (int nt = 0; nt < T::NT; ++nt) {
            const int8_t* p = Bst + (wn * 8 * T::NT + nt * 8 + gq) * SSTR + ks + tig * 4;
            const uint32_t b0 = *reinterpret_cast<const uint32_t*>(p);
            const uint32_t b1 = *reinterpret_cast<const uint32_t*>(p + 16);
#pragma unroll
            for (int mt = 0; mt < T::MT; ++mt) mma(acc[mt][nt], a[mt], b0, b1);
          }
        }
        __syncthreads();  // the next iteration's load overwrites this stage
      }
#pragma unroll
      for (int mt = 0; mt < T::MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < T::NT; ++nt)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int qr = wm * 16 * T::MT + mt * 16 + gq + (i >> 1) * 8;
            const int c = wn * 8 * T::NT + nt * 8 + tig * 2 + (i & 1);
            S[qr * SST + c] = row_score((float)acc[mt][nt][i], row0 + c, n_valid, scales, bias);
          }
    }
    __syncthreads();

    // selection: one warp per query; rows are visited in increasing order
    // (ballot bits in lane order), so an insert after the equal scores
    // already listed keeps ties on the lower row
    for (int qi = warp; qi < QT; qi += THREADS / 32) {
      if (q0 + qi >= B) break;
      float* ls = Ls + qi * k;
      int* lr = Lr + qi * k;
      float thr = ls[k - 1];
#pragma unroll 1
      for (int j = 0; j < BN / 32; ++j) {
        const float v = S[qi * SST + j * 32 + lane];
        unsigned m = __ballot_sync(FULL, v > thr);
        while (m) {
          const int src = __ffs(m) - 1;
          m &= m - 1;
          const float s = __shfl_sync(FULL, v, src);
          if (!(s > thr)) continue;  // the threshold rose since the ballot
          int cnt = 0;
          for (int i = lane; i < k; i += 32) cnt += ls[i] >= s;
          const int pos = __reduce_add_sync(FULL, cnt);
          // shift [pos, k-2] up one slot, highest 32-slot chunk first
          for (int base = (k - 1) & ~31; base >= 0 && base + 31 > pos; base -= 32) {
            const int i = base + lane;
            const bool mv = i > pos && i < k;
            float vs = 0.f;
            int vr = 0;
            if (mv) {
              vs = ls[i - 1];
              vr = lr[i - 1];
            }
            __syncwarp();
            if (mv) {
              ls[i] = vs;
              lr[i] = vr;
            }
            __syncwarp();
          }
          if (lane == 0) {
            ls[pos] = s;
            lr[pos] = (int)(row0 + j * 32 + src);
          }
          __syncwarp();
          thr = ls[k - 1];
        }
      }
    }
    __syncthreads();
  }
  __syncthreads();

  const size_t wq = (size_t)gridDim.y * k;
  for (int i = tid; i < QT * k; i += THREADS) {
    const int qi = i / k, j = i - qi * k;
    if (q0 + qi < B) part[(size_t)(q0 + qi) * wq + (size_t)blockIdx.y * k + j] = pack_key(Ls[i], Lr[i]);
  }
}

template <int KIND, int QT>
int launch(const void* q, const void* corpus, const void* scales, const void* bias,
           void* part, int B, int row_bytes, int n_pad, int n_valid, int k, int chunk_rows,
           cudaStream_t stream) {
  const size_t smem = (size_t)2 * QT * SSTR + (size_t)2 * BN * SSTR +
                      (size_t)QT * SST * 4 + (size_t)QT * k * 8;
  auto kern = mips_topk_kernel<KIND, QT>;
  cudaError_t e =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((B + QT - 1) / QT, (n_pad + chunk_rows - 1) / chunk_rows);
  kern<<<grid, THREADS, smem, stream>>>(
      (const int8_t*)q, (const int8_t*)corpus, (const float*)scales, (const float*)bias,
      (long long*)part, B, row_bytes, n_pad, n_valid, k, chunk_rows);
  return (int)cudaGetLastError();
}

}  // namespace

// number of corpus chunks (the width of the partial output is chunks * k)
extern "C" int ts_mips_topk_chunks(int n_pad, int k) {
  const int rows = k <= SMALL_K ? CHUNK_SMALL : CHUNK_LARGE;
  return (n_pad + rows - 1) / rows;
}

extern "C" int ts_mips_topk(const void* q, const void* corpus, const void* scales,
                            const void* bias, void* part, int kind, int B, int D, int n_pad,
                            int n_valid, int k, void* stream) {
  if (k < 1 || k > KMAX || n_pad % BN || kind < 0 || kind > 2)
    return (int)cudaErrorInvalidValue;
  const int row_bytes = D * (kind == KIND_I8 ? 1 : kind == KIND_BF16 ? 2 : 4);
  if (row_bytes % 16) return (int)cudaErrorInvalidValue;
  const int chunk_rows = k <= SMALL_K ? CHUNK_SMALL : CHUNK_LARGE;
  if ((n_pad + chunk_rows - 1) / chunk_rows > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const bool small = k <= SMALL_K;
  switch (kind) {
    case KIND_I8:
      return small ? launch<KIND_I8, 64>(q, corpus, scales, bias, part, B, row_bytes, n_pad,
                                         n_valid, k, chunk_rows, st)
                   : launch<KIND_I8, 16>(q, corpus, scales, bias, part, B, row_bytes, n_pad,
                                         n_valid, k, chunk_rows, st);
    case KIND_BF16:
      return small ? launch<KIND_BF16, 64>(q, corpus, scales, bias, part, B, row_bytes, n_pad,
                                           n_valid, k, chunk_rows, st)
                   : launch<KIND_BF16, 16>(q, corpus, scales, bias, part, B, row_bytes, n_pad,
                                           n_valid, k, chunk_rows, st);
    default:
      return small ? launch<KIND_F32, 64>(q, corpus, scales, bias, part, B, row_bytes, n_pad,
                                          n_valid, k, chunk_rows, st)
                   : launch<KIND_F32, 16>(q, corpus, scales, bias, part, B, row_bytes, n_pad,
                                          n_valid, k, chunk_rows, st);
  }
}
