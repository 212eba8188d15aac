// IVF probe-major chunk scan: raw int32 scores of a query batch against
// every row of each probed chunk of a global-scale int8 slab array.
//
// Replaces the TPU kernel theoremsearch_tpu/kernels/mips.py:_ivf_scores_kernel
// (driven by ivf_probe_scores). For query b, probed chunk i < P and slab row
// r < R it writes
//
//     out[b, i*R + r] = sum_d q8[b, d] * slabs[uids[i], r, d]      (int32)
//
// with no reduction and no selection. The TPU streamed one (R, D) slab per
// grid step, picked by a scalar-prefetched chunk index, so each unique
// probed chunk came from device memory once for the whole batch. That is
// the property kept here; the tiling is not.
//
// What bounds it on an H100: bytes. A serving batch (B <= 16) does
// 2*B*P*R*D operations on P*R*D bytes of slabs, 2*B operations a byte,
// far below the int8 tensor cores' ~590 operations a byte at 3.35 TB/s.
// Design: one block of four warps per (64-query tile, chunk i, 128-row
// tile of the chunk); the grid runs the query tiles of one slab tile side
// by side, so above 64 queries the tile's bytes come from device memory
// once and from L2 for the other query tiles, and the P * R/128 slab tiles
// give enough blocks for the 132 SMs at serving batches. Each block reads
// its own chunk index uids[i]. 64-byte K slices of the 128 slab rows and of
// the query tile stream through a two-stage cp.async ring in shared memory
// (rows padded to 80 bytes, so the fragment loads are free of bank
// conflicts) into mma.sync m16n8k32 s8 x s8 -> s32, slab rows on the
// 16-row M side and queries on the 8-wide N side: a batch of 8 fills one
// N tile, where it would fill half of an M tile. Each warp owns 32 slab
// rows x the tile's queries; N tiles past the batch are neither loaded nor
// multiplied. Integer sums are exact in any order, so the result is
// bit-equal to the plain version. A chunk index outside [0, C) writes
// zeros and reads nothing. wgmma/TMA are later work.

#include <cstdint>
#include <cuda_runtime.h>

#include "int8_mma.cuh"

namespace {

constexpr int BM = 128;       // slab rows per block (M side)
constexpr int BQ = 64;        // queries per block (N side): 8 tiles of 8
constexpr int BK = 64;        // K bytes per pipeline stage
constexpr int SSTR = BK + 16; // padded shared row: 20 words, conflict-free
constexpr int THREADS = 128;  // 4 warps, 32 slab rows each

__global__ void __launch_bounds__(THREADS) ivf_scores_kernel(
    const int8_t* __restrict__ q8, const int8_t* __restrict__ slabs,
    const int32_t* __restrict__ uids, int32_t* __restrict__ out, int B, int D, int C,
    int R, int P) {
  __shared__ __align__(16) int8_t As[2][BM * SSTR];
  __shared__ __align__(16) int8_t Bs[2][BQ * SSTR];
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, tig = lane & 3;
  const int q0 = blockIdx.x * BQ;
  const int tiles_per_chunk = R / BM;
  const int i = blockIdx.y / tiles_per_chunk;
  const int r0 = (blockIdx.y - i * tiles_per_chunk) * BM;
  const int chunk = uids[i];
  const int nq = min(BQ, B - q0);
  const int n_nt = (nq + 7) >> 3;  // query N tiles in use
  const size_t W = (size_t)P * R;
  const bool live = chunk >= 0 && chunk < C;
  const int8_t* src = slabs + ((size_t)(live ? chunk : 0) * R + r0) * D;

  int32_t acc[2][8][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[mt][nt][k] = 0;

  if (live) {
    const int nk = (D + BK - 1) / BK;
    // one K slice of the 128 slab rows and of the tile's live query rows
    // into stage `st`; bytes past D, and query rows past the batch, are
    // zero-filled
    auto load = [&](int st, int k0) {
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        const int idx = tid + s * THREADS, r = idx >> 2, kb = k0 + (idx & 3) * 16;
        const bool ok = kb < D;
        cp_async16(&As[st][r * SSTR + (idx & 3) * 16], ok ? src + (size_t)r * D + kb : src,
                   ok ? 16 : 0);
      }
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        const int idx = tid + s * THREADS, r = idx >> 2, kb = k0 + (idx & 3) * 16;
        if (r < n_nt * 8) {
          const bool ok = r < nq && kb < D;
          cp_async16(&Bs[st][r * SSTR + (idx & 3) * 16],
                     ok ? q8 + (size_t)(q0 + r) * D + kb : q8, ok ? 16 : 0);
        }
      }
      cp_async_commit();
    };

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
        uint32_t a[2][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          const int8_t* p = &As[st][(warp * 32 + mt * 16 + gq) * SSTR + ks + tig * 4];
          a[mt][0] = *reinterpret_cast<const uint32_t*>(p);
          a[mt][1] = *reinterpret_cast<const uint32_t*>(p + 8 * SSTR);
          a[mt][2] = *reinterpret_cast<const uint32_t*>(p + 16);
          a[mt][3] = *reinterpret_cast<const uint32_t*>(p + 8 * SSTR + 16);
        }
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          if (nt < n_nt) {
            const int8_t* p = &Bs[st][(nt * 8 + gq) * SSTR + ks + tig * 4];
            const uint32_t b0 = *reinterpret_cast<const uint32_t*>(p);
            const uint32_t b1 = *reinterpret_cast<const uint32_t*>(p + 16);
            mma_s8(acc[0][nt], a[0], b0, b1);
            mma_s8(acc[1][nt], a[1], b0, b1);
          }
        }
      }
      __syncthreads();  // the next iteration's load overwrites this stage
    }
  }

  // c0, c1: slab row gq, queries 2*tig and 2*tig + 1; c2, c3: row gq + 8
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    if (nt < n_nt) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int q = q0 + nt * 8 + tig * 2 + (k & 1);
        if (q < B) {
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            const int r = r0 + warp * 32 + mt * 16 + gq + (k >> 1) * 8;
            out[(size_t)q * W + (size_t)i * R + r] = acc[mt][nt][k];
          }
        }
      }
    }
  }
}

}  // namespace

extern "C" int ts_ivf_scores(const void* q8, const void* slabs, const void* uids, void* out,
                             int B, int D, int C, int R, int P, void* stream) {
  if (B < 1 || P < 1 || R % BM || D % 16 || (long long)P * (R / BM) > 65535)
    return (int)cudaErrorInvalidValue;
  dim3 grid((B + BQ - 1) / BQ, P * (R / BM));
  ivf_scores_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const int8_t*)q8, (const int8_t*)slabs, (const int32_t*)uids, (int32_t*)out, B, D, C, R,
      P);
  return (int)cudaGetLastError();
}
