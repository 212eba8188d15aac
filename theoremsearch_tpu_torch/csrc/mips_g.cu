// Packed lane-maxima scan of a global-scale int8 corpus: the speed path's
// candidate matrix.
//
// Replaces the TPU kernel theoremsearch_tpu/kernels/mips.py:_mips_g_kernel
// (driven by fused_mips_topk_g), all three forms: unmasked, one filter mask
// for the batch, and one mask row per query. For output block j, query b
// and lane l it writes
//
//     max over t < M, grp < G of
//         (q8[b] . codes[(j*M + t)*rb + grp*128 + l]) << log2(G*M) | (t*G + grp)
//
// with a row >= n_valid, or a row the query's mask excludes, contributing
// INT32_MIN + 1 instead (the reference's INT32_MIN sentinel), before the
// maximum. G = rb / 128 column groups per corpus tile, M = merge_tiles
// tiles per output block.
//
// Masks: `masks` is (n_masks, n_pad) int8, 0 = excluded; query b reads row
// mask_ids[b] (row 0 when mask_ids is null: the one-mask form), and an id
// outside [0, n_masks) excludes every row, as the reference's one-hot
// selector does. The TPU picked each query's mask row with a (B, G) x
// (G, row_block) one-hot matmul because its matrix unit wanted one; here
// the block stages the (n_masks, 128) mask bytes of each 128-row group in
// shared memory beside the corpus ring (one read of the stack per block,
// not per query) and each accumulator looks up its query's byte. Masking
// is a template parameter, so the unmasked form keeps its code.
//
// What bounds it on an H100: an int8 GEMM of (B, D) x (D, N) whose (B, N)
// int32 product is reduced on the fly to (B, N / (G*M)): 2*B*N*D integer
// operations against N*D bytes of corpus, far above the memory roofline at
// B = 1024, so the int8 tensor cores bound it. Design: one block of four
// warps per (64-query tile, output block); the grid runs the query tiles of
// one output block side by side, so its corpus rows come from device memory
// once and from L2 for the other tiles. Per 128-row group, 64-byte K slices
// of the query tile and of the 128 corpus rows stream through a two-stage
// cp.async ring in shared memory (rows padded to 80 bytes, so the fragment
// loads are free of bank conflicts) into mma.sync m16n8k32 s8 x s8 -> s32;
// each warp owns a 32-query x 64-lane accumulator tile. After each group
// the accumulators are packed and folded into a running per-(query, lane)
// maximum held in registers, so the (B, N) score matrix never exists.
// Integer products and sums are exact in any order, so the result is
// bit-equal to the plain version. wgmma/TMA are later work.
//
// Arithmetic: `score << shift` is done on the unsigned bit pattern (a
// negative signed left shift is undefined in C++17), which equals the
// reference's two's-complement shift under the packing bound
// 127*127*D*G*M < 2^31 that the wrapper enforces.

#include <cstdint>
#include <cuda_runtime.h>

#include "int8_mma.cuh"

namespace {

constexpr int BM = 64;        // queries per block
constexpr int BN = 128;       // corpus rows per group (one lane each)
constexpr int BK = 64;        // K bytes per pipeline stage
constexpr int SSTR = BK + 16; // padded shared row: 20 words, conflict-free
constexpr int THREADS = 128;  // 4 warps: 2 (queries) x 2 (lanes)
constexpr int32_t PACK_INVALID = -2147483647;  // kernels/mips.py INT32_MIN
constexpr int MAX_MASKS = 128;

template <bool MASKED>
__global__ void __launch_bounds__(THREADS) mips_g_scan_kernel(
    const int8_t* __restrict__ q8, const int8_t* __restrict__ codes,
    int32_t* __restrict__ out, int B, int D, int n_pad, int n_valid, int row_block,
    int merge_tiles, int g_shift, const int8_t* __restrict__ masks,
    const int32_t* __restrict__ mask_ids, int n_masks) {
  __shared__ __align__(16) int8_t As[2][BM * SSTR];
  __shared__ __align__(16) int8_t Bs[2][BN * SSTR];
  __shared__ __align__(16) int8_t Ms[MASKED ? MAX_MASKS * BN : 16];
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int wm = warp & 1, wn = warp >> 1;
  const int gq = lane >> 2, tig = lane & 3;
  const int q0 = blockIdx.x * BM;
  const int blk = blockIdx.y;
  const int G = row_block / 128;
  const int n_groups = G * merge_tiles;
  const int nk = (D + BK - 1) / BK;
  const long long W = (long long)gridDim.y * 128;

  // mask row of each of this thread's four query rows (mt, h); -1 = none
  int mrow[2][2];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int q = q0 + wm * 32 + mt * 16 + gq + h * 8;
      int r = 0;
      if (MASKED && mask_ids != nullptr) r = q < B ? mask_ids[q] : -1;
      mrow[mt][h] = (r >= 0 && r < n_masks) ? r : -1;
    }

  int32_t best[2][8][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) best[mt][nt][i] = INT32_MIN;

  for (int g = 0; g < n_groups; ++g) {
    const int t = g / G;
    const long long row0 =
        ((long long)blk * merge_tiles + t) * row_block + (long long)(g - t * G) * 128;

    // one K slice of the query tile and the group's 128 corpus rows into
    // stage `st`; bytes past D or past the batch are zero-filled
    auto load = [&](int st, int k0) {
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        const int idx = tid + s * THREADS, r = idx >> 2, kb = k0 + (idx & 3) * 16;
        const bool ok = q0 + r < B && kb < D;
        cp_async16(&As[st][r * SSTR + (idx & 3) * 16],
                   ok ? q8 + (size_t)(q0 + r) * D + kb : q8, ok ? 16 : 0);
      }
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        const int idx = tid + s * THREADS, r = idx >> 2, kb = k0 + (idx & 3) * 16;
        const bool ok = kb < D;
        cp_async16(&Bs[st][r * SSTR + (idx & 3) * 16],
                   ok ? codes + (size_t)(row0 + r) * D + kb : codes, ok ? 16 : 0);
      }
      if (MASKED && k0 == 0) {
        // the group's (n_masks, 128) mask bytes, in the first K slice's
        // commit group: complete before the epilogue reads them
        for (int idx = tid; idx < n_masks * 8; idx += THREADS) {
          const int r = idx >> 3, c = (idx & 7) * 16;
          cp_async16(&Ms[r * BN + c], masks + (size_t)r * n_pad + row0 + c, 16);
        }
      }
      cp_async_commit();
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
        uint32_t a[2][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          const int8_t* p = &As[st][(wm * 32 + mt * 16 + gq) * SSTR + ks + tig * 4];
          a[mt][0] = *reinterpret_cast<const uint32_t*>(p);
          a[mt][1] = *reinterpret_cast<const uint32_t*>(p + 8 * SSTR);
          a[mt][2] = *reinterpret_cast<const uint32_t*>(p + 16);
          a[mt][3] = *reinterpret_cast<const uint32_t*>(p + 8 * SSTR + 16);
        }
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          const int8_t* p = &Bs[st][(wn * 64 + nt * 8 + gq) * SSTR + ks + tig * 4];
          const uint32_t b0 = *reinterpret_cast<const uint32_t*>(p);
          const uint32_t b1 = *reinterpret_cast<const uint32_t*>(p + 16);
          mma_s8(acc[0][nt], a[0], b0, b1);
          mma_s8(acc[1][nt], a[1], b0, b1);
        }
      }
      __syncthreads();  // the next iteration's load overwrites this stage
    }

#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int col = wn * 64 + nt * 8 + tig * 2 + (i & 1);
        const bool valid = row0 + col < (long long)n_valid;
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          bool keep = valid;
          if (MASKED) {
            const int r = mrow[mt][i >> 1];
            keep = keep && r >= 0 && Ms[r * BN + col] != 0;
          }
          const int32_t packed =
              keep ? ((int32_t)((uint32_t)acc[mt][nt][i] << g_shift) | g) : PACK_INVALID;
          best[mt][nt][i] = max(best[mt][nt][i], packed);
        }
      }
    }
    if (MASKED) __syncthreads();  // the next group's first load overwrites Ms
  }

#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int q = q0 + wm * 32 + mt * 16 + gq + h * 8;
      if (q < B) {
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          int2 v = make_int2(best[mt][nt][2 * h], best[mt][nt][2 * h + 1]);
          *reinterpret_cast<int2*>(out + (size_t)q * W + (size_t)blk * 128 + wn * 64 +
                                   nt * 8 + tig * 2) = v;
        }
      }
    }
  }
}

}  // namespace

extern "C" int ts_mips_g_scan(const void* q8, const void* codes, void* out, int B,
                              int D, int n_pad, int n_valid, int row_block,
                              int merge_tiles, const void* masks, const void* mask_ids,
                              int n_masks, void* stream) {
  const int g_eff = (row_block / 128) * merge_tiles;
  int g_shift = 0;
  while ((1 << g_shift) < g_eff) ++g_shift;
  const int n_blocks = n_pad / (row_block * merge_tiles);
  if (n_blocks > 65535 || n_masks > MAX_MASKS || (masks != nullptr && n_masks < 1))
    return (int)cudaErrorInvalidValue;
  dim3 grid((B + BM - 1) / BM, n_blocks);
  if (masks == nullptr) {
    mips_g_scan_kernel<false><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        (const int8_t*)q8, (const int8_t*)codes, (int32_t*)out, B, D, n_pad, n_valid,
        row_block, merge_tiles, g_shift, nullptr, nullptr, 0);
  } else {
    mips_g_scan_kernel<true><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        (const int8_t*)q8, (const int8_t*)codes, (int32_t*)out, B, D, n_pad, n_valid,
        row_block, merge_tiles, g_shift, (const int8_t*)masks, (const int32_t*)mask_ids,
        n_masks);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* ts_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
