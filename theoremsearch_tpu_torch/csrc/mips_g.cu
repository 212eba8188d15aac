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
// tiles per output block; t*G + grp is the index g of the 128-row group
// inside the output block's span of G*M*128 rows.
//
// Masks: `masks` is (n_masks, n_pad) int8, 0 = excluded; query b reads row
// mask_ids[b] (row 0 when mask_ids is null: the one-mask form), and an id
// outside [0, n_masks) excludes every row, as the reference's one-hot
// selector does. The TPU picked each query's mask row with a one-hot
// matmul because its matrix unit wanted one; here each thread reads the
// mask bytes of its own two queries and 32 lanes from L2 as a group
// starts, while the group's products run.
//
// What bounds it on an H100: an int8 GEMM of (B, D) x (D, N) whose (B, N)
// int32 product is reduced on the fly to (B, N / (G*M)): 2*B*N*D integer
// operations against N*D bytes of corpus, far above the memory roofline at
// B = 1024 (1.1 ms of int8 tensor-core time on 1M x 1024), so the tensor
// cores bound it, and after them the L2 bandwidth that feeds them.
//
// Design (warp-specialized, one block an SM, 384 threads):
//   - A block owns one 128-query tile and one output block's span (or a
//     1/splits slice of it). Warpgroup 2's first thread is the producer:
//     it loads the query tile once with TMA (128 rows x D bytes, K-major,
//     128-byte swizzled, resident in shared memory for the whole span when
//     D <= 1024) and then streams the span's 128-row corpus groups through
//     a 6-stage ring of 128-row x 128-byte chunks (TMA, mbarriers), running
//     ahead across groups with no drain. Warpgroups 0 and 1 each own 64 of
//     the queries and run wgmma m64n128k32 s8 x s8 -> s32 on the resident
//     query chunk and the ring's corpus chunk. A group's accumulators are
//     packed and folded into a running per-(query, lane) maximum held in
//     registers (the wgmma accumulator layout, wgmma_tma.cuh), so the
//     (B, N) product never exists. The fold of a whole unmasked group is
//     one shift and one DPX add-max (__viaddmax_s32) an element. (Two
//     accumulator sets a warpgroup, folding one while the other fills,
//     made ptxas serialize every wgmma, warning C7518.)
//   - L2 traffic: each corpus byte is read once per query tile (8 GB per
//     scan at B = 1024 on 1M x 1024; the query tile 128 KB per block),
//     against ~24 GB when the query tile was re-streamed for every group.
//     The grid runs a span's query tiles side by side (blockIdx.x), so its
//     corpus comes from device memory once.
//   - Masked forms skip whole groups. The wrapper hands a tile-need map
//     (`need`: per 128-row group, per query tile in the grouped form, 1
//     when some query of the tile may pass some row of the group; the
//     grouped form's batch is ordered by mask id first so that a tile
//     holds few signatures; the kernel writes each query's row back to
//     its caller's position). Producer and consumers walk the same groups
//     and skip the same ones: no loads, no products. The running maxima
//     start at INT32_MIN + 1, what every product of a skipped group would
//     have given, so skipping is exact and a cell with no passing row
//     reads exactly INT32_MIN + 1. Groups at or past n_valid are skipped
//     in every form.
//   - Small batches: with one query tile there are only n_blocks spans
//     for 132 SMs, so the wrapper splits each span into `splits` slices
//     (blockIdx.z) whose maxima meet in the output through atomicMax,
//     into an output the wrapper fills with INT32_MIN + 1. Max commutes,
//     so the result is bit-equal either way.
//   - D > 1024 (a query tile beyond shared memory): the query chunk rides
//     in every ring stage beside the corpus chunk instead.
// Integer products and sums are exact in any order, so the result is
// bit-equal to the plain version.
//
// Arithmetic: `score << shift` is done on the unsigned bit pattern (a
// negative signed left shift is undefined in C++17), which equals the
// reference's two's-complement shift under the packing bound
// 127*127*D*G*M < 2^31 that the wrapper enforces.

#include <cstdint>
#include <cuda.h>
#include <cuda_runtime.h>

#include "wgmma_tma.cuh"

namespace {

constexpr int QT = 128;          // queries a block: two consumer warpgroups of 64
constexpr int BN = 128;          // corpus rows a group (one per output lane)
constexpr int BK = 128;          // K bytes a chunk: one 128-byte swizzle atom
constexpr int CHUNK = BN * BK;   // 16 KB: a group's K chunk, or the query tile's
constexpr int THREADS = 384;     // warpgroups 0-1 consume, 2 produces
constexpr int MAX_RES_CHUNKS = 8;    // the query tile stays resident up to D = 1024
constexpr int32_t PACK_INVALID = -2147483647;  // kernels/mips.py INT32_MIN
constexpr int MAX_MASKS = 128;

enum { FORM_NONE = 0, FORM_MASK = 1, FORM_GMASK = 2 };

template <bool QRES>
struct Ring {
  static constexpr int STAGES = 6;
  static constexpr int STAGE = QRES ? CHUNK : 2 * CHUNK;   // corpus chunk (+ query chunk)
};

template <bool QRES>
size_t smem_bytes(int nk) {
  using R = Ring<QRES>;
  return 1024 + (QRES ? (size_t)nk * CHUNK : 0) + (size_t)R::STAGES * R::STAGE +
         (2 * R::STAGES + 1) * sizeof(uint64_t);
}

// tq, tc: tensor maps of q8 (B, D) and codes (n_pad, D), 128-row boxes.
// Grid (query tiles, output blocks, splits); slice z covers groups
// [z * per_split, (z + 1) * per_split) of its output block's g_eff.
template <int FORM, bool QRES>
__global__ void __launch_bounds__(THREADS, 1) mips_g_scan_kernel(
    const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tc,
    int32_t* __restrict__ out, int B, int nk, long long n_pad, long long n_valid, int g_eff,
    int g_shift, int per_split, int atomic, const int8_t* __restrict__ masks,
    const int32_t* __restrict__ mask_ids, int n_masks, const uint8_t* __restrict__ need,
    const int32_t* __restrict__ out_rows) {
  using R = Ring<QRES>;
  extern __shared__ unsigned char smem_raw[];
  // 128-byte swizzled tiles must start on 1024-byte boundaries
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~(uintptr_t)1023);
  unsigned char* qs = smem;                                     // QRES: nk query chunks
  unsigned char* ring = smem + (QRES ? (size_t)nk * CHUNK : 0);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + R::STAGES * R::STAGE);
  uint64_t* empty = full + R::STAGES;
  uint64_t* qbar = empty + R::STAGES;
  const int qt = blockIdx.x, q0 = qt * QT;
  const int blk = blockIdx.y;
  const int g_begin = blockIdx.z * per_split, g_end = g_begin + per_split;
  const long long span0 = (long long)blk * g_eff * BN;
  const long long n_tiles = n_pad / BN;
  const int wg = threadIdx.x >> 7;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < R::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2);   // one arrival from each consumer warpgroup
    }
    mbar_init(qbar, 1);
    mbar_fence_init();
  }
  __syncthreads();

  // producer and consumers walk the same groups and skip the same ones
  auto needed = [&](int g) -> bool {
    const long long row0 = span0 + (long long)g * BN;
    if (row0 >= n_valid) return false;
    if (FORM == FORM_NONE) return true;
    return need[(FORM == FORM_GMASK ? qt * n_tiles : 0) + row0 / BN] != 0;
  };

  if (wg == 2) {
    regs_dealloc<40>();
    if (threadIdx.x == 256) {
      if (QRES) {
        mbar_expect_tx(qbar, nk * CHUNK);
        for (int kc = 0; kc < nk; ++kc) tma_load_2d(qs + kc * CHUNK, &tq, qbar, kc * BK, q0);
      }
      int it = 0;
      for (int g = g_begin; g < g_end; ++g) {
        if (!needed(g)) continue;
        const int row0 = (int)(span0 + (long long)g * BN);
        for (int kc = 0; kc < nk; ++kc, ++it) {
          const int s = it % R::STAGES;
          if (it >= R::STAGES) mbar_wait(&empty[s], ((it / R::STAGES) + 1) & 1);
          unsigned char* st = ring + s * R::STAGE;
          mbar_expect_tx(&full[s], R::STAGE);
          tma_load_2d(st, &tc, &full[s], kc * BK, row0);
          if (!QRES) tma_load_2d(st + CHUNK, &tq, &full[s], kc * BK, q0);
        }
      }
    }
  } else {
    regs_alloc<232>();
    const int tl = threadIdx.x & 127, lane = tl & 31, wq = tl >> 5;
    const int gq = lane >> 2, tig = lane & 3;
    const int qa = q0 + wg * 64 + wq * 16 + gq;   // this thread's rows qa, qa + 8
    // mask row of each of the two rows (null: every row excluded)
    const int8_t* mrow[2] = {nullptr, nullptr};
    if (FORM != FORM_NONE) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int q = qa + 8 * h;
        int r = 0;
        if (FORM == FORM_GMASK) r = q < B ? mask_ids[q] : -1;
        if (r >= 0 && r < n_masks) mrow[h] = masks + (long long)r * n_pad;
      }
    }
    const bool same_row = FORM == FORM_GMASK && mrow[0] == mrow[1];
    int32_t best[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) best[i] = PACK_INVALID;
    // no zeroing: a group's first k step overwrites (scale-d 0)
    int32_t acc[64];
    // Nothing around the products depends on the thread: a warpgroup
    // whose queries all lie past B multiplies the zero-filled rows and
    // stores nothing. Where a wgmma, or the wait before the fold, sits
    // under a condition ptxas cannot prove uniform over the warpgroup, it
    // serializes every wgmma (warning C7518).
    if (QRES) mbar_wait(qbar, 0);
    int it = 0;   // chunks consumed
    for (int g = g_begin; g < g_end; ++g) {
      if (!needed(g)) continue;
      const long long row0 = span0 + (long long)g * BN;
      // this group's mask bytes, loaded as it starts and read after its
      // products (bits built before the chunk loop would wait for them):
      // lanes 8 j + 2 tig, + 1 of row qa + 8 h (one row in the one-mask form)
      // (the grouped form's two rows nearly always share a mask row once
      // the batch is ordered by id: then it is read once)
      // The grouped form packs two halfwords a register (halfword j & 1 of
      // raw[h][j / 2]): its two rows would spill otherwise. The one-mask
      // form keeps one a register, so that nothing reads the loads before
      // the products (packing them made it wait for L2 every group).
      constexpr int MR = FORM == FORM_GMASK ? 2 : 1;
      constexpr int PK = FORM == FORM_GMASK ? 2 : 1;
      uint32_t raw[MR][16 / PK];
      if (FORM != FORM_NONE) {
#pragma unroll
        for (int h = 0; h < MR; ++h) {
          const bool load = mrow[h] != nullptr && (h == 0 || !same_row);
          const uint16_t* p = reinterpret_cast<const uint16_t*>(
              (mrow[h] != nullptr ? mrow[h] : masks) + row0 + 2 * tig);
#pragma unroll
          for (int j = 0; j < 16; j += PK)
            raw[h][j / PK] = !load ? 0u
                             : PK == 1 ? (uint32_t)__ldg(p + 4 * j)
                                       : (uint32_t)__ldg(p + 4 * j) | ((uint32_t)__ldg(p + 4 * j + 4) << 16);
        }
      }
      for (int kc = 0; kc < nk; ++kc, ++it) {
        const int s = it % R::STAGES;
        mbar_wait(&full[s], (it / R::STAGES) & 1);
        const unsigned char* st = ring + s * R::STAGE;
        const uint64_t da = sw128_desc((QRES ? qs + kc * CHUNK : st + CHUNK) + wg * 64 * BK);
        const uint64_t db = sw128_desc(st);
        fence_regs(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 32; ++kk)
          wgmma_s8_n128(acc, da + 2 * kk, db + 2 * kk, kc > 0 || kk > 0);
        wgmma_commit();
        // the chunk before this one has finished reading its stage
        wgmma_wait<1>();
        fence_regs(acc);
        if (kc > 0 && tl == 0) mbar_arrive(&empty[(it - 1) % R::STAGES]);
      }
      wgmma_wait<0>();
      fence_regs(acc);
      if (tl == 0) mbar_arrive(&empty[(it - 1) % R::STAGES]);
      // bit 2 j + e of keep[h]: lane 8 j + 2 tig + e of row qa + 8 h is kept
      uint32_t keep[2] = {0xffffffffu, 0xffffffffu};
      if (FORM != FORM_NONE) {
#pragma unroll
        for (int h = 0; h < MR; ++h) {
          uint32_t bits = 0;
#pragma unroll
          for (int j = 0; j < 16; ++j) {
            const uint32_t v = raw[h][j / PK] >> (PK == 2 ? 16 * (j & 1) : 0);
            bits |= (uint32_t)((v & 0xffu) != 0) << (2 * j);
            bits |= (uint32_t)((v & 0xff00u) != 0) << (2 * j + 1);
          }
          keep[h] = bits;
        }
        if (FORM == FORM_MASK || same_row) keep[1] = keep[0];
      }
      if (row0 + BN > n_valid) {   // rows past n_valid: only in the last valid group
#pragma unroll
        for (int j = 0; j < 16; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const uint32_t past = (uint32_t)(row0 + 8 * j + 2 * tig + e >= n_valid) << (2 * j + e);
            keep[0] &= ~past;
            keep[1] &= ~past;
          }
      }
      // the thread's 64 cells: all kept (every unmasked group but the
      // last, a mask's runs of passing rows), none, or some
      if ((keep[0] & keep[1]) == 0xffffffffu) {
        // (score << shift) | g == (score << shift) + g: one DPX add-max an element
#pragma unroll
        for (int i = 0; i < 64; ++i)
          best[i] = __viaddmax_s32((int32_t)((uint32_t)acc[i] << g_shift), g, best[i]);
      } else if ((keep[0] | keep[1]) != 0u) {
#pragma unroll
        for (int j = 0; j < 16; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int i = 4 * j + 2 * h + e;
              const int32_t v = __viaddmax_s32((int32_t)((uint32_t)acc[i] << g_shift), g, best[i]);
              best[i] = ((keep[h] >> (2 * j + e)) & 1u) ? v : best[i];
            }
      }
    }

    {
      const long long W = (long long)gridDim.y * 128;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int q = qa + 8 * h;
        if (q < B) {
          const long long orow = out_rows != nullptr ? out_rows[q] : q;
          int32_t* o = out + orow * W + (long long)blk * 128 + 2 * tig;
#pragma unroll
          for (int j = 0; j < 16; ++j) {
            if (atomic) {
              atomicMax(o + 8 * j, best[4 * j + 2 * h]);
              atomicMax(o + 8 * j + 1, best[4 * j + 2 * h + 1]);
            } else {
              *reinterpret_cast<int2*>(o + 8 * j) =
                  make_int2(best[4 * j + 2 * h], best[4 * j + 2 * h + 1]);
            }
          }
        }
      }
    }
  }
}

template <int FORM, bool QRES>
int launch(const CUtensorMap& tq, const CUtensorMap& tc, int32_t* out, int B, int nk,
           long long n_pad, long long n_valid, int g_eff, int g_shift, int n_blocks, int splits,
           const int8_t* masks, const int32_t* mask_ids, int n_masks, const uint8_t* need,
           const int32_t* out_rows, cudaStream_t stream) {
  const size_t smem = smem_bytes<QRES>(nk);
  const cudaError_t err = cudaFuncSetAttribute(
      mips_g_scan_kernel<FORM, QRES>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((B + QT - 1) / QT, n_blocks, splits);
  mips_g_scan_kernel<FORM, QRES><<<grid, THREADS, smem, stream>>>(
      tq, tc, out, B, nk, n_pad, n_valid, g_eff, g_shift, g_eff / splits, splits > 1, masks,
      mask_ids, n_masks, need, out_rows);
  return (int)cudaGetLastError();
}

template <int FORM>
int launch_form(const CUtensorMap& tq, const CUtensorMap& tc, int32_t* out, int B, int nk,
                long long n_pad, long long n_valid, int g_eff, int g_shift, int n_blocks,
                int splits, const int8_t* masks, const int32_t* mask_ids, int n_masks,
                const uint8_t* need, const int32_t* out_rows, cudaStream_t stream) {
  if (nk <= MAX_RES_CHUNKS)
    return launch<FORM, true>(tq, tc, out, B, nk, n_pad, n_valid, g_eff, g_shift, n_blocks,
                              splits, masks, mask_ids, n_masks, need, out_rows, stream);
  return launch<FORM, false>(tq, tc, out, B, nk, n_pad, n_valid, g_eff, g_shift, n_blocks,
                             splits, masks, mask_ids, n_masks, need, out_rows, stream);
}

}  // namespace

// out (B, n_blocks * 128) int32. `need` (the masked forms): uint8 per
// 128-row group, (n_pad / 128,) for one mask, (query tiles, n_pad / 128)
// for mask rows per query. out_rows
// (int32 (B,) or null): the output row of query q (the grouped form's
// queries arrive ordered by mask id). splits > 1 needs `out` filled with
// INT32_MIN + 1.
extern "C" int ts_mips_g_scan(const void* q8, const void* codes, void* out, int B, int D,
                              int n_pad, int n_valid, int row_block, int merge_tiles,
                              const void* masks, const void* mask_ids, int n_masks,
                              const void* need, const void* out_rows, int splits,
                              void* stream) {
  const int g_eff = (row_block / 128) * merge_tiles;
  int g_shift = 0;
  while ((1 << g_shift) < g_eff) ++g_shift;
  const int n_blocks = n_pad / (row_block * merge_tiles);
  if (B < 1 || D % 16 || n_blocks < 1 || n_blocks > 65535 || n_masks > MAX_MASKS ||
      (masks != nullptr && (n_masks < 1 || need == nullptr)) || splits < 1 || splits > 64 ||
      g_eff % splits)
    return (int)cudaErrorInvalidValue;
  CUtensorMap tq, tc;
  if (!tma_map_i8(&tq, q8, B, D, QT) || !tma_map_i8(&tc, codes, n_pad, D, BN))
    return (int)cudaErrorInvalidValue;
  const int nk = (D + BK - 1) / BK;
  const cudaStream_t st = (cudaStream_t)stream;
  int32_t* o = (int32_t*)out;
  const int8_t* m = (const int8_t*)masks;
  const uint8_t* nd = (const uint8_t*)need;
  const int32_t* orows = (const int32_t*)out_rows;
  if (masks == nullptr)
    return launch_form<FORM_NONE>(tq, tc, o, B, nk, n_pad, n_valid, g_eff, g_shift, n_blocks,
                                  splits, nullptr, nullptr, 0, nullptr, orows, st);
  if (mask_ids == nullptr)
    return launch_form<FORM_MASK>(tq, tc, o, B, nk, n_pad, n_valid, g_eff, g_shift, n_blocks,
                                  splits, m, nullptr, 1, nd, orows, st);
  return launch_form<FORM_GMASK>(tq, tc, o, B, nk, n_pad, n_valid, g_eff, g_shift, n_blocks,
                                 splits, m, (const int32_t*)mask_ids, n_masks, nd, orows, st);
}

extern "C" const char* ts_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
