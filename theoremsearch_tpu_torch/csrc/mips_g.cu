// Packed lane-maxima scan of a global-scale int8 corpus: the speed path's
// candidate matrix.
//
// Replaces the TPU kernel theoremsearch_tpu/kernels/mips.py:_mips_g_kernel
// (driven by fused_mips_topk_g), unmasked form. For output block j, query b
// and lane l it writes
//
//     max over t < M, grp < G of
//         (q8[b] . codes[(j*M + t)*rb + grp*128 + l]) << log2(G*M) | (t*G + grp)
//
// with a row >= n_valid contributing INT32_MIN + 1 instead (the reference's
// INT32_MIN sentinel). G = rb / 128 column groups per corpus tile, M =
// merge_tiles tiles per output block.
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

namespace {

constexpr int BM = 64;        // queries per block
constexpr int BN = 128;       // corpus rows per group (one lane each)
constexpr int BK = 64;        // K bytes per pipeline stage
constexpr int SSTR = BK + 16; // padded shared row: 20 words, conflict-free
constexpr int THREADS = 128;  // 4 warps: 2 (queries) x 2 (lanes)
constexpr int32_t PACK_INVALID = -2147483647;  // kernels/mips.py INT32_MIN

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void mma_s8(int32_t (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__global__ void __launch_bounds__(THREADS) mips_g_scan_kernel(
    const int8_t* __restrict__ q8, const int8_t* __restrict__ codes,
    int32_t* __restrict__ out, int B, int D, int n_valid, int row_block,
    int merge_tiles, int g_shift) {
  __shared__ __align__(16) int8_t As[2][BM * SSTR];
  __shared__ __align__(16) int8_t Bs[2][BN * SSTR];
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
          const int32_t packed =
              valid ? ((int32_t)((uint32_t)acc[mt][nt][i] << g_shift) | g) : PACK_INVALID;
          best[mt][nt][i] = max(best[mt][nt][i], packed);
        }
      }
    }
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
                              int merge_tiles, void* stream) {
  const int g_eff = (row_block / 128) * merge_tiles;
  int g_shift = 0;
  while ((1 << g_shift) < g_eff) ++g_shift;
  const int n_blocks = n_pad / (row_block * merge_tiles);
  if (n_blocks > 65535) return (int)cudaErrorInvalidValue;
  dim3 grid((B + BM - 1) / BM, n_blocks);
  mips_g_scan_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const int8_t*)q8, (const int8_t*)codes, (int32_t*)out, B, D, n_valid,
      row_block, merge_tiles, g_shift);
  return (int)cudaGetLastError();
}

extern "C" const char* ts_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
