// Device helpers shared by the int8 mma.sync kernels (mips_topk.cu,
// ivf_scores.cu): 16-byte cp.async copies into shared memory and the
// mma.sync m16n8k32 s8 x s8 -> s32 product. (The products of
// layer_int8.cu and mips_g.cu run on wgmma, wgmma_tma.cuh.)
//
// Fragment layout of mma_s8 (lane = 4 * gq + tig):
//   A (16 x 32, row-major): a0 = row gq, bytes 4*tig..+3; a1 = row gq + 8;
//     a2, a3 = the same rows at byte 16 + 4*tig.
//   B (32 x 8, column-major, i.e. K-contiguous rows of the (N, K) operand):
//     b0 = column gq, bytes 4*tig..+3; b1 = bytes 16 + 4*tig.
//   C (16 x 8): c0, c1 = row gq, columns 2*tig, 2*tig + 1; c2, c3 = row gq + 8.

#pragma once

#include <cstdint>

namespace {

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

}  // namespace
