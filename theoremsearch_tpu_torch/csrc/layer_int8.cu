// Whole-layer int8 (w8a8) encoder blocks: the MLP sub-block (B4) and the
// two int8 halves of the attention sub-block (B3) around the fused
// attention core of attention.cu (B2).
//
// Replaces the TPU kernels theoremsearch_tpu/kernels/layer_int8.py:
// _mlp_kernel (driven by fused_mlp_int8_layer) and _attn_layer_kernel
// (driven by fused_attn_int8_layer and fused_attn_int8_layer_gemma), in
// both of their forms: the qwen form (pre-norm only, SwiGLU, causal
// attention) and the gemma form (sandwich post-norms with (1 + w) weights,
// GeGLU with the tanh GELU, bidirectional attention at head_dim 256).
//
//   ts_mlp_int8_layer   x -> RMSNorm + per-token quant -> gate/up int8
//                       products, dequant, act(g) * u -> bf16 h -> per-row
//                       requant -> down int8 product, dequant -> [post-norm]
//                       -> bf16 residual add
//   ts_attn_int8_qkv    x -> RMSNorm + per-token quant -> q/k/v int8
//                       products dequantized to bf16
//   ts_attn_int8_out    attention output (bf16) -> per-row requant -> o int8
//                       product, dequant -> [post-norm] -> bf16 residual add
//
// Numerics are the plain version's (kernels/layer_int8.py), operation by
// operation:
//   - norm: the sum of squares in f64, rounded to f32 (so kernel and
//     plain agree whatever their summation order), r = rsqrtf(ss * (1/D) +
//     eps) (torch.rsqrt's CUDA form), m = max|x * w| * r,
//     s = max(m * f32(1/127), 1e-12), codes rint((x * (r / s)) * w)
//     clipped to +-127 -- bit-equal to the plain version on the card;
//   - requant: s = max(max|h| * f32(1/127), 1e-12), codes rint(h / s);
//   - products: exact int8 x int8 -> int32 on the tensor cores, then
//     (__int2float_rn(acc) * row scale) * column scale in f32 (|acc| can
//     pass 2^24 at K = 3072, so the conversion rounds, as float() of the
//     plain version's exact f64 sum does);
//   - SiLU as torch computes it on the card, g / (1 + expf(-g)); the tanh
//     GELU in the plain version's operation order (`gelu_tanh`, the
//     reference's jax.nn.gelu order): x * (0.5 * (1 + tanhf(c * (x +
//     0.044715 * ((x * x) * x))))), c = f32(sqrt(2 / pi)); h and the block
//     outputs rounded to bf16; the residual add bf16 + bf16 in f32, rounded
//     to bf16;
//   - the gemma post-norm on the bf16 block output y: the sum of squares
//     in f64 as above, r = rsqrtf(ss * (1/D) + eps), bf16((y * r) * pw).
// Built with -fmad=false, so no multiply-add is contracted.
//
// What bounds it on an H100: operations. At the serving shapes (T = B * S
// = 32,768 tokens, D = 1024, I = 3072, 16/8 heads of 128) the products are
// 6 * T * D * I = 6.2e11 int8 operations for the MLP (0.313 ms at the
// 1,979 TOP/s dense int8 peak) and 2 * T * D * (2 * 2048 + 2 * 1024) =
// 4.1e11 for the attention block's projections (0.209 ms with B2's core),
// against ~0.3 GB of activations; the gemma shapes (D = 768, I = 1152, 3/1
// heads of 256) are 1.7e11 for the MLP. Only wgmma reaches the int8
// tensor cores' full rate on this card, so the products run on it.
//
// The product, i8_gemm_kernel: one block of three warpgroups per output
// tile of 128 tokens x 256 weight rows (256 columns, or 128 where N is not
// a multiple of 256; for the GLUs 128 gate rows and the same 128 up rows,
// so each thread holds g and u of the same (token, column) and the GLU is
// its epilogue). One thread of the third warpgroup (the producer) keeps a
// four-stage ring of shared-memory tiles full with TMA: each stage holds a
// 128-byte K slice of the 128 token rows and of the weight rows (weights
// stored K-contiguous, (N, K)), with the 128-byte swizzle, and its
// full/empty mbarrier pair hands it over; three more of its warps fetch
// the epilogue's token and column scales into shared memory meanwhile (but
// for the residual product). The two consumer warpgroups
// each own 64 of the token rows and issue wgmma m64nNk32 s8 x s8 -> s32
// with both operands read from shared memory, keeping one wgmma group in
// flight while releasing the stage before it; the s32 accumulators stay
// in registers (setmaxnreg moves the producer's registers to the
// consumers). Tokens past T arrive as zeros from TMA's out-of-bounds fill
// and are never stored. The weights (at most 6.3 MB a matrix) stay in the
// 50 MB L2: each product's grid runs its column tiles fastest, so the
// blocks in flight share one token tile and read the whole weight matrix
// from L2. (A pair of blocks in a cluster, each loading half of the
// weight tile and multicasting it to both, ran slower: L2 reads do not
// bound the product.) The TPU kernels instead copied all int8 weights
// (9.4 MB MLP, 6 MB attention) into VMEM once and streamed 128-token
// tiles past them.
//
// The per-token requant needs a whole row's absmax first (I = 3072 of h,
// 2048 of the attention output), so the norm + quant and the requant are
// passes of their own (one warp a row) and the intermediates h, their
// codes and the q/k/v projections go through device memory. The gemma
// post-norm needs a whole row of the product too (it normalizes over D),
// so it cannot be a tile epilogue either: with a post-norm the down/o
// product writes its bf16 output and a one-warp-a-row pass applies the
// norm and the residual add. Fusing these passes away, and a persistent
// block that overlaps one tile's epilogue with the next tile's loads, are
// later work.
//
// Measured (chip_smoke.py's phase times on an NVIDIA H100 80GB HBM3 at
// 700.00 W), at (512, 64): B3 0.969 ms and B4 0.958 ms in the qwen form
// (bounds 0.209 and 0.313), 0.437 and 0.377 ms in the gemma form; the
// products alone take 0.487 ms of B3 and 0.736 of B4, where torch._int_mm
// takes 0.675 and 0.966 for the same int8 products. The SwiGLU product
// runs at ~39% of the int8 peak: with one block an SM nothing overlaps a
// tile's first loads and its epilogue (expf and an IEEE division for each
// of a thread's 64 outputs) with the tensor cores; a persistent block that
// overlaps them is the next step.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "wgmma_tma.cuh"

namespace {

constexpr int BM = 128;        // tokens per product block
constexpr int BK = 128;        // K bytes per pipeline stage: one 128-byte swizzle atom
constexpr int GEMM_THREADS = 384;   // warpgroups 0-1 consume (64 tokens each), 2 produces
constexpr int STAGES = 4;      // TMA ring depth
constexpr int EPI_ROW = 256;   // bytes of a staged output row: 128 bf16 columns
constexpr int EPI_TILE = 64 * EPI_ROW;   // a consumer warpgroup's staged rows
constexpr int THREADS = 256;   // row passes: 8 warps, one warp a row
constexpr int ROWS_PER_BLOCK = THREADS / 32;
constexpr float INV127 = 1.0f / 127.0f;        // what XLA makes of m / 127
constexpr float MIN_SCALE = 1e-12f;

enum { EPI_BF16 = 0, EPI_GLU = 1, EPI_RESIDUAL = 2, EPI_GEGLU = 3 };
constexpr float SQRT_2_OVER_PI = 0.7978845608028654f;

__device__ __forceinline__ float gelu_tanh(float x) {
  const float x3 = (x * x) * x;
  return x * (0.5f * (1.0f + tanhf(SQRT_2_OVER_PI * (x + 0.044715f * x3))));
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ uint32_t quant4(const float (&v)[4], float mul_a, const float* w,
                                           float div_s) {
  // four codes packed little-endian; w == nullptr: rint(v / div_s),
  // else rint((v * mul_a) * w)
  uint32_t packed = 0;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float t = w ? (v[e] * mul_a) * w[e] : v[e] / div_s;
    const int c = min(max(__float2int_rn(t), -127), 127);
    packed |= (uint32_t)(uint8_t)(int8_t)c << (8 * e);
  }
  return packed;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&v)[4]) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
}

// RMSNorm fused with the per-token int8 quant: codes of x * r * w and the
// row's scale, the normed row never formed. One warp a row; D % 128 == 0.
__global__ void __launch_bounds__(THREADS) rmsnorm_quant_kernel(
    const __nv_bfloat16* __restrict__ x, const float* __restrict__ w,
    int8_t* __restrict__ q, float* __restrict__ scale, int T, int D, float eps) {
  const int row = blockIdx.x * ROWS_PER_BLOCK + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= T) return;
  const __nv_bfloat16* xr = x + (size_t)row * D;
  double ss = 0.0;
  float mx = 0.0f;
  for (int c = 4 * lane; c < D; c += 128) {
    float v[4];
    load4(xr + c, v);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      ss += (double)(v[e] * v[e]);
      mx = fmaxf(mx, fabsf(v[e]) * fabsf(w[c + e]));
    }
  }
  ss = warp_sum(ss);
  mx = warp_max(mx);
  const float r = rsqrtf((float)ss * (1.0f / (float)D) + eps);
  const float s = fmaxf(mx * r * INV127, MIN_SCALE);
  const float rs = r / s;
  for (int c = 4 * lane; c < D; c += 128) {
    float v[4];
    load4(xr + c, v);
    *reinterpret_cast<uint32_t*>(q + (size_t)row * D + c) = quant4(v, rs, w + c, 1.0f);
  }
  if (lane == 0) scale[row] = s;
}

// Per-row int8 quant of a bf16 (T, W) matrix: one warp a row; W % 128 == 0.
__global__ void __launch_bounds__(THREADS) row_quant_kernel(
    const __nv_bfloat16* __restrict__ x, int8_t* __restrict__ q, float* __restrict__ scale,
    int T, int W) {
  const int row = blockIdx.x * ROWS_PER_BLOCK + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= T) return;
  const __nv_bfloat16* xr = x + (size_t)row * W;
  float mx = 0.0f;
  for (int c = 4 * lane; c < W; c += 128) {
    float v[4];
    load4(xr + c, v);
#pragma unroll
    for (int e = 0; e < 4; ++e) mx = fmaxf(mx, fabsf(v[e]));
  }
  mx = warp_max(mx);
  const float s = fmaxf(mx * INV127, MIN_SCALE);
  for (int c = 4 * lane; c < W; c += 128) {
    float v[4];
    load4(xr + c, v);
    *reinterpret_cast<uint32_t*>(q + (size_t)row * W + c) = quant4(v, 0.0f, nullptr, s);
  }
  if (lane == 0) scale[row] = s;
}

// The gemma post-norm and residual add: out = bf16(x + bf16((y * r) * pw))
// with r the RMSNorm of the bf16 block output y. One warp a row; D % 128 == 0.
__global__ void __launch_bounds__(THREADS) post_norm_residual_kernel(
    const __nv_bfloat16* __restrict__ y, const float* __restrict__ pw,
    const __nv_bfloat16* __restrict__ x, __nv_bfloat16* __restrict__ out, int T, int D,
    float eps) {
  const int row = blockIdx.x * ROWS_PER_BLOCK + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= T) return;
  const __nv_bfloat16* yr = y + (size_t)row * D;
  const __nv_bfloat16* xr = x + (size_t)row * D;
  double ss = 0.0;
  for (int c = 4 * lane; c < D; c += 128) {
    float v[4];
    load4(yr + c, v);
#pragma unroll
    for (int e = 0; e < 4; ++e) ss += (double)(v[e] * v[e]);
  }
  ss = warp_sum(ss);
  const float r = rsqrtf((float)ss * (1.0f / (float)D) + eps);
  for (int c = 4 * lane; c < D; c += 128) {
    float v[4], xv[4];
    load4(yr + c, v);
    load4(xr + c, xv);
    __nv_bfloat162 o[2];
#pragma unroll
    for (int e = 0; e < 4; e += 2) {
      const float a = __bfloat162float(__float2bfloat16((v[e] * r) * pw[c + e]));
      const float b = __bfloat162float(__float2bfloat16((v[e + 1] * r) * pw[c + e + 1]));
      o[e / 2] = __floats2bfloat162_rn(xv[e] + a, xv[e + 1] + b);
    }
    *reinterpret_cast<uint2*>(out + (size_t)row * D + c) = *reinterpret_cast<const uint2*>(o);
  }
}

// The product's tile: CN output columns a block and WN weight rows a
// stage (the wgmma N: CN, or CN gate + CN up rows for the GLUs). One block
// an SM: a 64-accumulator consumer needs more than the 80 registers a
// thread that two 384-thread blocks would leave it.
template <int EPI, int CN>
struct Tile {
  static constexpr bool GLU = EPI == EPI_GLU || EPI == EPI_GEGLU;
  static constexpr int WN = GLU ? 2 * CN : CN;
  static constexpr int ACC = WN / 2;            // s32 accumulators a consumer thread
  static constexpr int STAGE = (BM + WN) * BK;  // bytes of one ring stage
  static constexpr int SCALES = BM + (GLU ? 2 : 1) * CN;   // f32 row and column scales
  static constexpr int SMEM = STAGES * STAGE + 1024 + 2 * STAGES * 8 + SCALES * 4;
};

// out (T, N) bf16 from a (T, K) int8 x (N, K) int8 product with per-token
// scales sa and per-column scales s0, through one of four epilogues:
//   EPI_BF16      out = bf16((acc * sa) * s0)
//   EPI_GLU       out = bf16(silu(g) * u), g from (w0, s0), u from (w1, s1)
//   EPI_GEGLU     out = bf16(gelu_tanh(g) * u), as EPI_GLU
//   EPI_RESIDUAL  out = bf16(res + bf16((acc * sa) * s0))
// ta, tw0, tw1: tensor maps of a (T, K), w0 and w1 (N, K) (tw1 unused but
// for the GLUs). Grid: (N / CN column tiles, token tiles); tokens past T
// are zero-filled and not stored. N % CN == 0, K % 128 == 0.
template <int EPI, int CN>
__global__ void __launch_bounds__(GEMM_THREADS, 1)
i8_gemm_kernel(const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tw0,
               const __grid_constant__ CUtensorMap tw1, const float* __restrict__ sa,
               const float* __restrict__ s0, const float* __restrict__ s1,
               const __nv_bfloat16* __restrict__ res, __nv_bfloat16* __restrict__ out, int T,
               int N, int K) {
  using C = Tile<EPI, CN>;
  constexpr bool GLU = C::GLU;
  // the epilogue's scales come from shared memory, fetched by the
  // producer's idle warps; the residual product, whose epilogue reads
  // the residual from device memory anyway, ran faster reading its
  // scales there too (on an H100)
  constexpr bool PREFETCHED = EPI != EPI_RESIDUAL;
  extern __shared__ unsigned char smem_raw[];
  // 128-byte swizzled tiles must start on 1024-byte boundaries
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~(uintptr_t)1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + STAGES * C::STAGE);
  uint64_t* empty = full + STAGES;
  // the block's token scales (BM), then its column scales (CN; the up
  // columns' next for the GLUs)
  float* scl = reinterpret_cast<float*>(empty + STAGES);
  const int c0 = blockIdx.x * CN;
  const int m0 = blockIdx.y * BM;
  const int nk = K / BK;
  const int wg = threadIdx.x >> 7;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2);   // one arrival from each consumer warpgroup
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 2) {
    // producer: one thread issues every TMA load of the block
    regs_dealloc<40>();
    if (PREFETCHED && threadIdx.x >= 288) {
      // warps 9-11 fetch the epilogue's scales into shared memory while
      // the mainloop runs; each consumer warpgroup waits for them before
      // its epilogue
      for (int i = threadIdx.x - 288; i < C::SCALES; i += 96) {
        float v = 0.0f;
        if (i < BM) {
          if (m0 + i < T) v = sa[m0 + i];
        } else if (i < BM + CN) {
          v = s0[c0 + i - BM];
        } else {
          v = s1[c0 + i - BM - CN];
        }
        scl[i] = v;
      }
      bar_arrive(3, 224);
      bar_arrive(4, 224);
    }
    if (threadIdx.x == 256) {
      for (int kb = 0; kb < nk; ++kb) {
        const int s = kb % STAGES;
        if (kb >= STAGES) mbar_wait(&empty[s], ((kb / STAGES) + 1) & 1);
        unsigned char* st = smem + s * C::STAGE;
        mbar_expect_tx(&full[s], C::STAGE);
        tma_load_2d(st, &ta, &full[s], kb * BK, m0);
        tma_load_2d(st + BM * BK, &tw0, &full[s], kb * BK, c0);
        if constexpr (GLU) tma_load_2d(st + (BM + CN) * BK, &tw1, &full[s], kb * BK, c0);
      }
    }
  } else {
    // consumers: warpgroup wg owns token rows 64 wg .. 64 wg + 63
    regs_alloc<232>();   // 256 x 232 + 128 x 40 registers fit the SM's 65,536
    // no zeroing: the first k step overwrites (scale-d 0); zeroing made
    // ptxas serialize the staged form's wgmma (its warning C7515)
    int32_t acc[C::ACC];
    for (int kb = 0; kb < nk; ++kb) {
      const int s = kb % STAGES;
      mbar_wait(&full[s], (kb / STAGES) & 1);
      const unsigned char* st = smem + s * C::STAGE;
      const uint64_t da = sw128_desc(st + wg * 64 * BK);
      const uint64_t db = sw128_desc(st + BM * BK);
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 32; ++kk) {
        const int accumulate = kb > 0 || kk > 0;
        if constexpr (C::WN == 256)
          wgmma_s8_n256(acc, da + 2 * kk, db + 2 * kk, accumulate);
        else
          wgmma_s8_n128(acc, da + 2 * kk, db + 2 * kk, accumulate);
      }
      wgmma_commit();
      // the group before this one has finished reading its stage
      wgmma_wait<1>();
      fence_regs(acc);
      if (kb > 0 && (threadIdx.x & 127) == 0) mbar_arrive(&empty[(kb - 1) % STAGES]);
    }
    wgmma_wait<0>();
    fence_regs(acc);

    // epilogue, in passes of 128 columns. EPI_BF16 stages each pass in its
    // warpgroup's tile in ring stage 0 (64 rows of 256 bytes, 16-byte
    // chunks XOR-swizzled by row), free once both consumer warpgroups are
    // past their last wgmma, and writes it out in coalesced 16-byte pieces;
    // the others store each thread's bf16 pairs straight to device memory
    // (staged, the residual and GLU products ran slower on an H100).
    constexpr bool STAGED = EPI == EPI_BF16;
    const int lane = threadIdx.x & 31, wq = (threadIdx.x >> 5) & 3, tl = threadIdx.x & 127;
    const int gq = lane >> 2, tig = lane & 3;
    unsigned char* stg = smem + wg * EPI_TILE;
    if constexpr (PREFETCHED) bar_sync(3 + wg, 224);   // the scales are in
    if constexpr (STAGED) bar_sync(5, 256);   // both warpgroups past their last wgmma
#pragma unroll
    for (int p = 0; p < (GLU ? 1 : CN / 128); ++p) {
      // the last pass's copy-out has read the tile
      if (STAGED && p > 0) bar_sync(1 + wg, 128);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = wq * 16 + gq + h * 8;
        const int row = m0 + wg * 64 + r;
        if (row >= T) continue;
        const float rs = PREFETCHED ? scl[wg * 64 + r] : sa[row];
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const int jj = 16 * p + j;   // n8 block of the accumulators
          const int cl = 8 * jj + 2 * tig, col = c0 + cl;
          float v[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float d = ((float)__int2float_rn(acc[4 * jj + 2 * h + e]) * rs) *
                            (PREFETCHED ? scl[BM + cl + e] : s0[col + e]);
            if constexpr (GLU) {
              const float u =
                  ((float)__int2float_rn(acc[4 * (jj + CN / 8) + 2 * h + e]) * rs) *
                  scl[BM + CN + cl + e];
              v[e] = (EPI == EPI_GLU ? d / (1.0f + expf(-d)) : gelu_tanh(d)) * u;
            } else {
              v[e] = d;
            }
          }
          const __nv_bfloat162 o = __floats2bfloat162_rn(v[0], v[1]);
          if constexpr (STAGED) {
            unsigned char* at = stg + r * EPI_ROW + ((j ^ (r & 7)) << 4) + 4 * tig;
            *reinterpret_cast<__nv_bfloat162*>(at) = o;
          } else if constexpr (EPI == EPI_RESIDUAL) {
            const float2 xr = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(res + (size_t)row * N + col));
            const float2 dv = __bfloat1622float2(o);
            *reinterpret_cast<__nv_bfloat162*>(out + (size_t)row * N + col) =
                __floats2bfloat162_rn(xr.x + dv.x, xr.y + dv.y);
          } else {
            *reinterpret_cast<__nv_bfloat162*>(out + (size_t)row * N + col) = o;
          }
        }
      }
      if constexpr (STAGED) {
        bar_sync(1 + wg, 128);
        // 64 rows x 16 pieces of 16 bytes, 8 a thread
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const int i = tl + 128 * u, r = i >> 4, c = i & 15;
          const int row = m0 + wg * 64 + r;
          if (row < T)
            *reinterpret_cast<uint4*>(out + (size_t)row * N + c0 + 128 * p + 8 * c) =
                *reinterpret_cast<const uint4*>(stg + r * EPI_ROW + ((c ^ (r & 7)) << 4));
        }
      }
    }
  }
}

int row_blocks(int T) { return (T + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK; }

template <int EPI, int CN>
int gemm_tile(const void* a, const void* sa, const void* w0, const void* s0, const void* w1,
              const void* s1, const void* res, void* out, int T, int N, int K,
              cudaStream_t stream) {
  using C = Tile<EPI, CN>;
  // tensor maps are 128 bytes each, encoded on the host for every call
  CUtensorMap ta, tw0, tw1;
  if (!tma_map_i8(&ta, a, T, K, BM) || !tma_map_i8(&tw0, w0, N, K, CN) ||
      !tma_map_i8(&tw1, C::GLU ? w1 : w0, N, K, CN))
    return (int)cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(
      i8_gemm_kernel<EPI, CN>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(N / CN, (T + BM - 1) / BM);
  i8_gemm_kernel<EPI, CN><<<grid, GEMM_THREADS, C::SMEM, stream>>>(
      ta, tw0, tw1, (const float*)sa, (const float*)s0, (const float*)s1,
      (const __nv_bfloat16*)res, (__nv_bfloat16*)out, T, N, K);
  return (int)cudaGetLastError();
}

template <int EPI>
int gemm(const void* a, const void* sa, const void* w0, const void* s0, const void* w1,
         const void* s1, const void* res, void* out, int T, int N, int K,
         cudaStream_t stream) {
  constexpr bool GLU = EPI == EPI_GLU || EPI == EPI_GEGLU;
  if (N % 128 || K % BK || (T + BM - 1) / BM > 65535) return (int)cudaErrorInvalidValue;
  // 256 weight rows a stage: 128 gate + 128 up rows for the GLUs, else
  // 256 columns where N allows (fewer bytes a product than 128)
  if constexpr (GLU) {
    return gemm_tile<EPI, 128>(a, sa, w0, s0, w1, s1, res, out, T, N, K, stream);
  } else {
    if (N % 256 == 0)
      return gemm_tile<EPI, 256>(a, sa, w0, s0, w1, s1, res, out, T, N, K, stream);
    return gemm_tile<EPI, 128>(a, sa, w0, s0, w1, s1, res, out, T, N, K, stream);
  }
}

int rmsnorm_quant(const void* x, const void* w, void* q, void* s, int T, int D, float eps,
                  cudaStream_t stream) {
  rmsnorm_quant_kernel<<<row_blocks(T), THREADS, 0, stream>>>(
      (const __nv_bfloat16*)x, (const float*)w, (int8_t*)q, (float*)s, T, D, eps);
  return (int)cudaGetLastError();
}

int row_quant(const void* x, void* q, void* s, int T, int W, cudaStream_t stream) {
  row_quant_kernel<<<row_blocks(T), THREADS, 0, stream>>>(
      (const __nv_bfloat16*)x, (int8_t*)q, (float*)s, T, W);
  return (int)cudaGetLastError();
}

int post_norm_residual(const void* y, const void* pw, const void* x, void* out, int T, int D,
                       float eps, cudaStream_t stream) {
  post_norm_residual_kernel<<<row_blocks(T), THREADS, 0, stream>>>(
      (const __nv_bfloat16*)y, (const float*)pw, (const __nv_bfloat16*)x, (__nv_bfloat16*)out,
      T, D, eps);
  return (int)cudaGetLastError();
}

// the down / o product and the residual add: straight after the product
// (pw == nullptr), or through bf16 y and the post-norm pass
int product_residual(const void* a, const void* sa, const void* w, const void* sw,
                     const void* x, const void* pw, void* y, void* out, int T, int N, int K,
                     float eps, cudaStream_t st) {
  if (!pw) return gemm<EPI_RESIDUAL>(a, sa, w, sw, nullptr, nullptr, x, out, T, N, K, st);
  int err = gemm<EPI_BF16>(a, sa, w, sw, nullptr, nullptr, nullptr, y, T, N, K, st);
  if (!err) err = post_norm_residual(y, pw, x, out, T, N, eps, st);
  return err;
}

bool dims_ok(int T, int a, int b) { return T >= 1 && a % 128 == 0 && b % 128 == 0; }

}  // namespace

// x (T, D) bf16 -> out (T, D) bf16 = x + [post_norm](MLP_int8(RMSNorm(x))).
// wg, wu (I, D) and wd (D, I) int8, K-contiguous; sg, su (I,), sd (D,) f32
// column scales; act 0 = SiLU, 1 = tanh GELU; pw (D,) f32 the post-norm
// weight or null; xq (T, D), sx (T,), h (T, I) bf16, hq (T, I), sh (T,) and
// y (T, D) bf16 (used with pw only) are scratch.
extern "C" int ts_mlp_int8_layer(const void* x, const void* nw, const void* wg, const void* wu,
                                 const void* wd, const void* sg, const void* su,
                                 const void* sd, const void* pw, void* out, void* xq, void* sx,
                                 void* h, void* hq, void* sh, void* y, int T, int D, int I,
                                 int act, float eps, void* stream) {
  if (!dims_ok(T, D, I) || act < 0 || act > 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  int err = rmsnorm_quant(x, nw, xq, sx, T, D, eps, st);
  if (!err)
    err = act ? gemm<EPI_GEGLU>(xq, sx, wg, sg, wu, su, nullptr, h, T, I, D, st)
              : gemm<EPI_GLU>(xq, sx, wg, sg, wu, su, nullptr, h, T, I, D, st);
  if (!err) err = row_quant(h, hq, sh, T, I, st);
  if (!err) err = product_residual(hq, sh, wd, sd, x, pw, y, out, T, D, I, eps, st);
  return err;
}

// x (T, D) bf16 -> q (T, HQ), k, v (T, HK) bf16 projections of
// RMSNorm(x), through int8 codes xq (T, D) and scales sx (T,). wq (HQ, D),
// wk, wv (HK, D) int8, K-contiguous; sq, sk, sv their column scales.
extern "C" int ts_attn_int8_qkv(const void* x, const void* nw, const void* wq, const void* wk,
                                const void* wv, const void* sq, const void* sk,
                                const void* sv, void* q, void* k, void* v, void* xq, void* sx,
                                int T, int D, int HQ, int HK, float eps, void* stream) {
  if (!dims_ok(T, D, HQ) || HK % 128) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  int err = rmsnorm_quant(x, nw, xq, sx, T, D, eps, st);
  if (!err) err = gemm<EPI_BF16>(xq, sx, wq, sq, nullptr, nullptr, nullptr, q, T, HQ, D, st);
  if (!err) err = gemm<EPI_BF16>(xq, sx, wk, sk, nullptr, nullptr, nullptr, k, T, HK, D, st);
  if (!err) err = gemm<EPI_BF16>(xq, sx, wv, sv, nullptr, nullptr, nullptr, v, T, HK, D, st);
  return err;
}

// ao (T, HQ) bf16 attention output -> out (T, D) bf16 = x +
// [post_norm](o_proj(ao)), through codes aq (T, HQ) and scales sa (T,). wo
// (D, HQ) int8, K-contiguous; pw (D,) f32 the post-norm weight or null; y
// (T, D) bf16 scratch (used with pw only).
extern "C" int ts_attn_int8_out(const void* ao, const void* wo, const void* so, const void* x,
                                const void* pw, void* out, void* aq, void* sa, void* y, int T,
                                int HQ, int D, float eps, void* stream) {
  if (!dims_ok(T, D, HQ)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  int err = row_quant(ao, aq, sa, T, HQ, st);
  if (!err) err = product_residual(aq, sa, wo, so, x, pw, y, out, T, D, HQ, eps, st);
  return err;
}
