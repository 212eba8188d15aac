// The routed expert layer of the deepseek tower (kernels/moe.py):
//   - moe_plan_kernel: each expert's first pair in the pairs sorted by
//     expert (a binary search a thread), and the layer's counters;
//   - moe_grouped_gemm_kernel<true>: h = SwiGLU of each sorted pair's token
//     row through its expert's gate and up matrices, one launch;
//   - moe_grouped_gemm_kernel<false>: y = each pair's h row through its
//     expert's down matrix, one launch;
//   - moe_combine_kernel: x[token] += sum of a token's picks' y, weighted,
//     plus the shared experts' row.
//
// It replaces no TPU kernel: the JAX package has no expert layer. A layer
// of Moonlight-16B-A3B routes each real token to 6 of 64 experts, SwiGLUs
// of 1,408 on a hidden size of 2,048. What bounds it on an H100 depends on
// the rows an expert sees, about 6/64 of the sub-batch's real tokens: at
// the encoder's 64-wide buckets (<= 4,096 real tokens, <= ~400 rows an
// expert) the experts' weights (1.1 GB a layer) bound it by bytes; at the
// 512-wide ones (16-33k real tokens, 1.5-3k rows an expert) the products
// bound it by operations. So the products run on the tensor cores
// (mma.sync m16n8k16 bf16 -> f32) in 128 x 128 tiles with a 3-stage
// cp.async ring, two blocks an SM, and the grid visits an expert's row
// tiles one after another so that its weights are read from L2 by the
// tiles after the first. wgmma with TMA (wgmma_tma.cuh) was not used: the
// A operand is a gather of token rows, which TMA on Hopper cannot do, and
// a gathered A in shared memory in wgmma's layout is a later step.
//
// The design of the grouped products. The grid is one block per (row
// tile slot, column tile), column tiles fastest; the host sizes it from
// its own count of pairs (ceil(P / 128) + E slots, every split fits) and
// reads nothing back. A block finds its expert and rows from the offsets
// (a scan over the experts' tile counts, 64 values) and exits when its
// slot lies past the last expert's last tile. A (the token rows, gathered
// through `rows` in the gate/up product; h's rows, in order, in the down
// product) and B (the expert's rows of W, (out, in) K-contiguous) stream
// through shared memory in 64-wide steps, rows of 128 bytes with their
// 16-byte chunks XOR-swizzled by the row, so that cp.async's stores and
// ldmatrix's loads are free of bank conflicts; rows past the expert's last
// pair come in as zeros and are not stored. 8 warps of 64 x 32 a block.
// In the gate/up product a tile's B holds 64 rows of the gate matrix and
// the same 64 of the up matrix, and each warp takes 16 columns of each, so
// a thread holds g and u of the same output element: the epilogue writes
// h = bf16(bf16(silu(bf16 g)) * bf16 u), HF's casts.
//
// The combine adds a token's k products in pick order, each rounded to
// f32 before the add (built with -fmad=false, as the plain version's
// separate ops are): the plain version gives the same bits. No atomics in
// any of the four: repeats are bit-equal.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BM = 128;       // sorted pairs a tile
constexpr int BN = 128;       // B rows a tile: 128 outputs, or 64 of gate and 64 of up
constexpr int BK = 64;        // the reduction's step: 128-byte rows
constexpr int STAGES = 3;
constexpr int THREADS = 256;  // 8 warps: 2 x 4 of 64 x 32
constexpr int TILE = BM * BK; // elements of an A (and a B) stage
constexpr int MAX_E = 256;
constexpr size_t SMEM = (size_t)STAGES * 2 * TILE * sizeof(__nv_bfloat16);   // 96 KB

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(smem)),
               "l"(gmem), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// c += a b: a 16 x 16 bf16 (row), b 16 x 8 bf16 (col), c 16 x 8 f32; lane
// 4 gq + tig holds c0, c1 = (row gq, cols 2 tig, 2 tig + 1), c2, c3 = (row
// gq + 8, the same cols).
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// Element offset of 16-byte chunk c (0..7) of row r in a 64-wide stage.
__device__ __forceinline__ int swz(int r, int c) { return r * BK + ((c ^ (r & 7)) << 3); }

template <bool SWIGLU>
__global__ void __launch_bounds__(THREADS, 2)
moe_grouped_gemm_kernel(const __nv_bfloat16* __restrict__ a, const int32_t* __restrict__ rows,
                        const int32_t* __restrict__ offsets,
                        const __nv_bfloat16* __restrict__ w0,
                        const __nv_bfloat16* __restrict__ w1, __nv_bfloat16* __restrict__ out,
                        int E, int K, int N, int n_col_tiles) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem);   // STAGES x BM x BK
  __nv_bfloat16* Bs = As + STAGES * TILE;                        // STAGES x BN x BK
  __shared__ int s_warp[THREADS / 32];
  __shared__ int s_e, s_m0, s_m1;

  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int slot = blockIdx.x / n_col_tiles;
  const int ct = blockIdx.x % n_col_tiles;

  // which expert's row tile this slot is: an inclusive scan of the
  // experts' tile counts over the block (expert e at thread e)
  int lo = 0, hi = 0, nt = 0;
  if (t < E) {
    lo = offsets[t];
    hi = offsets[t + 1];
    nt = (hi - lo + BM - 1) / BM;
  }
  int incl = nt;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += v;
  }
  if (lane == 31) s_warp[warp] = incl;
  if (t == 0) s_e = -1;
  __syncthreads();
  int base = 0;
  for (int w = 0; w < warp; ++w) base += s_warp[w];
  const int start = base + incl - nt;
  if (t < E && slot >= start && slot < start + nt) {
    s_e = t;
    s_m0 = lo + (slot - start) * BM;
    s_m1 = hi;
  }
  __syncthreads();
  const int e = s_e;
  if (e < 0) return;
  const int m0 = s_m0, m1 = s_m1;

  // this thread's copies: chunk c of rows r0 + 32 j, for A and for B
  const int c = t & 7, r0 = t >> 3;
  const __nv_bfloat16* asrc[4];
  int abytes[4];
  const __nv_bfloat16* bsrc[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int r = r0 + 32 * j;
    const int p = m0 + r;
    const bool ok = p < m1;
    const int arow = ok ? (SWIGLU ? rows[p] : p) : 0;
    asrc[j] = a + (size_t)arow * K + 8 * c;
    abytes[j] = ok ? 16 : 0;
    const __nv_bfloat16* w = w0;
    int n = r;
    if (SWIGLU) {
      n = ct * (BN / 2) + (r & (BN / 2 - 1));
      if (r >= BN / 2) w = w1;
    } else {
      n = ct * BN + r;
    }
    bsrc[j] = w + ((size_t)e * N + n) * K + 8 * c;
  }
  const int KT = K / BK;
  auto load_stage = [&](int stage, int kt) {
    __nv_bfloat16* ad = As + stage * TILE;
    __nv_bfloat16* bd = Bs + stage * TILE;
    const int k0 = kt * BK;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = r0 + 32 * j;
      cp_async16(ad + swz(r, c), asrc[j] + k0, abytes[j]);
      cp_async16(bd + swz(r, c), bsrc[j] + k0, 16);
    }
  };

  const int wm = warp >> 2, wn = warp & 3;
  const int gq = lane >> 2, tig = lane & 3;
  // B rows of the warp's two ldmatrix.x4 (16 columns each)
  const int nb0 = SWIGLU ? 16 * wn : 32 * wn;
  const int nb1 = SWIGLU ? BN / 2 + 16 * wn : 32 * wn + 16;
  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[i][j][v] = 0.0f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < KT) load_stage(s, s);
    cp_async_commit();
  }
#pragma unroll 1
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();   // step kt landed; every warp done with step kt - 1's stage
    const int nxt = kt + STAGES - 1;
    if (nxt < KT) load_stage(nxt % STAGES, nxt);
    cp_async_commit();
    const __nv_bfloat16* At = As + (kt % STAGES) * TILE;
    const __nv_bfloat16* Bt = Bs + (kt % STAGES) * TILE;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t af[4][4], bf[2][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = 64 * wm + 16 * i + (lane & 15);
        ldsm_x4(af[i], At + swz(r, 2 * kk + (lane >> 4)));
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int r = (j ? nb1 : nb0) + (lane & 7) + ((lane >> 4) << 3);
        ldsm_x4(bf[j], Bt + swz(r, 2 * kk + ((lane >> 3) & 1)));
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          mma_bf16(acc[i][2 * j], af[i], bf[j][0], bf[j][1]);
          mma_bf16(acc[i][2 * j + 1], af[i], bf[j][2], bf[j][3]);
        }
    }
  }
  cp_async_wait<0>();

  // the epilogue: rows past the expert's last pair are not stored
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int p = m0 + 64 * wm + 16 * i + gq + 8 * half;
      if (p >= m1) continue;
      if (SWIGLU) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int col = ct * (BN / 2) + 16 * wn + 8 * j + 2 * tig;
          float hv[2];
#pragma unroll
          for (int v = 0; v < 2; ++v) {
            const float g = bf16_round(acc[i][j][2 * half + v]);
            const float u = bf16_round(acc[i][j + 2][2 * half + v]);
            const float act = bf16_round(g / (1.0f + expf(-g)));
            hv[v] = act * u;
          }
          *reinterpret_cast<__nv_bfloat162*>(out + (size_t)p * N + col) =
              __floats2bfloat162_rn(hv[0], hv[1]);
        }
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = ct * BN + 32 * wn + 8 * j + 2 * tig;
          *reinterpret_cast<__nv_bfloat162*>(out + (size_t)p * N + col) =
              __floats2bfloat162_rn(acc[i][j][2 * half], acc[i][j][2 * half + 1]);
        }
      }
    }
  }
}

// One block: offsets[e] = the first sorted pair whose expert is >= e; then
// acc += (pairs, tokens, experts with a pair, the busiest expert's pairs).
__global__ void __launch_bounds__(THREADS)
moe_plan_kernel(const int32_t* __restrict__ keys, int P, int E, int T,
                int32_t* __restrict__ offsets, long long* __restrict__ acc) {
  __shared__ int s_off[MAX_E + 1];
  __shared__ int s_touched[THREADS / 32], s_max[THREADS / 32];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  for (int e = t; e <= E; e += THREADS) {
    int lo = 0, hi = P;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (keys[mid] < e)
        lo = mid + 1;
      else
        hi = mid;
    }
    s_off[e] = lo;
    offsets[e] = lo;
  }
  __syncthreads();
  if (acc == nullptr) return;
  int touched = 0, mx = 0;
  for (int e = t; e < E; e += THREADS) {
    const int cnt = s_off[e + 1] - s_off[e];
    touched += cnt > 0;
    mx = max(mx, cnt);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    touched += __shfl_xor_sync(0xffffffffu, touched, o);
    mx = max(mx, __shfl_xor_sync(0xffffffffu, mx, o));
  }
  if (lane == 0) {
    s_touched[warp] = touched;
    s_max[warp] = mx;
  }
  __syncthreads();
  if (t == 0) {
    int tt = 0, mm = 0;
    for (int w = 0; w < THREADS / 32; ++w) {
      tt += s_touched[w];
      mm = max(mm, s_max[w]);
    }
    acc[0] += P;
    acc[1] += T;
    acc[2] += tt;
    acc[3] += mm;
  }
}

// A block a real token: 8 columns a thread, 16-byte loads and stores.
__global__ void __launch_bounds__(THREADS)
moe_combine_kernel(__nv_bfloat16* __restrict__ x, const int32_t* __restrict__ tokens,
                   const __nv_bfloat16* __restrict__ y, const int32_t* __restrict__ inv,
                   const float* __restrict__ w, const __nv_bfloat16* __restrict__ shared, int K,
                   int H) {
  const int tk = blockIdx.x;
  const size_t row = (size_t)tokens[tk];
  for (int c8 = threadIdx.x; c8 < H / 8; c8 += THREADS) {
    float acc[8];
#pragma unroll
    for (int v = 0; v < 8; ++v) acc[v] = 0.0f;
    for (int j = 0; j < K; ++j) {
      const size_t p = (size_t)inv[(size_t)tk * K + j];
      const float wj = w[(size_t)tk * K + j];
      const uint4 raw = *reinterpret_cast<const uint4*>(y + p * H + 8 * c8);
      const __nv_bfloat162* yv = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const float2 f = __bfloat1622float2(yv[v]);
        const float p0 = f.x * wj, p1 = f.y * wj;
        acc[2 * v] = j ? acc[2 * v] + p0 : p0;
        acc[2 * v + 1] = j ? acc[2 * v + 1] + p1 : p1;
      }
    }
    const uint4 sraw = *reinterpret_cast<const uint4*>(shared + (size_t)tk * H + 8 * c8);
    const uint4 xraw = *reinterpret_cast<const uint4*>(x + row * H + 8 * c8);
    const __nv_bfloat162* sv = reinterpret_cast<const __nv_bfloat162*>(&sraw);
    const __nv_bfloat162* xv = reinterpret_cast<const __nv_bfloat162*>(&xraw);
    uint4 oraw;
    __nv_bfloat162* ov = reinterpret_cast<__nv_bfloat162*>(&oraw);
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const float2 s = __bfloat1622float2(sv[v]);
      const float2 xo = __bfloat1622float2(xv[v]);
      const float r0 = bf16_round(bf16_round(acc[2 * v]) + s.x);
      const float r1 = bf16_round(bf16_round(acc[2 * v + 1]) + s.y);
      ov[v] = __floats2bfloat162_rn(xo.x + r0, xo.y + r1);
    }
    *reinterpret_cast<uint4*>(x + row * H + 8 * c8) = oraw;
  }
}

template <bool SWIGLU>
int launch_grouped(const void* a, const void* rows, const void* offsets, const void* w0,
                   const void* w1, void* out, int E, int K, int N, int max_slots,
                   cudaStream_t stream) {
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(moe_grouped_gemm_kernel<SWIGLU>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 (int)SMEM);
    if (err != cudaSuccess) return (int)err;
    attr_set = true;
  }
  const int n_col_tiles = SWIGLU ? N / (BN / 2) : N / BN;
  const long long blocks = (long long)max_slots * n_col_tiles;
  if (blocks < 1 || blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  moe_grouped_gemm_kernel<SWIGLU><<<(unsigned)blocks, THREADS, SMEM, stream>>>(
      (const __nv_bfloat16*)a, (const int32_t*)rows, (const int32_t*)offsets,
      (const __nv_bfloat16*)w0, (const __nv_bfloat16*)w1, (__nv_bfloat16*)out, E, K, N,
      n_col_tiles);
  return (int)cudaGetLastError();
}

}  // namespace

// keys (P,) int32 sorted; offsets (E + 1,) int32 out; acc (4,) int64 or null.
extern "C" int ts_moe_plan(const void* keys, int P, int E, int T, void* offsets, void* acc,
                           void* stream) {
  if (E < 1 || E > MAX_E || P < 0 || T < 0) return (int)cudaErrorInvalidValue;
  moe_plan_kernel<<<1, THREADS, 0, (cudaStream_t)stream>>>(
      (const int32_t*)keys, P, E, T, (int32_t*)offsets, (long long*)acc);
  return (int)cudaGetLastError();
}

// x (T, K) bf16, rows (P,) int32, offsets (E + 1,) int32, w_gate and w_up
// (E, N, K) bf16, h (P, N) bf16 out; N % 64 == 0, K % 64 == 0.
extern "C" int ts_moe_grouped_swiglu(const void* x, const void* rows, const void* offsets,
                                     const void* wg, const void* wu, void* h, int E, int K, int N,
                                     int max_slots, void* stream) {
  if (E < 1 || E > MAX_E || K % BK || N % (BN / 2)) return (int)cudaErrorInvalidValue;
  return launch_grouped<true>(x, rows, offsets, wg, wu, h, E, K, N, max_slots,
                              (cudaStream_t)stream);
}

// h (P, K) bf16, offsets (E + 1,) int32, w_down (E, N, K) bf16, y (P, N)
// bf16 out; N % 128 == 0, K % 64 == 0.
extern "C" int ts_moe_grouped_down(const void* h, const void* offsets, const void* wd, void* y,
                                   int E, int K, int N, int max_slots, void* stream) {
  if (E < 1 || E > MAX_E || K % BK || N % BN) return (int)cudaErrorInvalidValue;
  return launch_grouped<false>(h, nullptr, offsets, wd, wd, y, E, K, N, max_slots,
                               (cudaStream_t)stream);
}

// x (S, H) bf16 in place, tokens (T,) int32, y (P, H) bf16, inv (T K,)
// int32, w (T, K) f32, shared (T, H) bf16; H % 8 == 0.
extern "C" int ts_moe_combine(void* x, const void* tokens, const void* y, const void* inv,
                              const void* w, const void* shared, int T, int K, int H,
                              void* stream) {
  if (T < 1 || K < 1 || H % 8) return (int)cudaErrorInvalidValue;
  moe_combine_kernel<<<T, THREADS, 0, (cudaStream_t)stream>>>(
      (__nv_bfloat16*)x, (const int32_t*)tokens, (const __nv_bfloat16*)y, (const int32_t*)inv,
      (const float*)w, (const __nv_bfloat16*)shared, K, H);
  return (int)cudaGetLastError();
}
