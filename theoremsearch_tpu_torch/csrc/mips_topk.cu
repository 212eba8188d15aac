// Fused scores + exact top-k over spans of corpus groups: the exact
// route's scan.
//
// Replaces the TPU kernel theoremsearch_tpu/kernels/mips.py:_mips_kernel
// (driven by fused_mips_topk). For query b and corpus row r it scores
//
//     s = float(q[b] . corpus[r]) [* scales[r]] [+ bias[r]]     (f32, in that order)
//
// with rows >= n_valid at -inf, and keeps each query's k best in each
// span of corpus groups. Corpus kinds: int8 codes
// with per-row scales (queries are per-query int8 codes; the per-query
// factor multiplies the emitted scores later, outside), bf16, f32. The
// output is (B, n_spans * k) int64 keys: the order-preserving int32
// image of the score above 2^31 - 1 - row, so one top-k over the keys
// (kernels/mips.py:mips_topk) merges the spans with ties going to the
// lower row. Unfilled slots hold (-inf, row -1).
//
// What bounds it on an H100: 2*B*N*D products against N*D corpus bytes;
// at B = 512 on 1M x 1024 int8 that is 1.1e12 int8 operations (0.55 ms at
// the 1,979 TOP/s dense peak) against 1 GB (0.32 ms at 3.35 TB/s), so the
// tensor cores bound it, and after them the L2 reads that feed them: each
// 64-query tile reads the whole corpus, 8 GB a scan at B = 512. The kernel
// before this one ran 12.4 ms there: 4.7 of products (mma.sync behind a
// two-stage cp.async ring) and 7.7 of selection serialized behind them
// (one warp a query inserting survivors one at a time into lists that
// restarted at -inf every 8,192 rows).
//
// Design (warp-specialized, one block an SM, 384 threads):
//   - Products. A block owns one query tile (64 queries; 16 for k > 64,
//     so that the tile's heaps fit) and one span of 128-row groups.
//     Warpgroup 2's first thread is the producer: it loads the
//     query tile once with TMA (resident in shared memory while it fits
//     beside the heaps; otherwise each ring stage carries the query chunk
//     beside the corpus chunk), streams the span's groups through a ring
//     of 128-row x 128-byte corpus chunks (TMA, mbarriers), and stages
//     each group's 128 scales and bias values with bulk copies into a ring
//     of side slots. Warpgroups 0 and 1 take the span's groups in turns
//     (ping-pong): one runs a group's products while the other selects
//     from its own. 64-query tiles run wgmma m64n128k32 s8 x s8 -> s32 or
//     m64n128k16 bf16 -> f32 (A the query tile, B the corpus chunk); the
//     smaller tiles run two m64nNk32 (A the two 64-row halves of the
//     chunk, B the query tile). The product never goes to shared memory.
//     (A first design split each group's rows between the two warpgroups
//     in lockstep, m64n64: both re-read the query tile, shared memory
//     bandwidth bound the products, and both selected at once while the
//     tensor cores idled: 4.0 ms at B = 512.) f32 corpora (TF32 stays
//     off, as in the plain version and the reference's Precision.HIGHEST)
//     take fmaf on the CUDA cores from the same ring.
//   - Selection in the epilogue, from registers. Each query has one
//     min-heap of its k best keys in shared memory (its root the k-th best
//     so far: the threshold), shared by both warpgroups under a per-query
//     lock. Each consumer thread forms the score of each of its
//     accumulator elements with the reference's arithmetic; a branch-free
//     pass marks those whose score reaches their query's threshold score
//     (the heap's root, read as the group's epilogue starts), and only
//     those take the full key test and leave registers: a shared
//     atomicAdd on the query's count gives a slot in the warpgroup's
//     candidate buffer (score, row). When some buffer is full (a
//     warpgroup barrier that ORs the flags), one thread a query offers its
//     buffer to the heap (4-ary; a key that beats the root replaces it and
//     sinks), the thresholds rise, and the elements that found no slot
//     are tested again; the last offers come at the span's end. A query's
//     candidates over a span number about k (1 + ln(rows / k)), most of
//     them in the span's first groups; a warpgroup's first group, which
//     meets empty heaps, is filtered by each query's exact k-th best
//     score of the group (a bitwise search over the 4 lanes that hold the
//     query; not in the 16-query or f32 forms). (Sorted k-lists that
//     merged each full buffer by rank ran 2.4-2.8 ms at B = 512: a merge
//     held the ring for both warpgroups, and each warpgroup's own lists
//     saw half the rows, so twice the candidates passed.)
//   - The trap: the threshold test is on keys, never on the score alone.
//     Candidates reach the buffer in no set order (warps, atomics), and a
//     test "score strictly above the k-th score" would drop a row whose
//     score ties the k-th one from a lower row. With keys, a lower row
//     with an equal score is a larger key and passes; the heap orders by
//     key, so arrival order does not matter.
//   - Spans. The grid is (query tiles, spans) with spans chosen so that
//     the blocks fill the card's SMs once; a heap starts empty once a
//     span, not every 8,192 rows, and the wrapper's torch.topk merges the
//     spans' heaps. A span takes every n_spans-th group of the list: a
//     run of similar rows (a cluster of near-duplicates passes many
//     candidates) is spread over every block instead of slowing one.
//   - Skipping. A span walks the list of needed groups: all groups below
//     n_valid when there is no bias, else those with some bias value above
//     -inf (the wrapper's need map, compacted on the card; its count stays
//     on the card too). Producer and consumers walk the same list: a
//     skipped group has no loads and no products. This is exact: a row of
//     a skipped group scores -inf, and (-inf, row) never beats an empty
//     slot's (-inf, -1), which is what an unfilled slot reads anyway.
//
// Arithmetic: float(acc) * scale + bias uses __fmul_rn / __fadd_rn (never
// contracted into an fma), the reference's order, so int8 scores are
// bit-equal to the plain version's. A missing scale multiplies by 1 and a
// missing bias adds +0 (which only turns a -0 score into +0, and keys
// count -0 as +0).

#include <algorithm>
#include <climits>
#include <cstdint>
#include <type_traits>
#include <cuda.h>
#include <cuda_runtime.h>

#include "wgmma_tma.cuh"

namespace {

constexpr int BN = 128;            // corpus rows a group
constexpr int BK = 128;            // K bytes a chunk: one 128-byte swizzle atom
constexpr int CHUNK = BN * BK;     // a group's 16 KB corpus chunk
constexpr int THREADS = 384;       // warpgroups 0-1 consume, 2 produces
constexpr int CONSUMERS = 256;
constexpr int WG_THREADS = 128;
constexpr int CB = 32;             // candidate slots a query and warpgroup
constexpr int CBS = CB + 1;        // their stride: odd, so that lanes on other queries
                                   // fall in other banks
constexpr int GSL = 4;             // side slots: a group's scales and bias values
constexpr int SIDE = 2 * BN * 4;   // one side slot: a group's 128 scales and 128 bias values
constexpr int KMAX = 1024;
constexpr int MAX_STAGES = 8;
constexpr int MIN_RES_STAGES = 3;  // the query tile stays resident if this many stages fit
constexpr size_t SMEM_MAX = 232448;
constexpr long long EMPTY_KEY = (long long)0x807fffff80000000ULL;  // (-inf, row -1)

enum { KIND_I8 = 0, KIND_BF16 = 1, KIND_F32 = 2 };

// queries a tile: its heaps (NQ * k keys) must fit beside the ring
__host__ __device__ constexpr int query_tile(int k) { return k <= 64 ? 64 : 16; }

// a heap's stride in keys: odd, so that lanes working on other queries'
// heaps fall in other banks
__host__ __device__ constexpr int heap_stride(int k) { return k | 1; }

// byte offsets of the shared-memory regions (after 1024-byte alignment)
struct Layout {
  size_t qs, ring, side, heaps, bufs, bufr, cnt, locks, sg, bars, total;
  int stage;
};

__host__ __device__ inline size_t align_up(size_t x, size_t a) { return (x + a - 1) / a * a; }

__host__ __device__ inline Layout layout(int nq, bool qres, int nk, int k, int stages) {
  Layout l;
  l.stage = CHUNK + (qres ? 0 : nq * BK);
  l.qs = 0;
  l.ring = qres ? (size_t)nk * nq * BK : 0;
  l.side = l.ring + (size_t)stages * l.stage;
  l.heaps = l.side + (size_t)GSL * SIDE;
  l.bufs = l.heaps + (size_t)nq * heap_stride(k) * 8;
  l.bufr = l.bufs + (size_t)2 * nq * CBS * 4;
  l.cnt = l.bufr + (size_t)2 * nq * CBS * 4;
  l.locks = l.cnt + (size_t)2 * nq * 4;
  l.sg = l.locks + (size_t)nq * 4;
  l.bars = align_up(l.sg + (GSL + 1) * 4, 8);   // sg[GSL], then `posted`
  l.total = 1024 + l.bars + (size_t)(2 * stages + 2 * GSL + 1) * 8;
  return l;
}

// The element map of a consumer thread's NQ accumulators (tl: the
// thread's index in its warpgroup): row slot r (NR corpus rows of the
// group) and query slot u (NT queries of the tile) of element i. LPQ > 0:
// the LPQ lanes that hold a query's NR rows each are aligned within one
// warp (the first group's threshold, below).
template <int KIND, int NQ>
struct Elems {
  // two m64nNQ (A the chunk's 64-row halves c): element (NQ / 2) c + 4 j +
  // 2 h + e is row 64 c + 16 wq + gq + 8 h, query 8 j + 2 tig + e
  static constexpr int NR = 4, NT = NQ / 4, LPQ = 0;
  __device__ static int rslot(int i) { return 2 * (i / (NQ / 2)) + ((i >> 1) & 1); }
  __device__ static int qslot(int i) { return 2 * ((i % (NQ / 2)) >> 2) + (i & 1); }
  __device__ static int elem(int r, int u) {
    return (NQ / 2) * (r >> 1) + 4 * (u >> 1) + 2 * (r & 1) + (u & 1);
  }
  __device__ static int row(int tl, int r) {
    return 64 * (r >> 1) + 16 * (tl >> 5) + ((tl & 31) >> 2) + 8 * (r & 1);
  }
  __device__ static int query(int tl, int u) { return 8 * (u >> 1) + 2 * (tl & 3) + (u & 1); }
};

template <int KIND>
struct Elems<KIND, 64> {
  // m64n128 (A the query tile): element 4 j + 2 h + e is query 16 wq + gq +
  // 8 h, row 8 j + 2 tig + e
  static constexpr int NR = 32, NT = 2, LPQ = 4;
  __device__ static int rslot(int i) { return 2 * (i >> 2) + (i & 1); }
  __device__ static int qslot(int i) { return (i >> 1) & 1; }
  __device__ static int elem(int r, int u) { return 4 * (r >> 1) + 2 * u + (r & 1); }
  __device__ static int row(int tl, int r) { return 8 * (r >> 1) + 2 * (tl & 3) + (r & 1); }
  __device__ static int query(int tl, int u) { return 16 * (tl >> 5) + ((tl & 31) >> 2) + 8 * u; }
};

template <int NQ>
struct F32Elems {
  // fmaf: element 8 u + r is row (tl & 15) + 16 r, query (tl >> 4) + 8 u.
  // No first-group bound: its registers made the f32 scan spill, 12% slower.
  static constexpr int NR = 8, NT = NQ / 8, LPQ = 0;
  __device__ static int rslot(int i) { return i & 7; }
  __device__ static int qslot(int i) { return i >> 3; }
  __device__ static int elem(int r, int u) { return 8 * u + r; }
  __device__ static int row(int tl, int r) { return (tl & 15) + 16 * r; }
  __device__ static int query(int tl, int u) { return (tl >> 4) + 8 * u; }
};
template <> struct Elems<KIND_F32, 64> : F32Elems<64> {};
template <> struct Elems<KIND_F32, 16> : F32Elems<16> {};

// one 32-byte K step of a warpgroup's product on stage chunk `st` and
// query chunk `qch`
__device__ __forceinline__ void mma_step(int32_t (&d)[64], uint64_t st, uint64_t qch, int acc) {
  wgmma_s8_n128(d, qch, st, acc);
}
__device__ __forceinline__ void mma_step(float (&d)[64], uint64_t st, uint64_t qch, int acc) {
  wgmma_bf16_n128(d, qch, st, acc);
}
// (the second half of the chunk starts 64 rows = 8 KB on: 512 in the
// descriptor's 16-byte address units)
__device__ __forceinline__ void mma_step(int32_t (&d)[16], uint64_t st, uint64_t qch, int acc) {
  wgmma_s8_n16<0>(d, st, qch, acc);
  wgmma_s8_n16<1>(d, st + 512, qch, acc);
}
__device__ __forceinline__ void mma_step(float (&d)[16], uint64_t st, uint64_t qch, int acc) {
  wgmma_bf16_n16<0>(d, st, qch, acc);
  wgmma_bf16_n16<1>(d, st + 512, qch, acc);
}
// the producer's count of corpus chunks posted to the ring, published
// with release semantics and read with acquire
__device__ __forceinline__ void store_release(int* p, int v) {
  asm volatile("st.release.cta.shared.u32 [%0], %1;\n" ::"r"(smem_addr(p)), "r"(v) : "memory");
}
__device__ __forceinline__ int load_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.cta.shared.u32 %0, [%1];\n" : "=r"(v) : "r"(smem_addr(p)) : "memory");
  return v;
}

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

__device__ __forceinline__ long long pack_key(float s, int row) {
  if (s == 0.f) s = 0.f;  // -0.0 counts as +0.0
  const int bits = __float_as_int(s);
  const int ord = bits < 0 ? bits ^ 0x7fffffff : bits;
  return (long long)(((unsigned long long)(unsigned)ord << 32) |
                     (unsigned long long)(0x7fffffffu - (unsigned)row));
}

// (score, row) of a key; row -1 for an empty slot
__device__ __forceinline__ void unpack_key(long long key, float& s, int& row) {
  const int ord = (int)(key >> 32);
  s = __int_as_float(ord < 0 ? ord ^ 0x7fffffff : ord);
  row = (int)(0x7fffffffu - (unsigned)(key & 0xffffffffLL));
}

// Offer key x to the min-heap h of k keys (h[0] the smallest: the k-th
// best so far, the threshold): x replaces the root if it beats it and
// sinks to its place. The heap is 4-ary (the children of i are 4 i + 1
// .. 4 i + 4): a level's four loads are in flight together, and a 40-key
// heap is 4 levels deep rather than 6.
__device__ void heap_offer(long long* h, int k, long long x) {
  if (x <= h[0]) return;
  int i = 0;
  for (;;) {
    const int c0 = 4 * i + 1;
    if (c0 >= k) break;
    long long v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = c0 + j < k ? h[c0 + j] : LLONG_MAX;
    int c = c0;
    long long cv = v[0];
#pragma unroll
    for (int j = 1; j < 4; ++j)
      if (v[j] < cv) {
        cv = v[j];
        c = c0 + j;
      }
    if (cv >= x) break;
    h[i] = cv;
    i = c;
  }
  h[i] = x;
}

struct Args {
  const float* scales;    // (n_pad,) per-row scales, or null
  const float* bias;      // (n_pad,), or null
  const int32_t* glist;   // the needed groups (null: 0, 1, ...)
  const int32_t* gcount;  // their number, on the card (null: the groups below n_valid)
  long long* part;        // (B, n_spans * k) keys
  int B, nk, n_valid, k, stages;
};

// tq, tc: tensor maps of the queries (B, row_bytes) and the corpus (n_pad,
// row_bytes), as bytes. Grid (query tiles, spans).
template <int KIND, int NQ, bool QRES>
__global__ void __launch_bounds__(THREADS, 1) mips_topk_kernel(
    const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tc,
    const Args a) {
  const float* __restrict__ scales = a.scales;
  const float* __restrict__ bias = a.bias;
  const int32_t* __restrict__ glist = a.glist;
  const int32_t* __restrict__ gcount = a.gcount;
  long long* __restrict__ part = a.part;
  const int B = a.B, nk = a.nk, n_valid = a.n_valid, k = a.k, stages = a.stages;
  using Acc = std::conditional_t<KIND == KIND_I8, int32_t, float>;
  using E = Elems<KIND, NQ>;
  constexpr int NA = NQ;   // accumulators a consumer thread
  extern __shared__ unsigned char smem_raw[];
  // 128-byte swizzled tiles must start on 1024-byte boundaries
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~(uintptr_t)1023);
  const Layout lay = layout(NQ, QRES, nk, k, stages);
  unsigned char* qs = smem + lay.qs;
  unsigned char* ring = smem + lay.ring;
  unsigned char* side = smem + lay.side;
  int* sg = reinterpret_cast<int*>(smem + lay.sg);
  int* posted = sg + GSL;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + lay.bars);
  uint64_t* empty = full + stages;
  uint64_t* sfull = empty + stages;
  uint64_t* sempty = sfull + GSL;
  uint64_t* qbar = sempty + GSL;

  const int q0 = blockIdx.x * NQ;
  const int nq = min(NQ, B - q0);   // live queries of the tile
  const int nvg = n_valid <= 0 ? 0 : (n_valid + BN - 1) / BN;
  const int count = gcount != nullptr ? *gcount : nvg;
  // the span's groups: positions span, span + n_spans, ... of the list
  // (interleaved, so that a run of similar rows, which passes many
  // candidates, is shared by every span rather than slowing one block)
  const int span = blockIdx.y, n_spans = gridDim.y;
  const int n_span = count > span ? (count - 1 - span) / n_spans + 1 : 0;
  auto group_at = [&](int gi) {
    const int pos = span + gi * n_spans;
    return glist != nullptr ? glist[pos] : pos;
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      // one arrival from the consuming warpgroup (wgmma) or its four warps (fmaf)
      mbar_init(&empty[s], KIND == KIND_F32 ? 4 : 1);
    }
    for (int s = 0; s < GSL; ++s) {
      mbar_init(&sfull[s], 1);
      mbar_init(&sempty[s], 1);
    }
    mbar_init(qbar, 1);
    mbar_fence_init();
  }
  {
    long long* heaps = reinterpret_cast<long long*>(smem + lay.heaps);
    int* cnt = reinterpret_cast<int*>(smem + lay.cnt);
    int* locks = reinterpret_cast<int*>(smem + lay.locks);
    for (int i = threadIdx.x; i < NQ * heap_stride(k); i += THREADS) heaps[i] = EMPTY_KEY;
    for (int i = threadIdx.x; i < 2 * NQ; i += THREADS) cnt[i] = 0;
    for (int i = threadIdx.x; i < NQ; i += THREADS) locks[i] = 0;
    if (threadIdx.x == 0) *posted = 0;
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {
    if (threadIdx.x == CONSUMERS) {
      if (QRES) {
        mbar_expect_tx(qbar, nk * NQ * BK);
        for (int kc = 0; kc < nk; ++kc) tma_load_2d(qs + kc * NQ * BK, &tq, qbar, kc * BK, q0);
      }
      const uint32_t side_bytes = (scales != nullptr ? BN * 4 : 0) + (bias != nullptr ? BN * 4 : 0);
      int s = 0, round = 0, gs = 0, ground = 0, pos = 0;
      for (int gi = 0; gi < n_span; ++gi) {
        const int g = group_at(gi);
        if (ground > 0) mbar_wait(&sempty[gs], (ground - 1) & 1);
        sg[gs] = g;
        mbar_expect_tx(&sfull[gs], side_bytes);
        float* sd = reinterpret_cast<float*>(side + gs * SIDE);
        if (scales != nullptr) bulk_load(sd, scales + (size_t)g * BN, BN * 4, &sfull[gs]);
        if (bias != nullptr) bulk_load(sd + BN, bias + (size_t)g * BN, BN * 4, &sfull[gs]);
        if (++gs == GSL) {
          gs = 0;
          ++ground;
        }
        for (int kc = 0; kc < nk; ++kc) {
          if (round > 0) mbar_wait(&empty[s], (round - 1) & 1);
          unsigned char* st = ring + (size_t)s * lay.stage;
          mbar_expect_tx(&full[s], lay.stage);
          tma_load_2d(st, &tc, &full[s], kc * BK, g * BN);
          if (!QRES) tma_load_2d(st + CHUNK, &tq, &full[s], kc * BK, q0);
          store_release(posted, ++pos);
          if (++s == stages) {
            s = 0;
            ++round;
          }
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg takes the span's groups wg, wg + 2, ... ----
  const int t = threadIdx.x, wg = t >> 7, tl = t & 127, lane = t & 31;
  const int bar_id = 1 + wg;
  long long* heaps = reinterpret_cast<long long*>(smem + lay.heaps);
  int* locks = reinterpret_cast<int*>(smem + lay.locks);
  float* bufs = reinterpret_cast<float*>(smem + lay.bufs) + wg * NQ * CBS;
  int* bufr = reinterpret_cast<int*>(smem + lay.bufr) + wg * NQ * CBS;
  const int hs = heap_stride(k);
  int* cnt = reinterpret_cast<int*>(smem + lay.cnt) + wg * NQ;
  // thresholds (score, row) of the thread's queries: empty heaps at first;
  // a query past B never passes
  // ta: what the cheap pass compares with, the larger of ts and the k-th
  // best score of the warpgroup's first group
  float ts[E::NT], ta[E::NT], first_kth[E::NT];
  int tr[E::NT];
#pragma unroll
  for (int u = 0; u < E::NT; ++u) {
    ts[u] = E::query(tl, u) < nq ? neg_inf() : __int_as_float(0x7f800000);
    tr[u] = -1;
    first_kth[u] = neg_inf();
  }
  // the warpgroup's buffers into the heaps: one thread a query, under the
  // query's lock (the other warpgroup may be offering to the same heap)
  auto drain = [&]() {
    const int n = tl < nq ? min(cnt[tl], CB) : 0;
    if (n > 0) {
      while (atomicCAS(&locks[tl], 0, 1) != 0) {
      }
      __threadfence_block();
      long long* h = heaps + tl * hs;
      for (int j = 0; j < n; ++j)
        heap_offer(h, k, pack_key(bufs[tl * CBS + j], bufr[tl * CBS + j]));
      __threadfence_block();
      atomicExch(&locks[tl], 0);
      cnt[tl] = 0;
    }
  };
  // thresholds: the heaps' roots (read without the lock: a root only rises,
  // and a stale one lets more through, never fewer)
  auto load_thresholds = [&]() {
#pragma unroll
    for (int u = 0; u < E::NT; ++u) {
      if (E::query(tl, u) < nq) unpack_key(heaps[E::query(tl, u) * hs], ts[u], tr[u]);
      ta[u] = fmaxf(ts[u], first_kth[u]);
    }
  };
  Acc acc[NA];
  // Nothing around the products depends on the thread: rows past B multiply
  // the zero-filled query rows and are never appended. A wgmma, or the wait
  // before the epilogue that reads the accumulators, under a condition
  // ptxas cannot prove uniform over the warpgroup makes it serialize every
  // wgmma (warning C7518).
  if (QRES) mbar_wait(qbar, 0);
  for (int gi = wg; gi < n_span; gi += 2) {
    // the group's place in the producer's ring and side slots
    const long long it0 = (long long)gi * nk;
    int s = (int)(it0 % stages), ph = (int)((it0 / stages) & 1), prev = s;
    const int gs = gi % GSL, gph = (gi / GSL) & 1;
    if constexpr (KIND == KIND_F32) {
#pragma unroll
      for (int i = 0; i < NA; ++i) acc[i] = 0.f;
    }
    for (int kc = 0; kc < nk; ++kc) {
      // The two warpgroups wait on one ring out of turn: a phase-parity
      // wait is exact only once the stage's previous fill has landed, which
      // holds once this chunk is posted (its stage was released after that
      // fill was consumed).
      while (load_acquire(posted) <= (int)(it0 + kc)) {
      }
      mbar_wait(&full[s], ph);
      const unsigned char* st = ring + (size_t)s * lay.stage;
      const unsigned char* qch = QRES ? qs + kc * NQ * BK : st + CHUNK;
      if constexpr (KIND == KIND_F32) {
        // 8 float4 steps of K; element (r, 4 f + i) of a swizzled tile is
        // at r * 128 + ((f ^ (r & 7)) << 4) + 4 i
#pragma unroll 2
        for (int f = 0; f < BK / 16; ++f) {
          float4 a[E::NR];
#pragma unroll
          for (int r = 0; r < E::NR; ++r) {
            const int row = E::row(tl, r);
            a[r] = *reinterpret_cast<const float4*>(st + row * BK + ((f ^ (row & 7)) << 4));
          }
#pragma unroll
          for (int u = 0; u < E::NT; ++u) {
            const int qr = E::query(tl, u);
            const float4 b =
                *reinterpret_cast<const float4*>(qch + qr * BK + ((f ^ (qr & 7)) << 4));
#pragma unroll
            for (int r = 0; r < E::NR; ++r) {
              float& c = acc[E::elem(r, u)];
              c = fmaf(a[r].x, b.x, c);
              c = fmaf(a[r].y, b.y, c);
              c = fmaf(a[r].z, b.z, c);
              c = fmaf(a[r].w, b.w, c);
            }
          }
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[s]);
      } else {
        const uint64_t dst = sw128_desc(st), dq = sw128_desc(qch);
        fence_regs(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 32; ++kk)
          mma_step(acc, dst + 2 * kk, dq + 2 * kk, kc > 0 || kk > 0);
        wgmma_commit();
        // the chunk before this one has finished reading its stage
        wgmma_wait<1>();
        fence_regs(acc);
        if (kc > 0 && tl == 0) mbar_arrive(&empty[prev]);
      }
      prev = s;
      if (++s == stages) {
        s = 0;
        ph ^= 1;
      }
    }
    if constexpr (KIND != KIND_F32) {
      wgmma_wait<0>();
      fence_regs(acc);
      if (tl == 0) mbar_arrive(&empty[prev]);
    }

    // epilogue: scores, the threshold test on keys, candidates out
    load_thresholds();
    mbar_wait(&sfull[gs], gph);
    const int row0 = sg[gs] * BN;
    const float* sd = reinterpret_cast<const float*>(side + gs * SIDE);
    // score of element i of row slot r (group row `row`); rows past n_valid
    // score -inf through their bias term
    auto score = [&](int i, int row) {
      float v;
      if constexpr (KIND == KIND_I8) v = __int2float_rn(acc[i]);
      else v = acc[i];
      const float sc = scales != nullptr ? sd[row] : 1.0f;
      const float bi = row0 + row >= n_valid ? neg_inf() : bias != nullptr ? sd[BN + row] : 0.0f;
      return __fadd_rn(__fmul_rn(v, sc), bi);
    };
    // The warpgroup's first group meets empty heaps, where every row would
    // pass: the exact k-th best score of the group's 128 rows, for each
    // query, bounds every later k-th best from below. A bitwise search
    // over the scores' order-preserving bits, counted over the LPQ lanes
    // that hold the query (as unsigned, so that signed order is kept).
    if constexpr (E::LPQ > 0) {
      if (gi == wg && k <= E::LPQ * E::NR) {
#pragma unroll
        for (int u = 0; u < E::NT; ++u) {
          uint32_t key[E::NR];
#pragma unroll
          for (int r = 0; r < E::NR; ++r) {
            const int b = __float_as_int(score(E::elem(r, u), E::row(tl, r)));
            key[r] = (uint32_t)(b < 0 ? b ^ 0x7fffffff : b) ^ 0x80000000u;
          }
          uint32_t kth = 0;
#pragma unroll 1
          for (int bit = 31; bit >= 0; --bit) {
            const uint32_t cand = kth | (1u << bit);
            int n = 0;
#pragma unroll
            for (int r = 0; r < E::NR; ++r) n += key[r] >= cand;
#pragma unroll
            for (int o = 1; o < E::LPQ; o <<= 1) n += __shfl_xor_sync(0xffffffffu, n, o);
            if (n >= k) kth = cand;
          }
          const int ord = (int)(kth ^ 0x80000000u);
          first_kth[u] = __int_as_float(ord < 0 ? ord ^ 0x7fffffff : ord);
          ta[u] = fmaxf(ts[u], first_kth[u]);
        }
      }
    }
    // bit i: element i may pass (its score reaches ta, a superset of the
    // key test), taken branch-free over all elements, a row at a time
    // (32-bit words, two chains a word, so that the ORs do not serialize)
    constexpr int NW = (NA + 31) / 32;
    uint32_t bits[NW][2];
#pragma unroll
    for (int w = 0; w < NW; ++w) bits[w][0] = bits[w][1] = 0;
#pragma unroll
    for (int r = 0; r < E::NR; ++r)
#pragma unroll
      for (int u = 0; u < E::NT; ++u) {
        const int i = E::elem(r, u);
        bits[i >> 5][u & 1] |= (uint32_t)(score(i, E::row(tl, r)) >= ta[u]) << (i & 31);
      }
    uint64_t todo = 0;
#pragma unroll
    for (int w = 0; w < NW; ++w) todo |= (uint64_t)(bits[w][0] | bits[w][1]) << (32 * w);
    // The key test and the append, one marked element at a time: a slot
    // from a shared atomicAdd on the query's count, or, when the buffer is
    // full, the element stays pending. Then the warpgroup's buffers go to
    // the heaps, the thresholds rise, and the pending elements are tested
    // again.
#pragma unroll 1
    for (;;) {
      uint64_t left = 0;
      while (todo != 0) {
        const int i = __ffsll((long long)todo) - 1;
        todo &= todo - 1;
        float v = 0.0f, tsu = 0.0f;
        int row = 0, q = 0, tru = 0;
        switch (i) {
#define TS_ELEM(n)                                   \
  case n:                                            \
    if constexpr (n < NA) {                          \
      row = E::row(tl, E::rslot(n));                 \
      v = score(n, row);                             \
      row += row0;                                   \
      q = E::query(tl, E::qslot(n));                 \
      tsu = ts[E::qslot(n)];                         \
      tru = tr[E::qslot(n)];                         \
    }                                                \
    break;
#define TS_ELEM8(n) TS_ELEM(n) TS_ELEM(n + 1) TS_ELEM(n + 2) TS_ELEM(n + 3) \
    TS_ELEM(n + 4) TS_ELEM(n + 5) TS_ELEM(n + 6) TS_ELEM(n + 7)
          TS_ELEM8(0) TS_ELEM8(8) TS_ELEM8(16) TS_ELEM8(24)
          TS_ELEM8(32) TS_ELEM8(40) TS_ELEM8(48) TS_ELEM8(56)
#undef TS_ELEM8
#undef TS_ELEM
        }
        if (v > tsu || (v == tsu && row < tru)) {
          const int slot = atomicAdd(&cnt[q], 1);
          if (slot < CB) {
            bufs[q * CBS + slot] = v;
            bufr[q * CBS + slot] = row;
          } else {
            left |= 1ull << i;
          }
        }
      }
      if (!bar_or(bar_id, WG_THREADS, left != 0)) break;
      drain();
      bar_sync(bar_id, WG_THREADS);
      load_thresholds();
      todo = left;
    }
    if (tl == 0) mbar_arrive(&sempty[gs]);
  }

  // the candidates still in the buffers, then the tile's heaps into its
  // span's k columns once both warpgroups are done
  drain();
  bar_sync(3, CONSUMERS);
  const size_t width = (size_t)gridDim.y * k;
  for (int i = t; i < nq * k; i += CONSUMERS) {
    const int qi = i / k, j = i - qi * k;
    part[(size_t)(q0 + qi) * width + (size_t)span * k + j] = heaps[qi * hs + j];
  }
}

template <int KIND, int NQ, bool QRES>
int launch(const CUtensorMap& tq, const CUtensorMap& tc, Args a, int n_spans,
           cudaStream_t stream) {
  const size_t smem = layout(NQ, QRES, a.nk, a.k, a.stages).total;
  auto kern = mips_topk_kernel<KIND, NQ, QRES>;
  const cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.B + NQ - 1) / NQ, n_spans);
  kern<<<grid, THREADS, smem, stream>>>(tq, tc, a);
  return (int)cudaGetLastError();
}

// ring stages that fit beside the rest (0 if fewer than `least`)
int fit_stages(int nq, bool qres, int nk, int k, int least) {
  const Layout l1 = layout(nq, qres, nk, k, 1), l0 = layout(nq, qres, nk, k, 0);
  const size_t per = l1.total - l0.total;
  if (l0.total + least * per > SMEM_MAX) return 0;
  return (int)std::min<size_t>(MAX_STAGES, (SMEM_MAX - l0.total) / per);
}

// the query tile resident when enough ring stages fit beside it, else
// streamed with the corpus chunks
template <int KIND, int NQ>
int launch_tile(const CUtensorMap& tq, const CUtensorMap& tc, Args a, int n_spans,
                cudaStream_t stream) {
  a.stages = fit_stages(NQ, true, a.nk, a.k, MIN_RES_STAGES);
  if (a.stages > 0) return launch<KIND, NQ, true>(tq, tc, a, n_spans, stream);
  a.stages = fit_stages(NQ, false, a.nk, a.k, 2);
  if (a.stages == 0) return (int)cudaErrorInvalidValue;
  return launch<KIND, NQ, false>(tq, tc, a, n_spans, stream);
}

template <int KIND>
int launch_kind(const CUtensorMap& tq, const CUtensorMap& tc, const Args& a, int n_spans,
                cudaStream_t stream) {
  return query_tile(a.k) == 64 ? launch_tile<KIND, 64>(tq, tc, a, n_spans, stream)
                               : launch_tile<KIND, 16>(tq, tc, a, n_spans, stream);
}

}  // namespace

// part (B, n_spans * k) int64 keys: span s at columns s k. glist (int32,
// the needed groups first) and gcount (int32, their number) are device
// pointers, both null when every group below n_valid is needed.
extern "C" int ts_mips_topk(const void* q, const void* corpus, const void* scales,
                            const void* bias, const void* glist, const void* gcount, void* part,
                            int kind, int B, int D, int n_pad, int n_valid, int k, int n_spans,
                            void* stream) {
  if (k < 1 || k > KMAX || n_pad % BN || kind < 0 || kind > 2 || B < 1 || n_spans < 1 ||
      n_spans > 65535 || (glist == nullptr) != (gcount == nullptr))
    return (int)cudaErrorInvalidValue;
  const int row_bytes = D * (kind == KIND_I8 ? 1 : kind == KIND_BF16 ? 2 : 4);
  if (row_bytes % 16) return (int)cudaErrorInvalidValue;
  CUtensorMap tq, tc;
  if (!tma_map_i8(&tq, q, B, row_bytes, query_tile(k)) ||
      !tma_map_i8(&tc, corpus, n_pad, row_bytes, BN))
    return (int)cudaErrorInvalidValue;
  Args a;
  a.scales = (const float*)scales;
  a.bias = (const float*)bias;
  a.glist = (const int32_t*)glist;
  a.gcount = (const int32_t*)gcount;
  a.part = (long long*)part;
  a.B = B;
  a.nk = (row_bytes + BK - 1) / BK;
  a.n_valid = std::min(n_valid, n_pad);
  a.k = k;
  a.stages = 0;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (kind) {
    case KIND_I8:
      return launch_kind<KIND_I8>(tq, tc, a, n_spans, st);
    case KIND_BF16:
      return launch_kind<KIND_BF16>(tq, tc, a, n_spans, st);
    default:
      return launch_kind<KIND_F32>(tq, tc, a, n_spans, st);
  }
}
