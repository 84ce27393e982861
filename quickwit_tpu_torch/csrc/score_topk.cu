// Fused BM25 score + top-k over one term's posting list, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_kernel` / `fused_score_topk` in
// quickwit_tpu/ops/pallas/score_topk.py. It computes the same function:
// for every posting i of a padded posting list,
//
//   valid  = tf[i] > 0 && id[i] < num_docs            (i32 compare, exact)
//   norm   = fieldnorm[clamp(id[i], 0, num_norms - 1)] (gather fused here)
//   inner  = (B * norm) / max(avg_len, 1e-9) + (1 - B)
//   denom  = fma(inner, K1, tf)                       (one rounding)
//   score  = (tf * weight) / max(denom, 1e-9)         weight = idf * (K1 + 1)
//   key    = valid ? score : -inf
//
// and returns the k largest keys, ties broken by the LOWER posting index.
// Every step is rounded as the JAX program rounds it: separate IEEE f32
// multiply/add/divide (`__fmul_rn`, `__fadd_rn`, `__fdiv_rn`, never
// contracted), except `denom`, which XLA's CPU backend contracts into one
// fma, so the kernel uses `__fmaf_rn` there. The host rounds the scalar
// constants (weight, max(avg_len, 1e-9), K1, B, 1 - B, 1e-9) to f32 and
// passes them in.
//
// What bounds it on an H100: bytes, and the latency of a short launch.
// Each posting costs 8 streamed bytes (id, tf) and one 4-byte norm gathered
// at its doc id; ~11 f32 operations on those are far below the card's
// operations-per-byte balance. The gather sets the pace: it moves whole
// 32-byte sectors. The flagship's postings are ~10 docs apart, so it reads
// most of the 40 MB norm column in doc order; body_top10's 6M impact-ordered
// postings hit that column at random, ~5 times per sector, and the column
// does not stay in the 50 MB L2, so most of the 200 MB of sectors come from
// DRAM (PERF.md, "Where the time goes"). At these sizes a launch lasts tens
// of microseconds, so what the TPU design adds on top (k rounds of
// block-wide argmax per tile, a second merge launch) is pure latency. The
// design removes that:
//
// 1. One launch. A persistent grid (blocks per SM from the occupancy API
//    times the SM count, capped at the tile count) walks 1024-posting tiles
//    grid-stride. Each block publishes its k-th best pair (`atomicMax` on an
//    order-preserving 64-bit key) and appends only those of its k winners
//    that are at least as good as the best k-th pair published so far: a
//    block's k-th pair has k pairs at least as good as it, so nothing worse
//    is in the top k, and the last block merges tens of candidates, not
//    grid * k. The last block is found by an arrival ticket: writers fence,
//    one thread takes `atomicInc`, which wraps the ticket back to 0; that
//    block then clears the count and the published pair, so the next call
//    and CUDA-graph replays find the state at 0.
// 2. A warp-level thresholded top-k instead of k block-wide rounds. Each
//    warp keeps its best 32 * NS (value, index) pairs sorted across its
//    lanes in registers (NS = 1 for k <= 32, 2 for k <= 64) and the k-th
//    of them as a threshold. A scored posting is a candidate only if it
//    beats the threshold by the same (value desc, index asc) rule; a warp
//    ballot skips a 32-posting chunk with no candidate, else a bitonic sort
//    of the chunk and a bitonic merge into the list renew the threshold.
//    Warps then merge their lists in shared memory (3 rounds for 8 warps).
//    On impact-ordered or tied postings (every query on the main path)
//    almost every chunk is one compare and one ballot; an adversarial order
//    (scores rising with the index) merges every chunk and stays exact.
// 3. Staged tiles. One thread keeps a 3-stage ring of ids/tfs tiles in
//    flight with 1-D bulk copies (`cp.async.bulk`, completion counted in
//    bytes on an `mbarrier` per stage, marked L2 evict-first because each
//    byte is read once), so the next tiles load while the current one is
//    scored; each thread then gathers its norms (`__ldg`) as soon as the
//    tile lands. Bulk copies need 16-byte-aligned addresses and sizes: a
//    tile's misaligned head (up to 3 postings of a view such as `ids[1:]`)
//    and ragged tail are read element by element from global memory
//    instead, so any 4-byte-aligned input works.
//
// 4. Lanes. A stacked query group (the JAX program's `vmap` over the
//    Pallas call, which gains a grid axis) runs as one launch of
//    `score_topk_lanes_kernel`: a (gx, Q) grid whose row q walks lane q's
//    tiles with the same block body as the solo kernel (which is the Q = 1
//    case), its own grid state and candidate region, and writes row q of
//    the [Q, k] outputs. The lane table (pointers, lengths, the f32
//    constants of each query) is a `__grid_constant__` kernel parameter,
//    so no copy precedes the launch. Lanes may differ in length: a block
//    past its lane's tiles still takes its ticket. A group of small
//    posting lists is where one launch instead of Q matters most.
//
// A past-the-end or invalid posting is never a candidate. List slots that
// no posting filled carry (-inf, INT_MAX); output indices are clamped into
// [0, P) so dead lanes (value -inf) still gather safely. Only winners with
// a finite value are part of the contract.
//
// `nvcc -Xptxas -v` for sm_90a: 48 registers for NS = 1 and 40 for
// NS = 2 (the lane kernel: 40 and 46), 4,224 bytes of static and 25,344 of
// dynamic shared memory, no stack frame, no spills; 5 blocks of 256
// threads fit on an SM (660 on the H100's 132 SMs). chip_smoke.py phase 1
// prints the report of each build.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -Xptxas -v (quickwit_tpu_torch/ops/kernels/
//        build.py). Launches on the caller's stream, allocates nothing,
//        returns a cudaError_t.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <climits>
#include <cstdint>
#include <cstring>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 4;                      // postings per thread per tile
constexpr int kTile = kThreads * kItems;       // 1024 postings per tile
constexpr int kStages = 3;
constexpr int kBufInts = kTile + 32;           // + 3 for a misaligned head,
                                               // rounded to keep 128-B bases
constexpr int kSmemBytes = kStages * 2 * kBufInts * 4;
constexpr int kNone = INT_MAX;
constexpr unsigned kFull = 0xffffffffu;

static_assert((kTile * 4) % 16 == 0, "tiles must keep 16-byte alignment");

// The workspace's first 16 bytes. All three fields are 0 between launches:
// the ticket wraps to 0 on the last arrival, and the last block clears the
// other two once it has read them.
struct GridState {
  unsigned ticket;          // blocks of this launch that have finished
  unsigned count;           // candidates appended so far
  unsigned long long bar;   // best published k-th pair, as an order key
};
static_assert(sizeof(GridState) == 16, "the wrapper reserves 16 bytes");

struct Scalars {
  float weight;       // f32(idf * (K1 + 1))
  float avg_clamped;  // f32(max(avg_len, 1e-9))
  float k1;
  float b;
  float one_minus_b;
  float eps;          // f32(1e-9)
};

// true when (av, ai) ranks before (bv, bi): higher value, then lower index
__device__ __forceinline__ bool better(float av, int ai, float bv, int bi) {
  return av > bv || (av == bv && ai < bi);
}

// A 64-bit key that orders pairs as `better` does: the value's bits made
// monotone (-0 taken as +0), then the complemented index. Every real pair's
// key is above 0.
__device__ __forceinline__ unsigned long long order_key(float v, int i) {
  const unsigned u = __float_as_uint(v == 0.0f ? 0.0f : v);
  const unsigned ord = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return (static_cast<unsigned long long>(ord) << 32) |
         static_cast<unsigned>(~i);
}

__device__ __forceinline__ float bm25(int tf_i, int norm_i, const Scalars& s) {
  const float tf = __int2float_rn(tf_i);
  const float norm = __int2float_rn(norm_i);
  const float inner =
      __fadd_rn(__fdiv_rn(__fmul_rn(s.b, norm), s.avg_clamped), s.one_minus_b);
  const float denom = __fmaf_rn(inner, s.k1, tf);
  return __fdiv_rn(__fmul_rn(tf, s.weight), fmaxf(denom, s.eps));
}

// One compare-exchange step between lanes `lane` and `lane ^ stride`: the
// lane that `keeps_better` ends with the better pair of the two.
__device__ __forceinline__ void exchange(float& v, int& i, int stride,
                                         bool keeps_better) {
  const float ov = __shfl_xor_sync(kFull, v, stride);
  const int oi = __shfl_xor_sync(kFull, i, stride);
  if (keeps_better ? better(ov, oi, v, i) : better(v, i, ov, oi)) {
    v = ov;
    i = oi;
  }
}

// Sorts a bitonic sequence of 32 pairs (one per lane) into descending order.
__device__ __forceinline__ void bitonic_merge32(float& v, int& i, int lane) {
#pragma unroll
  for (int stride = 16; stride > 0; stride >>= 1)
    exchange(v, i, stride, (lane & stride) == 0);
}

// Sorts 32 pairs (one per lane) into descending order.
__device__ __forceinline__ void bitonic_sort32(float& v, int& i, int lane) {
#pragma unroll
  for (int size = 2; size <= 32; size <<= 1) {
    const bool descending = (lane & size) == 0;   // always for size 32
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1)
      exchange(v, i, stride, ((lane & stride) == 0) == descending);
  }
}

// A warp's best 32 * NS pairs, sorted descending: entry e = s * 32 + lane
// lives in slot s of `lane`. thr_* is entry k - 1, the bar a new pair must
// beat to change the top k.
template <int NS>
struct WarpTopK {
  float v[NS];
  int i[NS];
  float thr_v;
  int thr_i;

  __device__ __forceinline__ void clear() {
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      v[s] = -CUDART_INF_F;
      i[s] = kNone;
    }
    thr_v = -CUDART_INF_F;
    thr_i = kNone;
  }

  __device__ __forceinline__ void refresh(int k) {
    const int e = k - 1;
    float tv = v[0];
    int ti = i[0];
    if (NS == 2 && e >= 32) {
      tv = v[NS - 1];
      ti = i[NS - 1];
    }
    thr_v = __shfl_sync(kFull, tv, e & 31);
    thr_i = __shfl_sync(kFull, ti, e & 31);
  }

  // Merges 32 pairs already sorted descending across the lanes; the list
  // becomes the best 32 * NS of both. Reversing the chunk against the last
  // slot gives a bitonic sequence holding those, which bitonic merges sort.
  __device__ __forceinline__ void merge_sorted(float cv, int ci, int lane,
                                               int k) {
    const float rv = __shfl_sync(kFull, cv, 31 - lane);
    const int ri = __shfl_sync(kFull, ci, 31 - lane);
    if (better(rv, ri, v[NS - 1], i[NS - 1])) {
      v[NS - 1] = rv;
      i[NS - 1] = ri;
    }
    if (NS == 2 && better(v[NS - 1], i[NS - 1], v[0], i[0])) {
      const float tv = v[0];
      const int ti = i[0];
      v[0] = v[NS - 1];
      i[0] = i[NS - 1];
      v[NS - 1] = tv;
      i[NS - 1] = ti;
    }
#pragma unroll
    for (int s = 0; s < NS; ++s) bitonic_merge32(v[s], i[s], lane);
    refresh(k);
  }

  // Offers one pair per lane; `take` marks the lanes that beat the
  // threshold. Warp-uniform: every lane calls it.
  __device__ __forceinline__ void offer(float cv, int ci, bool take, int lane,
                                        int k) {
    if (__ballot_sync(kFull, take) == 0) return;
    if (!take) {
      cv = -CUDART_INF_F;
      ci = kNone;
    }
    bitonic_sort32(cv, ci, lane);
    merge_sorted(cv, ci, lane, k);
  }

  // Tree merge of the block's warp lists through shared memory; warp 0
  // ends with the block's best. Every thread of the block calls it.
  __device__ __forceinline__ void block_merge(float (*sv)[64], int (*si)[64],
                                              int warp, int lane, int k) {
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      sv[warp][s * 32 + lane] = v[s];
      si[warp][s * 32 + lane] = i[s];
    }
    __syncthreads();
#pragma unroll
    for (int r = 1; r < kWarps; r <<= 1) {
      if ((warp & (2 * r - 1)) == 0 && warp + r < kWarps) {
#pragma unroll
        for (int s = 0; s < NS; ++s) {
          const float ov = sv[warp + r][s * 32 + lane];
          const int oi = si[warp + r][s * 32 + lane];
          // the partner's slots are sorted: once one has nothing that
          // beats the threshold, the next has nothing either
          if (__ballot_sync(kFull, better(ov, oi, thr_v, thr_i)) == 0) break;
          merge_sorted(ov, oi, lane, k);
        }
#pragma unroll
        for (int s = 0; s < NS; ++s) {
          sv[warp][s * 32 + lane] = v[s];
          si[warp][s * 32 + lane] = i[s];
        }
      }
      __syncthreads();
    }
  }
};

// ---- bulk copies and mbarriers (PTX) ---------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile(
      "{\n .reg .b64 state;\n"
      " mbarrier.arrive.shared::cta.b64 state, [%0];\n}\n" ::"r"(
          smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// A bulk copy marked evict-first in L2: each staged posting is read once,
// so it should not push the gathered norm column out of L2.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n"
               : "=l"(policy));
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".L2::cache_hint [%0], [%1], %2, [%3], %4;\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar)), "l"(policy)
      : "memory");
}

// Elements of `g` between the last 16-byte boundary and g itself (0..3).
// A tile is 8 KB, so the value is the same for every tile of one array.
__device__ __forceinline__ int misalign(const int* g) {
  return static_cast<int>((reinterpret_cast<uintptr_t>(g) & 15) >> 2);
}

// The postings [a0, a1) of tile [p0, p1) that a bulk copy can move: from
// the first 16-byte boundary, a multiple of 4 postings. Posting p of the
// tile is staged at buffer slot p - p0 + misalign(g), which keeps the
// buffer's alignment equal to global memory's.
__device__ __forceinline__ void bulk_span(const int* g, int p0, int p1,
                                          int& a0, int& a1) {
  a0 = min(p0 + ((4 - misalign(g + p0)) & 3), p1);
  a1 = a0 + ((p1 - a0) & ~3);
}

// End of the tile that starts at p0 (no int overflow near 2^31).
__device__ __forceinline__ int tile_end(int p0, int num_postings) {
  return num_postings - p0 <= kTile ? num_postings : p0 + kTile;
}

// One block's share of a top-k over one posting list: block `bx` of the
// `gx` blocks that serve this list walks its tiles grid-stride, and the
// last of them to arrive merges. Both kernels below run it: the solo kernel
// with its grid, the lane kernel once per lane (grid row blockIdx.y).
template <int NS>
__device__ __forceinline__ void score_topk_block(
    const int* __restrict__ ids, const int* __restrict__ tfs,
    const int* __restrict__ norms, int num_postings, int64_t num_norms,
    int num_docs, const Scalars& s, int k, float* cand_v, int* cand_i,
    GridState* state, float* __restrict__ out_vals,
    int64_t* __restrict__ out_idx, unsigned bx, unsigned gx) {
  extern __shared__ __align__(128) int stage_buf[];   // [stage][ids|tfs]
  __shared__ __align__(8) uint64_t full[kStages];
  __shared__ float merge_v[kWarps][64];
  __shared__ int merge_i[kWarps][64];
  __shared__ int is_last;

  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int64_t num_tiles =
      (static_cast<int64_t>(num_postings) + kTile - 1) / kTile;
  const int ids_shift = misalign(ids);
  const int tfs_shift = misalign(tfs);

  // one thread stages tile `tile` into ring slot `stage`
  auto load_tile = [&](int64_t tile, int stage) {
    const int p0 = static_cast<int>(tile * kTile);
    const int p1 = tile_end(p0, num_postings);
    int ia0, ia1, ta0, ta1;
    bulk_span(ids, p0, p1, ia0, ia1);
    bulk_span(tfs, p0, p1, ta0, ta1);
    const uint32_t bytes = 4u * static_cast<uint32_t>((ia1 - ia0) +
                                                      (ta1 - ta0));
    uint64_t* bar = &full[stage];
    if (bytes == 0) {
      mbar_arrive(bar);
      return;
    }
    mbar_expect_tx(bar, bytes);
    int* buf = stage_buf + stage * 2 * kBufInts;
    if (ia1 > ia0)
      bulk_load(buf + (ia0 - p0) + ids_shift, ids + ia0, 4u * (ia1 - ia0),
                bar);
    if (ta1 > ta0)
      bulk_load(buf + kBufInts + (ta0 - p0) + tfs_shift, tfs + ta0,
                4u * (ta1 - ta0), bar);
  };

  if (t == 0) {
#pragma unroll
    for (int st = 0; st < kStages; ++st) mbar_init(&full[st], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (t == 0) {
    for (int n = 0; n < kStages; ++n) {
      const int64_t tile = bx + static_cast<int64_t>(n) * gx;
      if (tile < num_tiles) load_tile(tile, n);
    }
  }

  WarpTopK<NS> top;
  top.clear();
  for (int n = 0;; ++n) {
    const int64_t tile = bx + static_cast<int64_t>(n) * gx;
    if (tile >= num_tiles) break;
    const int stage = n % kStages;
    const int p0 = static_cast<int>(tile * kTile);
    const int p1 = tile_end(p0, num_postings);
    int ia0, ia1, ta0, ta1;
    bulk_span(ids, p0, p1, ia0, ia1);
    bulk_span(tfs, p0, p1, ta0, ta1);
    const int* sid = stage_buf + stage * 2 * kBufInts + ids_shift;
    const int* stf = stage_buf + stage * 2 * kBufInts + kBufInts + tfs_shift;
    mbar_wait(&full[stage], (n / kStages) & 1);

    int id[kItems], tf[kItems], norm[kItems];
    bool ok[kItems];
#pragma unroll
    for (int u = 0; u < kItems; ++u) {
      const int p = p0 + u * kThreads + t;
      id[u] = 0;
      tf[u] = 0;
      if (p < p1) {
        id[u] = (p >= ia0 && p < ia1) ? sid[p - p0] : __ldg(ids + p);
        tf[u] = (p >= ta0 && p < ta1) ? stf[p - p0] : __ldg(tfs + p);
      }
      ok[u] = p < p1 && tf[u] > 0 && id[u] < num_docs;
      const int64_t safe =
          id[u] < 0 ? 0 : (id[u] >= num_norms ? num_norms - 1 : id[u]);
      norm[u] = ok[u] ? __ldg(norms + safe) : 0;
    }
#pragma unroll
    for (int u = 0; u < kItems; ++u) {
      const int p = p0 + u * kThreads + t;
      const float score = ok[u] ? bm25(tf[u], norm[u], s) : -CUDART_INF_F;
      top.offer(score, p, ok[u] && better(score, p, top.thr_v, top.thr_i),
                lane, k);
    }

    __syncthreads();   // every thread is done with this stage
    if (t == 0 && tile + static_cast<int64_t>(kStages) * gx < num_tiles)
      load_tile(tile + static_cast<int64_t>(kStages) * gx, stage);
  }

  top.block_merge(merge_v, merge_i, warp, lane, k);
  if (warp == 0) {
    // Publish this block's k-th pair, and append only the candidates at
    // least as good as the best k-th pair published so far: that pair has
    // k pairs at least as good as it, so nothing worse is in the top k.
    unsigned long long bar = 0;
    if (lane == 0) {
      const unsigned long long mine =
          top.thr_i == kNone ? 0ull : order_key(top.thr_v, top.thr_i);
      bar = max(atomicMax(&state->bar, mine), mine);
    }
    bar = __shfl_sync(kFull, bar, 0);
    bool keep[NS];
    int slot_of[NS];
    int total = 0;
#pragma unroll
    for (int sl = 0; sl < NS; ++sl) {
      keep[sl] = sl * 32 + lane < k && top.i[sl] != kNone &&
                 order_key(top.v[sl], top.i[sl]) >= bar;
      const unsigned kept = __ballot_sync(kFull, keep[sl]);
      slot_of[sl] = total + __popc(kept & ((1u << lane) - 1));
      total += __popc(kept);
    }
    int first = 0;
    if (lane == 0 && total > 0) first = atomicAdd(&state->count, total);
    first = __shfl_sync(kFull, first, 0);
#pragma unroll
    for (int sl = 0; sl < NS; ++sl) {
      if (keep[sl]) {
        cand_v[first + slot_of[sl]] = top.v[sl];
        cand_i[first + slot_of[sl]] = top.i[sl];
      }
    }
    __threadfence();   // release this block's candidates before its ticket
  }
  __syncthreads();
  if (t == 0) {
    // wraps to 0 on the last arrival, so the next launch finds it reset
    is_last = atomicInc(&state->ticket, gx - 1) == gx - 1;
    if (is_last) __threadfence();   // acquire every block's candidates
  }
  __syncthreads();
  if (!is_last) return;

  // the last block: merge the appended candidates (read from L2, never
  // from a possibly stale L1 line)
  top.clear();
  const int num_cands = static_cast<int>(__ldcg(&state->count));
  constexpr int kUnroll = 4;
  for (int base = warp * 32 * kUnroll; base < num_cands;
       base += kWarps * 32 * kUnroll) {
    float cv[kUnroll];
    int ci[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int c = base + u * 32 + lane;
      cv[u] = c < num_cands ? __ldcg(cand_v + c) : -CUDART_INF_F;
      ci[u] = c < num_cands ? __ldcg(cand_i + c) : kNone;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      top.offer(cv[u], ci[u], better(cv[u], ci[u], top.thr_v, top.thr_i),
                lane, k);
  }
  top.block_merge(merge_v, merge_i, warp, lane, k);
  if (warp == 0) {
    const int64_t last = num_postings - 1;
#pragma unroll
    for (int sl = 0; sl < NS; ++sl) {
      const int e = sl * 32 + lane;
      if (e < k) {
        out_vals[e] = top.v[sl];
        const int wi = top.i[sl];
        out_idx[e] = (wi == kNone || wi > last) ? last : wi;
      }
    }
  }
  if (t == 0) {   // every thread has read the count (block_merge synced)
    state->count = 0;
    state->bar = 0;
  }
}

template <int NS>
__global__ void __launch_bounds__(kThreads)
score_topk_kernel(const int* __restrict__ ids, const int* __restrict__ tfs,
                  const int* __restrict__ norms, int num_postings,
                  int64_t num_norms, int num_docs, Scalars s, int k,
                  float* cand_v, int* cand_i, GridState* state,
                  float* __restrict__ out_vals, int64_t* __restrict__ out_idx) {
  score_topk_block<NS>(ids, tfs, norms, num_postings, num_norms, num_docs, s,
                       k, cand_v, cand_i, state, out_vals, out_idx,
                       blockIdx.x, gridDim.x);
}

// One posting list of a lane launch: its arrays, its lengths and the f32
// constants of its query. The wrapper's ctypes mirror has this layout.
struct Lane {
  const int* ids;
  const int* tfs;
  const int* norms;
  int64_t num_norms;
  int num_postings;
  int num_docs;
  Scalars s;
};
static_assert(sizeof(Lane) == 64, "the wrapper's ctypes mirror is 64 bytes");

constexpr int kMaxLanes = 16;

// The whole table rides in the kernel's parameter space (1 KB of the 4 KB
// a launch may pass): no host-to-device copy precedes a launch, and a CUDA
// graph captures the table with the launch.
struct LaneTable {
  Lane lane[kMaxLanes];
};

// Q top-k's in one launch: grid row blockIdx.y serves lane q with its own
// grid state and candidate region, and writes row q of the outputs.
template <int NS>
__global__ void __launch_bounds__(kThreads)
score_topk_lanes_kernel(const __grid_constant__ LaneTable table, int k,
                        float* cands, GridState* states,
                        float* __restrict__ out_vals,
                        int64_t* __restrict__ out_idx) {
  const int q = blockIdx.y;
  const Lane& lane = table.lane[q];
  const int64_t per_lane = static_cast<int64_t>(gridDim.x) * k;
  float* cand_v = cands + 2 * per_lane * q;
  int* cand_i = reinterpret_cast<int*>(cand_v + per_lane);
  const int64_t row = static_cast<int64_t>(q) * k;
  score_topk_block<NS>(lane.ids, lane.tfs, lane.norms, lane.num_postings,
                       lane.num_norms, lane.num_docs, lane.s, k, cand_v,
                       cand_i, states + q, out_vals + row, out_idx + row,
                       blockIdx.x, gridDim.x);
}

template <typename Kernel>
cudaError_t query_grid_limit(Kernel kernel, int* out) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmemBytes);
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, kSmemBytes);
  if (err != cudaSuccess) return err;
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  *out = per_sm * sms;
  return per_sm > 0 ? cudaSuccess : cudaErrorInvalidConfiguration;
}

}  // namespace

extern "C" {

// Blocks of the persistent grid for top-k of size k on the current device:
// resident blocks per SM times the SM count. Also raises the kernel's
// dynamic shared memory limit on this device, so call it once per device
// before the first launch there.
int qw_score_topk_grid_limit(int k, int* out) {
  return static_cast<int>(k <= 32 ? query_grid_limit(score_topk_kernel<1>, out)
                                   : query_grid_limit(score_topk_kernel<2>,
                                                      out));
}

// Top-k over postings [0, num_postings). `workspace` holds the 16-byte
// GridState (zeroed once, before the first launch) and then
// 2 * grid_limit * k candidate words; it belongs to `stream` alone.
int qw_score_topk(const int* ids, const int* tfs, const int* norms,
                  int num_postings, int64_t num_norms, int num_docs,
                  float weight, float avg_clamped, float k1, float b,
                  float one_minus_b, float eps, int k, int grid_limit,
                  void* workspace, float* out_vals, int64_t* out_idx,
                  void* stream) {
  const Scalars s{weight, avg_clamped, k1, b, one_minus_b, eps};
  const int64_t tiles = (static_cast<int64_t>(num_postings) + kTile - 1) /
                        kTile;
  const int grid = static_cast<int>(tiles < grid_limit ? tiles : grid_limit);
  GridState* state = static_cast<GridState*>(workspace);
  float* cand_v = reinterpret_cast<float*>(state + 1);
  int* cand_i = reinterpret_cast<int*>(cand_v + static_cast<int64_t>(grid) * k);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (k <= 32)
    score_topk_kernel<1><<<grid, kThreads, kSmemBytes, st>>>(
        ids, tfs, norms, num_postings, num_norms, num_docs, s, k, cand_v,
        cand_i, state, out_vals, out_idx);
  else
    score_topk_kernel<2><<<grid, kThreads, kSmemBytes, st>>>(
        ids, tfs, norms, num_postings, num_norms, num_docs, s, k, cand_v,
        cand_i, state, out_vals, out_idx);
  return static_cast<int>(cudaGetLastError());
}

// The lane kernel's grid limit, as qw_score_topk_grid_limit's (it raises
// this kernel's shared memory limit too).
int qw_score_topk_lanes_grid_limit(int k, int* out) {
  return static_cast<int>(
      k <= 32 ? query_grid_limit(score_topk_lanes_kernel<1>, out)
              : query_grid_limit(score_topk_lanes_kernel<2>, out));
}

// Top-k over each of `num_lanes` (1..16) posting lists in one launch.
// `lanes` points at num_lanes host `Lane` records; the kernel gets them by
// value. Each lane gets grid_limit / num_lanes blocks (at least 1, at most
// its longest lane's tile count). `workspace` holds 16 GridStates (zeroed
// once, before the first launch) and then 2 * grid_limit * k candidate
// words; it belongs to `stream` alone. Row q of out_vals / out_idx
// ([num_lanes, k]) is lane q's top-k.
int qw_score_topk_lanes(const void* lanes, int num_lanes, int k,
                        int grid_limit, void* workspace, float* out_vals,
                        int64_t* out_idx, void* stream) {
  if (num_lanes < 1 || num_lanes > kMaxLanes || grid_limit < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  LaneTable table;
  memset(&table, 0, sizeof(table));
  memcpy(table.lane, lanes, sizeof(Lane) * num_lanes);
  int64_t tiles = 1;
  for (int q = 0; q < num_lanes; ++q) {
    const int64_t lane_tiles =
        (static_cast<int64_t>(table.lane[q].num_postings) + kTile - 1) / kTile;
    if (lane_tiles > tiles) tiles = lane_tiles;
  }
  int64_t gx = grid_limit / num_lanes;
  if (gx < 1) gx = 1;
  if (gx > tiles) gx = tiles;
  GridState* states = static_cast<GridState*>(workspace);
  float* cands = reinterpret_cast<float*>(states + kMaxLanes);
  const dim3 grid(static_cast<unsigned>(gx), static_cast<unsigned>(num_lanes));
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (k <= 32)
    score_topk_lanes_kernel<1><<<grid, kThreads, kSmemBytes, st>>>(
        table, k, cands, states, out_vals, out_idx);
  else
    score_topk_lanes_kernel<2><<<grid, kThreads, kSmemBytes, st>>>(
        table, k, cands, states, out_vals, out_idx);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
