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
// Design. The TPU version tiles postings (64, 128) per grid step and pads
// its output to (8, 128) tiles; both are Mosaic layout rules and are gone.
//   Pass 1 (`score_topk_tiles`): one block of 256 threads per tile of 4096
//     postings. Each thread scores 16 postings into registers (coalesced
//     loads: thread t reads t, t + 256, ...). Then k rounds of a block
//     argmax: each thread offers its best (value, index), a warp-shuffle
//     reduction and a second one across the 8 warps pick the winner, and
//     the owning thread knocks it out and recomputes its own best. The tile
//     writes k (value, posting index) pairs.
//   Pass 2 (`score_topk_merge`): one block of 1024 threads merges the
//     grid * k pairs by the same rule and writes the final k.
// A lane that is taken, or lies past the end of the list, carries index
// INT_MAX, so it ranks below every real -inf lane; output indices are
// clamped into [0, P) so that dead lanes (value -inf) still gather safely.
// Only winners with a finite value are part of the contract.
//
// What bounds it on an H100: bytes. Pass 1 reads 12 bytes per posting (id,
// tf and the gathered norm) and does ~10 f32 operations on them, far below
// the card's operations-per-byte balance; pass 2 reads grid * k * 8 bytes.
// The k rounds of block-wide reductions are latency, not bandwidth: with
// k = 10 they cost about as much as the loads. A faster design (shared
// staging, a warp-level top-k with fewer rounds) is later work.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (see quickwit_tpu_torch/ops/kernels/build.py).
// Launches on the caller's stream, allocates nothing, returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <math_constants.h>
#include <climits>
#include <cstdint>

namespace {

constexpr int kTileThreads = 256;
constexpr int kItems = 16;
constexpr int kTile = kTileThreads * kItems;  // 4096 postings per block
constexpr int kMergeThreads = 1024;
constexpr int kNone = INT_MAX;

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

__device__ __forceinline__ void warp_best(float& v, int& i) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    float ov = __shfl_down_sync(0xffffffffu, v, off);
    int oi = __shfl_down_sync(0xffffffffu, i, off);
    if (better(ov, oi, v, i)) {
      v = ov;
      i = oi;
    }
  }
}

// Block-wide best of every thread's (v, i); all threads get the result.
// `sv`/`si` hold one slot per warp plus one broadcast slot.
__device__ __forceinline__ void block_best(float v, int i, float* sv, int* si,
                                           float& out_v, int& out_i) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  warp_best(v, i);
  if (lane == 0) {
    sv[warp] = v;
    si[warp] = i;
  }
  __syncthreads();
  if (warp == 0) {
    float wv = lane < nwarps ? sv[lane] : -CUDART_INF_F;
    int wi = lane < nwarps ? si[lane] : kNone;
    warp_best(wv, wi);
    if (lane == 0) {
      sv[32] = wv;
      si[32] = wi;
    }
  }
  __syncthreads();
  out_v = sv[32];
  out_i = si[32];
  __syncthreads();  // slots are reused by the next round
}

__device__ __forceinline__ float bm25(int tf_i, int norm_i, const Scalars& s) {
  const float tf = __int2float_rn(tf_i);
  const float norm = __int2float_rn(norm_i);
  const float inner =
      __fadd_rn(__fdiv_rn(__fmul_rn(s.b, norm), s.avg_clamped), s.one_minus_b);
  const float denom = __fmaf_rn(inner, s.k1, tf);
  return __fdiv_rn(__fmul_rn(tf, s.weight), fmaxf(denom, s.eps));
}

__global__ void __launch_bounds__(kTileThreads)
score_topk_tiles(const int* __restrict__ ids, const int* __restrict__ tfs,
                 const int* __restrict__ norms, int64_t num_postings,
                 int64_t num_norms, int num_docs, Scalars s, int k,
                 float* __restrict__ cand_vals, int* __restrict__ cand_idx) {
  __shared__ float sv[33];
  __shared__ int si[33];
  const int64_t tile_start = static_cast<int64_t>(blockIdx.x) * kTile;
  const int t = threadIdx.x;

  float val[kItems];
  int idx[kItems];
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int64_t p = tile_start + j * kTileThreads + t;
    val[j] = -CUDART_INF_F;
    idx[j] = kNone;
    if (p < num_postings) {
      const int id = ids[p];
      const int tf = tfs[p];
      const int64_t safe = id < 0 ? 0 : (id >= num_norms ? num_norms - 1 : id);
      const float score = bm25(tf, norms[safe], s);
      idx[j] = static_cast<int>(p);
      if (tf > 0 && id < num_docs) val[j] = score;
    }
  }

  // the thread's own best; items are in ascending index order, so strict
  // `better` keeps the lowest index among equal values
  float bv = -CUDART_INF_F;
  int bi = kNone;
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    if (better(val[j], idx[j], bv, bi)) {
      bv = val[j];
      bi = idx[j];
    }
  }

  for (int r = 0; r < k; ++r) {
    float wv;
    int wi;
    block_best(bv, bi, sv, si, wv, wi);
    if (t == 0) {
      cand_vals[static_cast<int64_t>(blockIdx.x) * k + r] = wv;
      cand_idx[static_cast<int64_t>(blockIdx.x) * k + r] = wi;
    }
    if (wi != kNone && wi == bi) {
      // knock the winner out and rescan this thread's items
      bv = -CUDART_INF_F;
      bi = kNone;
#pragma unroll
      for (int j = 0; j < kItems; ++j) {
        if (idx[j] == wi) {
          val[j] = -CUDART_INF_F;
          idx[j] = kNone;
        }
        if (better(val[j], idx[j], bv, bi)) {
          bv = val[j];
          bi = idx[j];
        }
      }
    }
  }
}

__global__ void __launch_bounds__(kMergeThreads)
score_topk_merge(float* __restrict__ cand_vals, int* __restrict__ cand_idx,
                 int64_t num_cands, int64_t num_postings, int k,
                 float* __restrict__ out_vals, int64_t* __restrict__ out_idx) {
  __shared__ float sv[33];
  __shared__ int si[33];
  const int t = threadIdx.x;

  float bv = -CUDART_INF_F;
  int bi = kNone;
  int64_t bpos = -1;
  for (int64_t c = t; c < num_cands; c += kMergeThreads) {
    if (better(cand_vals[c], cand_idx[c], bv, bi)) {
      bv = cand_vals[c];
      bi = cand_idx[c];
      bpos = c;
    }
  }

  for (int r = 0; r < k; ++r) {
    float wv;
    int wi;
    block_best(bv, bi, sv, si, wv, wi);
    if (t == 0) {
      out_vals[r] = wv;
      const int64_t last = num_postings - 1;
      out_idx[r] = (wi == kNone || wi > last) ? last : wi;
    }
    if (wi != kNone && wi == bi) {
      cand_vals[bpos] = -CUDART_INF_F;
      cand_idx[bpos] = kNone;
      bv = -CUDART_INF_F;
      bi = kNone;
      bpos = -1;
      for (int64_t c = t; c < num_cands; c += kMergeThreads) {
        if (better(cand_vals[c], cand_idx[c], bv, bi)) {
          bv = cand_vals[c];
          bi = cand_idx[c];
          bpos = c;
        }
      }
    }
  }
}

}  // namespace

extern "C" {

int qw_score_topk_tile_size() { return kTile; }

// Pass 1: per-tile top-k. cand_vals/cand_idx hold ceil(P / 4096) * k slots.
int qw_score_topk_tiles(const int* ids, const int* tfs, const int* norms,
                        int64_t num_postings, int64_t num_norms, int num_docs,
                        float weight, float avg_clamped, float k1, float b,
                        float one_minus_b, float eps, int k, float* cand_vals,
                        int* cand_idx, void* stream) {
  const Scalars s{weight, avg_clamped, k1, b, one_minus_b, eps};
  const int64_t grid = (num_postings + kTile - 1) / kTile;
  score_topk_tiles<<<static_cast<unsigned>(grid), kTileThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      ids, tfs, norms, num_postings, num_norms, num_docs, s, k, cand_vals,
      cand_idx);
  return static_cast<int>(cudaGetLastError());
}

// Pass 2: merge of the grid * k tile winners into the final k. Consumes
// (overwrites) the candidate buffers.
int qw_score_topk_merge(float* cand_vals, int* cand_idx, int64_t num_cands,
                        int64_t num_postings, int k, float* out_vals,
                        int64_t* out_idx, void* stream) {
  score_topk_merge<<<1, kMergeThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      cand_vals, cand_idx, num_cands, num_postings, k, out_vals, out_idx);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
