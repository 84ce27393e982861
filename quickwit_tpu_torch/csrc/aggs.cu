// One split's bucket aggregation in one pass over its packed columns, for
// Hopper (sm_90a).
//
// Replaces no TPU kernel. The JAX package leaves these reductions to XLA,
// which fuses a bucket index, its compares and its reductions into a few
// passes over the columns. PyTorch runs them eagerly, op by op: dtype
// copies of each column, a FOR rebase, a [rows, buckets] compare chunk per
// metric and its reductions, and an `index_add_` whose dropped docs all land
// on one sentinel address. This kernel computes the same aggregation state
// in one launch instead.
//
// What it computes, for the docs d whose mask byte is set:
//
//   bucket b   terms:           the i32 ordinal, kept when 0 <= b < nb
//              date_histogram:  floor((v - origin) / interval), truncated to
//                               i32 and kept when 0 <= b < nb and the
//                               column is present at d (i32 arithmetic over
//                               an i32 column, i64 over an i64 or rebased
//                               one, as torch computes it)
//              none:            0 (a top-level metric, nb = 1)
//   counts[b]  += 1
//   and where the metric column is present at d, with v its value,
//   count[b]   += 1      sum[b] += v      sum_sq[b] += v * v
//   min[b], max[b]       over v
//   sketch[b][pctl(v)]   += 1   (DDSketch: ceil(log(max(v, 1e-300)) /
//                               ln_gamma), IEEE division, the i32 wrap and
//                               the clamp of ops/aggs.py's `_pctl_bucket`)
//
// A value is `lane * scale + min` in wrapping 64-bit arithmetic where the
// column is FOR-packed, else the lane itself: no widened, rebased or f64
// copy of a column is ever written to device memory.
//
// Determinism: integer arithmetic only. Counts are u32, sums u64 (two's
// complement), minima and maxima an order-preserving u64 key under
// `atomicMax`. Integer add and max give the same bits in any order, so the
// state repeats run to run. The caller routes a column here only when
// max|v| * docs < 2^53 (and max|v|^2 * docs where it asks for sum_sq), so
// every integer sum equals the f64 sum the torch path takes, bit for bit,
// and each value converts to f64 exactly.
//
// What bounds it on an H100: not bytes. A 524,288-doc split reads at most
// ~5 MB (a 1-byte mask, 4-byte buckets, 2-byte lanes, 1-byte presences),
// 1.5 us at 3.35 TB/s; the launch, the memory latency of a short grid and
// the atomics on hot buckets set the time (17-36 us a call by graph replay
// at the otel dashboard's shapes, PERF.md). The design keeps those off the
// device's critical path:
//
// 1. One launch, no second pass. Blocks privatise the state in shared
//    memory (the small per-bucket state up to kSmemAccBuckets buckets, the
//    sketch up to kMaxSmemBytes) and flush the non-zero entries with
//    integer atomics; the last block to arrive (an arrival ticket in the
//    zeroed workspace) converts the state into the output tensors: i64 or
//    f64 counts, f64 sums, f64 minima and maxima with +-inf for an empty
//    bucket.
// 2. The whole split in flight at once: a grid of 512-thread blocks whose
//    threads take two docs each (as many blocks as shared memory lets the
//    SMs hold), and a doc's column loads issued together once its mask
//    byte is read, so an iteration waits on memory twice.
// 3. A masked-out or out-of-range doc does no work and no atomic, and a
//    warp whose 32 docs are all masked out loads no column.
// 4. A warp whose docs share one bucket (a time-sorted date_histogram, a
//    top-level metric) reduces its counts, sums and extrema with shuffles
//    and makes one atomic per quantity; sketch increments to one bin
//    combine within a warp (`__match_any_sync`).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kItemsPerThread = 2;       // docs a thread takes, at least
constexpr int kSmemAccBuckets = 1024;    // privatised per-bucket state
constexpr int kMaxSmemBytes = 200 * 1024;
constexpr int kPctlBuckets = 2602;       // ops/aggs.py PCTL_NUM_BUCKETS
constexpr int64_t kPctlKMin = -1100;     // ops/aggs.py PCTL_K_MIN
constexpr double kF64Tiny = 2.2250738585072014e-308;   // smallest normal
constexpr unsigned kFull = 0xffffffffu;
using u64 = unsigned long long;   // the 64-bit atomics' and shuffles' type
constexpr u64 kSign = 1ull << 63;

enum Dtype { kU8 = 0, kU16 = 1, kU32 = 2, kU64 = 3, kI8 = 4, kI16 = 5,
             kI32 = 6, kI64 = 7 };
enum Kind { kNone = 0, kTerms = 1, kDateHistogram = 2 };
enum Need { kCounts = 1, kCount = 2, kSum = 4, kSumSq = 8, kMin = 16,
            kMax = 32, kSketch = 64 };
// the state's arrays, in workspace and shared-memory order: 64-bit first
enum Slot { kSlotSum = 0, kSlotSumSq, kSlotMin, kSlotMax, kSlotCounts,
            kSlotCount, kSlotSketch, kSlots };

struct Column {
  const void* lanes;
  const uint8_t* present;   // nullptr: present at every doc
  int64_t scale;            // v = lane * scale + min where rebase != 0
  int64_t min;
  int32_t dtype;
  int32_t rebase;
};

struct Args {
  const uint8_t* mask;
  int64_t n;
  Column bucket;
  Column metric;
  int64_t origin;
  int64_t interval;
  double ln_gamma;
  int32_t kind;
  int32_t narrow;           // date_histogram in i32 arithmetic
  int32_t nb;
  int32_t needs;
  int32_t has_metric;
  int32_t count_f64;        // count written as f64 (the stats state)
  uint32_t* acc;            // zeroed: the arrival ticket, then the state
  int64_t offset[kSlots];   // each slot's u32 word in `acc`, -1: not kept
  int32_t* out_counts;
  void* out_count;          // int64 or double
  double* out_sum;
  double* out_sum_sq;
  double* out_min;
  double* out_max;
};

__host__ __device__ inline bool wide_slot(int slot) {
  return slot < kSlotCounts;
}

__host__ __device__ inline int64_t slot_entries(int slot, int nb) {
  return slot == kSlotSketch ? static_cast<int64_t>(nb) * kPctlBuckets : nb;
}

__host__ __device__ inline bool slot_needed(int slot, int needs) {
  const int bit[kSlots] = {kSum, kSumSq, kMin, kMax, kCounts, kCount,
                           kSketch};
  return (needs & bit[slot]) != 0;
}

__host__ __device__ inline bool slot_in_smem(int slot, bool smem_acc,
                                             bool smem_sketch) {
  return slot == kSlotSketch ? smem_sketch : smem_acc;
}

// Byte offsets of the privatised slots in shared memory (-1: in global
// memory or not kept); returns the bytes.
__host__ __device__ inline int64_t smem_layout(int needs, int nb,
                                               bool smem_acc,
                                               bool smem_sketch,
                                               int64_t* at) {
  int64_t bytes = 0;
  for (int slot = 0; slot < kSlots; ++slot) {
    at[slot] = -1;
    if (!slot_needed(slot, needs) || !slot_in_smem(slot, smem_acc,
                                                   smem_sketch))
      continue;
    at[slot] = bytes;
    bytes += slot_entries(slot, nb) * (wide_slot(slot) ? 8 : 4);
  }
  return bytes;
}

__device__ __forceinline__ int64_t load_lane(const void* p, int dtype,
                                             int64_t i) {
  switch (dtype) {
    case kU8: return static_cast<const uint8_t*>(p)[i];
    case kU16: return static_cast<const uint16_t*>(p)[i];
    case kU32: return static_cast<const uint32_t*>(p)[i];
    case kU64:
      return static_cast<int64_t>(static_cast<const uint64_t*>(p)[i]);
    case kI8: return static_cast<const int8_t*>(p)[i];
    case kI16: return static_cast<const int16_t*>(p)[i];
    case kI32: return static_cast<const int32_t*>(p)[i];
    default: return static_cast<const int64_t*>(p)[i];
  }
}

__device__ __forceinline__ int64_t value_at(const Column& c, int64_t i) {
  const int64_t lane = load_lane(c.lanes, c.dtype, i);
  if (!c.rebase) return lane;
  return static_cast<int64_t>(static_cast<u64>(lane) *
                                  static_cast<u64>(c.scale) +
                              static_cast<u64>(c.min));
}

template <typename T>
__device__ __forceinline__ T floor_div(T a, T b) {
  // c10::div_floor_integer, as torch.div(..., rounding_mode="floor")
  const T q = a / b;
  const T r = a % b;
  return (r != 0 && ((a < 0) != (b < 0))) ? q - 1 : q;
}

// The DDSketch bucket of ops/aggs.py's `_pctl_bucket` for an integer value
// that converts to f64 exactly.
__device__ __forceinline__ int pctl_bucket(int64_t v, double ln_gamma) {
  const double x = static_cast<double>(v);
  if (!(x >= kF64Tiny)) return 0;
  double k = ceil(log(fmax(x, 1e-300)) / ln_gamma);
  k = fmin(fmax(k, -2147483648.0), 2147483647.0);
  int64_t idx = static_cast<int64_t>(k) - kPctlKMin + 1;
  idx = ((idx + (1ll << 31)) & 0xffffffffll) - (1ll << 31);   // i32 wrap
  idx = idx < 1 ? 1 : (idx > kPctlBuckets - 1 ? kPctlBuckets - 1 : idx);
  return static_cast<int>(idx);
}

__device__ __forceinline__ u64 order_key(int64_t v) {
  return static_cast<u64>(v) ^ kSign;   // 0 is never a key: |v| < 2^53
}

__device__ __forceinline__ double from_order_key(u64 key) {
  return static_cast<double>(static_cast<int64_t>(key ^ kSign));
}

__device__ __forceinline__ u64 warp_sum(u64 x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

__device__ __forceinline__ u64 warp_max(u64 x) {
  for (int o = 16; o > 0; o >>= 1) {
    const u64 y = __shfl_xor_sync(kFull, x, o);
    x = y > x ? y : x;
  }
  return x;
}

__global__ void __launch_bounds__(kThreads)
bucket_aggs_kernel(const Args a, int smem_acc, int smem_sketch) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int last_block;
  const int nb = a.nb;
  const int needs = a.needs;

  // each slot's target: its shared-memory copy, else the workspace
  int64_t at[kSlots];
  smem_layout(needs, nb, smem_acc, smem_sketch, at);
  void* target[kSlots];
#pragma unroll
  for (int slot = 0; slot < kSlots; ++slot) {
    target[slot] = at[slot] >= 0
        ? static_cast<void*>(smem + at[slot])
        : (a.offset[slot] >= 0 ? static_cast<void*>(a.acc + a.offset[slot])
                               : nullptr);
    if (at[slot] >= 0) {
      const int64_t words = slot_entries(slot, nb) *
                            (wide_slot(slot) ? 2 : 1);
      uint32_t* s = reinterpret_cast<uint32_t*>(smem + at[slot]);
      for (int64_t i = threadIdx.x; i < words; i += kThreads) s[i] = 0;
    }
  }
  u64* t_sum = static_cast<u64*>(target[kSlotSum]);
  u64* t_sum_sq = static_cast<u64*>(target[kSlotSumSq]);
  u64* t_min = static_cast<u64*>(target[kSlotMin]);
  u64* t_max = static_cast<u64*>(target[kSlotMax]);
  uint32_t* t_counts = static_cast<uint32_t*>(target[kSlotCounts]);
  uint32_t* t_count = static_cast<uint32_t*>(target[kSlotCount]);
  uint32_t* t_sketch = static_cast<uint32_t*>(target[kSlotSketch]);
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  // warps stay converged: each walks whole 32-doc words
  for (int64_t base = static_cast<int64_t>(blockIdx.x) * kThreads +
                      (threadIdx.x & ~31);
       base < a.n; base += stride) {
    const int64_t d = base + lane;
    const bool selected = d < a.n && a.mask[d] != 0;
    if (!__any_sync(kFull, selected)) continue;   // warp-uniform
    // the selected docs' lanes, each load independent of the others, so
    // that they are in flight together
    int32_t raw_b = 0;
    int64_t bucket_v = 0, v = 0;
    bool bucket_present = true, has_v = false;
    if (selected) {
      if (a.kind == kTerms || (a.kind == kDateHistogram && a.narrow))
        raw_b = static_cast<const int32_t*>(a.bucket.lanes)[d];
      else if (a.kind == kDateHistogram)
        bucket_v = value_at(a.bucket, d);
      if (a.bucket.present != nullptr)
        bucket_present = a.bucket.present[d] != 0;
      if (a.has_metric) {
        has_v = a.metric.present == nullptr || a.metric.present[d] != 0;
        v = value_at(a.metric, d);
      }
    }
    bool in = selected;
    int b = 0;
    if (a.kind == kTerms) {
      b = raw_b;
      in = in && b >= 0 && b < nb;
    } else if (a.kind == kDateHistogram) {
      if (a.narrow) {
        const int32_t x = static_cast<int32_t>(
            static_cast<uint32_t>(raw_b) - static_cast<uint32_t>(a.origin));
        b = floor_div<int32_t>(x, static_cast<int32_t>(a.interval));
      } else {
        const int64_t x = static_cast<int64_t>(
            static_cast<u64>(bucket_v) - static_cast<u64>(a.origin));
        b = static_cast<int32_t>(floor_div<int64_t>(x, a.interval));
      }
      in = in && bucket_present && b >= 0 && b < nb;
    }
    has_v = has_v && in;
    const unsigned in_warp = __ballot_sync(kFull, in);
    if (in_warp == 0) continue;   // warp-uniform
    const int b0 = __shfl_sync(kFull, b, __ffs(in_warp) - 1);
    if (__all_sync(kFull, !in || b == b0)) {
      // one bucket for the whole warp: reduce, then one atomic each
      const unsigned v_warp = __ballot_sync(kFull, has_v);
      const u64 s = (needs & kSum) ? warp_sum(has_v ? v : 0) : 0;
      const u64 s2 = (needs & kSumSq)
          ? warp_sum(has_v ? static_cast<u64>(v) * v : 0) : 0;
      const u64 hi = (needs & kMax)
          ? warp_max(has_v ? order_key(v) : 0) : 0;
      const u64 lo = (needs & kMin)
          ? warp_max(has_v ? ~order_key(v) : 0) : 0;
      if (lane == 0) {
        if (needs & kCounts)
          atomicAdd(t_counts + b0, static_cast<unsigned>(__popc(in_warp)));
        if (v_warp != 0) {
          if (needs & kCount)
            atomicAdd(t_count + b0, static_cast<unsigned>(__popc(v_warp)));
          if (needs & kSum) atomicAdd(t_sum + b0, s);
          if (needs & kSumSq) atomicAdd(t_sum_sq + b0, s2);
          if (needs & kMax) atomicMax(t_max + b0, hi);
          if (needs & kMin) atomicMax(t_min + b0, lo);
        }
      }
    } else if (in) {
      if (needs & kCounts) atomicAdd(t_counts + b, 1u);
      if (has_v) {
        if (needs & kCount) atomicAdd(t_count + b, 1u);
        if (needs & kSum) atomicAdd(t_sum + b, static_cast<u64>(v));
        if (needs & kSumSq) atomicAdd(t_sum_sq + b, static_cast<u64>(v) * v);
        if (needs & kMax) atomicMax(t_max + b, order_key(v));
        if (needs & kMin) atomicMax(t_min + b, ~order_key(v));
      }
    }
    if (needs & kSketch) {
      const unsigned v_warp = __ballot_sync(kFull, has_v);
      if (has_v) {
        const int key = b * kPctlBuckets + pctl_bucket(v, a.ln_gamma);
        const unsigned peers = __match_any_sync(v_warp, key);
        if (lane == __ffs(peers) - 1)
          atomicAdd(t_sketch + key, static_cast<unsigned>(__popc(peers)));
      }
    }
  }

  // flush the privatised state: its non-zero entries, by integer atomics
  __syncthreads();
#pragma unroll
  for (int slot = 0; slot < kSlots; ++slot) {
    if (at[slot] < 0) continue;
    const int64_t entries = slot_entries(slot, nb);
    if (wide_slot(slot)) {
      const u64* s = static_cast<const u64*>(target[slot]);
      u64* g = reinterpret_cast<u64*>(a.acc + a.offset[slot]);
      for (int64_t i = threadIdx.x; i < entries; i += kThreads) {
        const u64 x = s[i];
        if (x == 0) continue;
        if (slot == kSlotMin || slot == kSlotMax) atomicMax(g + i, x);
        else atomicAdd(g + i, x);
      }
    } else {
      const uint32_t* s = static_cast<const uint32_t*>(target[slot]);
      uint32_t* g = a.acc + a.offset[slot];
      for (int64_t i = threadIdx.x; i < entries; i += kThreads) {
        const uint32_t x = s[i];
        if (x != 0) atomicAdd(g + i, x);
      }
    }
  }

  // the last block to arrive writes the outputs
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    last_block = atomicAdd(a.acc, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last_block) return;
  __threadfence();
  const double inf = __longlong_as_double(0x7ff0000000000000ll);
  for (int i = threadIdx.x; i < nb; i += kThreads) {
    if (a.out_counts != nullptr)
      a.out_counts[i] = static_cast<int32_t>(
          __ldcg(a.acc + a.offset[kSlotCounts] + i));
    if (a.out_count != nullptr) {
      const uint32_t c = __ldcg(a.acc + a.offset[kSlotCount] + i);
      if (a.count_f64) static_cast<double*>(a.out_count)[i] = c;
      else static_cast<int64_t*>(a.out_count)[i] = c;
    }
    const u64* g = reinterpret_cast<const u64*>(a.acc);
    if (a.out_sum != nullptr)
      a.out_sum[i] = static_cast<double>(static_cast<int64_t>(
          __ldcg(g + a.offset[kSlotSum] / 2 + i)));
    if (a.out_sum_sq != nullptr)
      a.out_sum_sq[i] = static_cast<double>(static_cast<int64_t>(
          __ldcg(g + a.offset[kSlotSumSq] / 2 + i)));
    if (a.out_min != nullptr) {
      const u64 key = __ldcg(g + a.offset[kSlotMin] / 2 + i);
      a.out_min[i] = key == 0 ? inf : from_order_key(~key);
    }
    if (a.out_max != nullptr) {
      const u64 key = __ldcg(g + a.offset[kSlotMax] / 2 + i);
      a.out_max[i] = key == 0 ? -inf : from_order_key(key);
    }
  }
}

}  // namespace

extern "C" {

// The SM count of the current device, after raising the kernel's dynamic
// shared memory limit there: call it once per device before a launch.
int qw_bucket_aggs_setup(int* num_sms) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(num_sms, cudaDevAttrMultiProcessorCount,
                               device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(bucket_aggs_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kMaxSmemBytes);
  return static_cast<int>(err);
}

// One launch over `args` on `stream`. `args->acc` must be zeroed and hold
// the ticket word, then each kept slot at its offset; the outputs are
// written by the last block.
int qw_bucket_aggs(const void* args_ptr, int num_sms, void* stream) {
  // `Args` lives in this file alone: a C caller passes it untyped
  const Args* args = static_cast<const Args*>(args_ptr);
  const int nb = args->nb;
  const bool smem_acc = nb <= kSmemAccBuckets;
  int64_t at[kSlots];
  const int64_t acc_bytes = smem_layout(args->needs & ~kSketch, nb,
                                        smem_acc, false, at);
  const bool smem_sketch =
      (args->needs & kSketch) != 0 &&
      acc_bytes + static_cast<int64_t>(nb) * kPctlBuckets * 4 <=
          kMaxSmemBytes;
  const int64_t bytes = smem_layout(args->needs, nb, smem_acc, smem_sketch,
                                    at);
  // blocks resident on an SM by shared memory (228 KB of it, 1 KB a block
  // reserved) and by threads (2048); a grid of at most that many per SM,
  // and at least kItemsPerThread docs a thread
  constexpr int64_t kBlocksByThreads = 2048 / kThreads;
  int64_t per_sm = (228 * 1024) / (bytes + 1024);
  if (per_sm > kBlocksByThreads) per_sm = kBlocksByThreads;
  if (per_sm < 1) per_sm = 1;
  int64_t grid = (args->n + static_cast<int64_t>(kThreads) *
                  kItemsPerThread - 1) / (static_cast<int64_t>(kThreads) *
                                          kItemsPerThread);
  const int64_t cap = per_sm * (num_sms > 0 ? num_sms : 1);
  grid = grid < 1 ? 1 : (grid > cap ? cap : grid);
  bucket_aggs_kernel<<<static_cast<int>(grid), kThreads,
                       static_cast<size_t>(bytes),
                       static_cast<cudaStream_t>(stream)>>>(
      *args, smem_acc, smem_sketch);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
