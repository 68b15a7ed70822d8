// Priority scatter write-back for the replay arena, hand-written for Hopper.
//
// Replaces r2d2dpg_tpu/ops/pallas/scatter.py::_pallas_scatter (kernel body
// _scatter_kernel): priority.at[indices].set(values) over the arena's
// [capacity] float32 priority vector, once per learner step.
//
// Semantics (identical to the TPU kernel's fori_loop of masked selects):
//   - update j writes values[j] to priority[indices[j]] only when
//     0 <= indices[j] < capacity, and
//   - no k > j has indices[k] == indices[j]: among repeated indices the
//     LAST one wins, deterministically.  Plain index_put_/scatter_ leave the
//     winner among duplicates unspecified on CUDA, and sampling with
//     replacement draws duplicates routinely.
//   - an index outside [0, capacity) writes nothing.
// Unlike the JAX version, which returns a fresh [capacity] vector, this
// kernel updates the priority tensor IN PLACE: only the winning slots are
// touched, the rest of the vector is never read or copied.  Indices are
// compared as 32-bit keys (an in-range index, or -1), as the TPU kernel's
// int32 indices are; the wrapper refuses a capacity of 2^31 or more.
//
// What bounds it on this card: launch latency.  The work moves about
// B x 16 bytes (an 8-byte index and a 4-byte value read per update, a
// 4-byte priority written per winner): 1 KB at B = 64, about 0.3 ns at
// 3.35 TB/s.  So the design spends as little as it can between the launch
// and the last store:
//   1. One block sized to the batch: ceil(B/32)*32 threads, up to 1,024
//      (past that, blocks of 1,024: the warps share nothing).  No idle
//      warps, no second block to schedule, and no loop: a block-stride
//      loop, and the same loop with its first round written out, both
//      measured slower at B = 64, the second the slower (PERF.md).  The
//      wrapper computes the shape (ops/scatter.py::_launch_shape) and
//      passes it in.
//   2. Both loads first: each thread issues its loads of indices[j] and
//      values[j], and of the first later warp's index, before anything
//      waits on them, so the launch pays one L2 round trip, not two.
//   3. Duplicates inside a warp: a lane compares its key with the 31 lanes
//      above it by __shfl_down_sync.  On this card 31 shuffles cost less
//      than one __match_any_sync.
//   4. Duplicates across warps, in registers: each warp loads the later
//      warps' indices in turn, one a lane, and compares them by broadcast
//      shuffles, the next group's load issued before this group is
//      compared.  At the learner's B = 64 that is warp 0 comparing warp 1's
//      32 indices, and warp 1 nothing.  No shared memory, no barrier, no
//      atomics; the work grows as B^2 / 32 shuffles, which no batch of the
//      port's configurations (at most 64 with prioritized replay) feels.
//   5. Capturable in a CUDA graph: no allocation, no synchronisation with
//      the host; it launches on the caller's stream and returns
//      cudaGetLastError().
// The host packs the launch arguments into one 64-byte record (LaunchArgs),
// so ctypes converts one argument per call, not eight.  The empty kernel
// below, launched through the same route, measures the floor that launch
// latency sets.  probes/scatter_probes.py times these choices against the
// alternatives.

#include <cstdint>
#include <cuda_runtime.h>

// The wrapper's launch record (ops/scatter.py::_LAUNCH_RECORD, "=8q").
struct LaunchArgs {
  int64_t priority;  // float*
  int64_t capacity;  // < 2^31
  int64_t indices;  // const int64_t*
  int64_t values;  // const float*
  int64_t b;  // <= INT32_MAX - 1,024
  int64_t blocks;
  int64_t threads;
  int64_t stream;  // cudaStream_t
};

namespace {

constexpr int kWarp = 32;
constexpr int kMaxThreads = 1024;
constexpr unsigned kFullMask = 0xffffffffu;

// An in-range index as a 32-bit key, or -1.
__device__ __forceinline__ int key_of(int64_t idx, int64_t capacity) {
  return idx >= 0 && idx < capacity ? static_cast<int>(idx) : -1;
}

// Each warp resolves its own 32 updates, j = first .. first + 31, and
// shares nothing with other warps, so past 1,024 updates the grid takes
// more blocks.  `first` is warp-uniform, so every lane takes part in every
// shuffle.
__global__ void __launch_bounds__(kMaxThreads)
    scatter_last_wins(float* __restrict__ priority, int64_t capacity,
                      const int64_t* __restrict__ indices,
                      const float* __restrict__ values, int b) {
  const int lane = threadIdx.x & (kWarp - 1);
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int first = j - lane;
  int64_t idx = -1, next = -1;
  float val = 0.0f;
  if (j < b) {
    idx = indices[j];
    val = values[j];
  }
  if (j + kWarp < b) next = indices[j + kWarp];
  const int key = key_of(idx, capacity);
  bool later = false;
#pragma unroll
  for (int r = 1; r < kWarp; ++r) {
    const int other = __shfl_down_sync(kFullMask, key, r);
    later |= lane + r < kWarp && other == key;
  }
  // The later warps' updates, 32 at a time: each lane holds one, and every
  // lane compares its key with all 32 by broadcast shuffles.  The next
  // group's load is issued before this group is compared.
  if (first + kWarp < b) {
    int others = key_of(next, capacity);
    for (int group = first + 2 * kWarp;; group += kWarp) {
      next = group + lane < b ? indices[group + lane] : -1;
#pragma unroll
      for (int r = 0; r < kWarp; ++r) {
        later |= __shfl_sync(kFullMask, others, r) == key;
      }
      if (group >= b) break;
      others = key_of(next, capacity);
    }
  }
  if (key >= 0 && !later) priority[idx] = val;
}

__global__ void empty_kernel() {}

}  // namespace

// Launches `blocks` blocks of `threads` threads (a multiple of 32, at most
// 1,024; together at least B) on `stream`.  Returns cudaGetLastError() (0
// on success).
extern "C" int priority_scatter_f32(const LaunchArgs* a) {
  const int64_t b = a->b, blocks = a->blocks, threads = a->threads;
  if (b <= 0) return 0;
  if (threads <= 0 || threads % kWarp != 0 || threads > kMaxThreads ||
      blocks <= 0 || blocks * threads < b || b > INT32_MAX - kMaxThreads ||
      a->capacity > INT32_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  scatter_last_wins<<<static_cast<unsigned>(blocks),
                      static_cast<unsigned>(threads), 0,
                      reinterpret_cast<cudaStream_t>(a->stream)>>>(
      reinterpret_cast<float*>(a->priority), a->capacity,
      reinterpret_cast<const int64_t*>(a->indices),
      reinterpret_cast<const float*>(a->values), static_cast<int>(b));
  return static_cast<int>(cudaGetLastError());
}

// The launch floor: an empty kernel through the same route (only the
// record's stream is read).
extern "C" int launch_floor(const LaunchArgs* a) {
  empty_kernel<<<1, kWarp, 0, reinterpret_cast<cudaStream_t>(a->stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
