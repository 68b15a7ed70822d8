// Design probes for the priority scatter
// (r2d2dpg_torch/csrc/priority_scatter.cu), timed by
// probes/scatter_probes.py.  Not on any path of the port: each kernel
// isolates one step, or one design that was weighed and not kept, so its
// device time can be read beside the shipped kernel's on the card.
//
//   0 empty            the launch floor
//   1 store            both loads and the in-range store, no duplicate rule
//   2 match            + __match_any_sync on the 64-bit index (within warps)
//   3 shuffle          + 31 __shfl_down_sync compares instead (within warps)
//   4 scan             match, indices staged in shared memory behind one
//                      barrier, each warp scanning the later warps' entries
//   5 table_match      match, then a last-writer table of packed 64-bit
//                      entries ((index+1) << 24 | j): atomicCAS + atomicMax
//   6 registers_match  match within warps, later warps' indices loaded by
//                      each warp and compared by broadcast shuffles (the
//                      shipped kernel, with match in place of shuffles)
// Probes 4-6 are complete scatters; 1-3 leave duplicates across warps.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kJBits = 24;
constexpr unsigned long long kJMask = (1ull << kJBits) - 1;

using Probe = void (*)(float*, int64_t, const int64_t*, const float*, int,
                       unsigned);

__device__ __forceinline__ bool last_in_warp(int j, int b, int64_t idx,
                                             int64_t cap) {
  const bool live = j < b;
  const unsigned active = __ballot_sync(kFull, live);
  if (!live) return false;
  const unsigned same =
      __match_any_sync(active, static_cast<unsigned long long>(idx));
  return (31 - __clz(same)) == (j & 31) && idx >= 0 && idx < cap;
}

__device__ __forceinline__ int key_of(int64_t i, int64_t cap) {
  return i >= 0 && i < cap ? static_cast<int>(i) : -1;
}

__global__ void empty(float*, int64_t, const int64_t*, const float*, int,
                      unsigned) {}

__global__ void store(float* p, int64_t cap, const int64_t* ind,
                      const float* val, int b, unsigned) {
  const int t = threadIdx.x;
  if (t >= b) return;
  const int64_t i = ind[t];
  const float v = val[t];
  if (i >= 0 && i < cap) p[i] = v;
}

__global__ void match(float* p, int64_t cap, const int64_t* ind,
                      const float* val, int b, unsigned) {
  const int t = threadIdx.x;
  int64_t i = -1;
  float v = 0.0f;
  if (t < b) {
    i = ind[t];
    v = val[t];
  }
  if (last_in_warp(t, b, i, cap)) p[i] = v;
}

__global__ void shuffle(float* p, int64_t cap, const int64_t* ind,
                        const float* val, int b, unsigned) {
  const int t = threadIdx.x, lane = t & 31;
  int64_t i = -1;
  float v = 0.0f;
  if (t < b) {
    i = ind[t];
    v = val[t];
  }
  const int key = key_of(i, cap);
  bool later = false;
#pragma unroll
  for (int r = 1; r < 32; ++r) {
    const int other = __shfl_down_sync(kFull, key, r);  // every lane shuffles
    later |= lane + r < 32 && other == key;
  }
  if (key >= 0 && !later) p[i] = v;
}

__global__ void scan(float* p, int64_t cap, const int64_t* ind,
                     const float* val, int b, unsigned) {
  extern __shared__ int64_t staged[];
  const int t = threadIdx.x, lane = t & 31;
  int64_t i = -1;
  float v = 0.0f;
  if (t < b) {
    i = ind[t];
    v = val[t];
    staged[t] = i;
  }
  __syncthreads();
  bool keep = last_in_warp(t, b, i, cap);
  if (__any_sync(kFull, keep)) {
    bool later = false;
#pragma unroll 8
    for (int k = t - lane + 32; k < b; ++k) later |= staged[k] == i;
    keep = keep && !later;
  }
  if (keep) p[i] = v;
}

__device__ __forceinline__ unsigned home_slot(int64_t i, unsigned mask) {
  return static_cast<unsigned>(
             (static_cast<unsigned long long>(i) * 0x9E3779B97F4A7C15ull) >>
             32) &
         mask;
}

__global__ void table_match(float* p, int64_t cap, const int64_t* ind,
                            const float* val, int b, unsigned mask) {
  extern __shared__ unsigned long long table[];
  const int t = threadIdx.x;
  int64_t i = -1;
  float v = 0.0f;
  if (t < b) {
    i = ind[t];
    v = val[t];
  }
  for (unsigned s = t; s <= mask; s += blockDim.x) table[s] = 0ull;
  const bool keep = last_in_warp(t, b, i, cap);
  __syncthreads();
  unsigned slot = 0;
  if (keep) {
    const unsigned long long tag = static_cast<unsigned long long>(i + 1)
                                   << kJBits;
    const unsigned long long entry = tag | static_cast<unsigned>(t);
    for (unsigned s = home_slot(i, mask);; s = (s + 1) & mask) {
      const unsigned long long prev = atomicCAS(table + s, 0ull, entry);
      if (prev == 0ull || (prev & ~kJMask) == tag) {
        if (prev != 0ull) atomicMax(table + s, entry);
        slot = s;
        break;
      }
    }
  }
  __syncthreads();
  if (keep && static_cast<int>(table[slot] & kJMask) == t) p[i] = v;
}

__global__ void registers_match(float* p, int64_t cap, const int64_t* ind,
                                const float* val, int b, unsigned) {
  const int t = threadIdx.x, lane = t & 31, w = t >> 5, warps = (b + 31) >> 5;
  int64_t i = -1, next = -1;
  float v = 0.0f;
  if (t < b) {
    i = ind[t];
    v = val[t];
  }
  if ((w + 1) * 32 + lane < b) next = ind[(w + 1) * 32 + lane];
  const int key = key_of(i, cap);
  bool keep = last_in_warp(t, b, i, cap);
  if (__any_sync(kFull, keep)) {
    bool later = false;
    for (int u = w + 1; u < warps; ++u) {
      const int other = key_of(next, cap);
      next = (u + 1) * 32 + lane < b ? ind[(u + 1) * 32 + lane] : -1;
#pragma unroll
      for (int r = 0; r < 32; ++r) later |= __shfl_sync(kFull, other, r) == key;
    }
    keep = keep && !later;
  }
  if (keep) p[i] = v;
}

const Probe kProbes[] = {empty, store, match, shuffle,
                         scan, table_match, registers_match};

}  // namespace

extern "C" int probe_count() {
  return static_cast<int>(sizeof(kProbes) / sizeof(kProbes[0]));
}

// One block of ceil(b/32)*32 threads (b <= 1,024); returns cudaGetLastError().
extern "C" int probe_launch(int probe, float* p, int64_t cap,
                            const int64_t* ind, const float* val, int b,
                            void* stream) {
  if (probe < 0 || probe >= probe_count() || b <= 0 || b > 1024) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  unsigned slots = 1;
  while (slots < 2u * b) slots <<= 1;
  size_t smem = 0;
  if (probe == 4) smem = static_cast<size_t>(b) * 8;
  if (probe == 5) smem = static_cast<size_t>(slots) * 8;
  kProbes[probe]<<<1, (b + 31) / 32 * 32, smem,
                   static_cast<cudaStream_t>(stream)>>>(p, cap, ind, val, b,
                                                        slots - 1);
  return static_cast<int>(cudaGetLastError());
}
