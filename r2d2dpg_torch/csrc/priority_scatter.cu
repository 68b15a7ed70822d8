// Priority scatter write-back for the replay arena, hand-written for Hopper.
//
// Replaces r2d2dpg_tpu/ops/pallas/scatter.py::_pallas_scatter (kernel body
// _scatter_kernel): priority.at[indices].set(values) over the arena's
// [capacity] float32 priority vector, once per learner step.
//
// Semantics (identical to the TPU kernel's fori_loop of masked selects):
//   - thread j writes values[j] to priority[indices[j]] only when
//     0 <= indices[j] < capacity, and
//   - no k > j has indices[k] == indices[j]: among repeated indices the
//     LAST one wins, deterministically.  Plain index_put_/scatter_ leave the
//     winner among duplicates unspecified on CUDA, and sampling with
//     replacement draws duplicates routinely.
//   - an index outside [0, capacity) writes nothing.
// The duplicate check costs O(B^2) compares per launch, which is nothing at
// learner batches B <= 256 (the indices stay in L1 after the first pass).
//
// Unlike the JAX version, which returns a fresh [capacity] vector, this
// kernel updates the priority tensor IN PLACE: only the B winning slots are
// touched, the rest of the vector is never read or copied.
//
// Bound on this card: the work moves about B x 16 bytes (an 8-byte index and
// a 4-byte value read per update, a 4-byte priority written per winner):
// 1 KB at B = 64, far under a microsecond of HBM time.  A launch is thus
// bound by launch latency (a few microseconds), not by bytes or operations.
// Making it fast (fusing it into the learner step, or a CUDA graph around the
// step) is work for a later change; this kernel is the simple correct one.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__global__ void priority_scatter_kernel(float* __restrict__ priority,
                                        int64_t capacity,
                                        const int64_t* __restrict__ indices,
                                        const float* __restrict__ values,
                                        int b) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= b) return;
  const int64_t idx = indices[j];
  if (idx < 0 || idx >= capacity) return;
  for (int k = j + 1; k < b; ++k) {
    if (indices[k] == idx) return;  // a later update to this slot wins
  }
  priority[idx] = values[j];
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int priority_scatter_f32(float* priority, int64_t capacity,
                                    const int64_t* indices,
                                    const float* values, int b,
                                    void* stream) {
  if (b <= 0) return 0;
  constexpr int kThreads = 256;
  const int blocks = (b + kThreads - 1) / kThreads;
  priority_scatter_kernel<<<blocks, kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      priority, capacity, indices, values, b);
  return static_cast<int>(cudaGetLastError());
}
