// LSTM recurrence over a window, forward and backward, hand-written for Hopper.
//
// Replaces no TPU kernel: the JAX package leaves its LSTM unrolls to XLA,
// which fuses each step.  The port ran each unroll step by step, some 15
// launches a step (a 32x32-tiled cuBLAS product of B rows, the bias join,
// the reset's selects, nine elementwise gate kernels), thousands a learner
// step.  Here the non-recurrent work (torso, mix, head and the input
// projection zx = x Wi^T) runs once over the window's T*B rows outside, and
// the recurrence is one launch forward and one backward
// (ops/lstm_seq.py).
//
// Semantics: flax's OptimizedLSTMCell in float32, as models/actor_critic.py
// computes it step by step.  Per step t, for each row (member e, batch b):
//   h', c' = the carry zeroed where reset[t, b]
//   z = ((h' Wh^T) + bh) + zx[t]          gates i, f, g, o along 4H
//   c = sigmoid(f) c' + sigmoid(i) tanh(g);  h = sigmoid(o) tanh(c)
// Float32 FMAs on the CUDA cores, no tensor-core (TF32) path: the learner's
// correctness limits lie below what TF32 rounding gives.  The products'
// terms are summed in another order than cuBLAS sums them, so results
// differ from the step form by float32 rounding only.
//
// Backward, in reverse time, from the saved post-activation gates and c:
//   dh = dy[t] + dh_carry;  dc = dc_carry + dh o (1 - tanh(c)^2)
//   dz = (dc g i(1-i), dc c' f(1-f), dc i (1-g^2), dh tanh(c) o(1-o))
//   dc_carry = dc f,  dh_carry = dz Wh,  both cut where reset[t].
// The kernel returns dz [E, T, B, 4H] and the initial carry's gradient; the
// weight gradients are one product each over T*B rows outside.
//
// What bounds it on this card: the step's latency, not its work.  One step at
// walker's shape (B 64, H 256) is 64 x 1024 x 256 = 16.8 M FMA, 33.5 MFLOP,
// 0.5 us on the card's 67 TFLOP/s of float32; the step's inputs are on chip.
// So the design keeps each step on chip and spreads it over the whole card:
//   1. One launch for the window: a grid of thread-block clusters, each
//      cluster owning a slice of RC rows of one ensemble member for all T
//      steps.  Clusters never talk to each other, so any B runs: past the
//      card's SMs the clusters run in waves.
//   2. Inside a cluster, block q owns 32 hidden units: all four gate rows of
//      Wh for them, so the cell update needs no exchange.  A cluster has
//      H / 32 blocks (8 at H 256, 4 at 128, 1 at 32).  The block's slice of
//      Wh (128 x H floats) lives in registers for the whole window, spread
//      over its 256 threads (128 floats a thread at H 256): read from
//      shared memory, it cost a load per multiply-add and bounded the step.
//   3. Forward step: lane u of warp w forms the four gate sums of unit u
//      over the k slice w of h_{t-1} (h read from the block's own shared
//      memory, the same address in every lane: a broadcast), RT rows at a
//      time; the eight slices' partial sums meet in shared memory, the cell
//      update of each (row, unit) keeps c in a register, and each block
//      writes its 32 units of h_t into every block of the cluster through
//      distributed shared memory; one cluster barrier a step.  h is
//      double-buffered, so that one barrier suffices.
//   4. Backward step: each block forms dz for its 128 gate columns; lane u
//      of warp w sums dz Wh over column slice w for units u + 32 m; the
//      warps' sums meet in shared memory and each unit's total goes to the
//      block that owns it (a reduce-scatter through distributed shared
//      memory); one cluster barrier a step.
//   5. The next step's zx (forward) or gates, c and dy (backward) are
//      loaded into registers while the current step computes, and a step's
//      outputs are stored to global memory after its barrier: the barrier
//      releases the step's writes, and would wait on those stores.
//   6. RC is the least of 2, 4, 8, 16 rows that puts every block of the
//      grid on the card at once (the wrapper computes it from the SM count).
//   7. Capturable in a CUDA graph: no allocation, no host synchronisation;
//      it launches on the caller's stream and returns cudaGetLastError().
// The host packs the launch arguments into one record (FwdArgs, BwdArgs).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace cg = cooperative_groups;

// The wrapper's launch records (ops/lstm_seq.py::_FWD_RECORD, _BWD_RECORD).
struct FwdArgs {
  int64_t zx;  // const float* [E, T, B, 4H]
  int64_t wh;  // const float* [E, 4H, H]
  int64_t bh;  // const float* [E, 4H]
  int64_t c0;  // const float* [E, B, H]
  int64_t h0;  // const float* [E, B, H]
  int64_t reset;  // const bool* [T, B]
  int64_t y;  // float* [E, T, B, H]
  int64_t c_last;  // float* [E, B, H]
  int64_t gates;  // float* [E, T, B, 4H], post-activation; 0: not saved
  int64_t cs;  // float* [E, T, B, H]; 0: not saved
  int64_t e, t, b, h;
  int64_t rows;  // RC, rows of a cluster: 2, 4, 8 or 16
  int64_t stream;  // cudaStream_t
};

struct BwdArgs {
  int64_t dy;  // const float* [E, T, B, H]
  int64_t dc_last;  // const float* [E, B, H]
  int64_t wh;  // const float* [E, 4H, H]
  int64_t gates;  // const float* [E, T, B, 4H]
  int64_t cs;  // const float* [E, T, B, H]
  int64_t c0;  // const float* [E, B, H]
  int64_t reset;  // const bool* [T, B]
  int64_t dz;  // float* [E, T, B, 4H]
  int64_t dc0;  // float* [E, B, H]; 0 with dh0: no carry gradient
  int64_t dh0;  // float* [E, B, H]
  int64_t e, t, b, h;
  int64_t rows;
  int64_t stream;
};

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;  // the k (forward) or column (backward) slices
constexpr int kUnits = 32;  // hidden units a block owns
constexpr int kCols = 4 * kUnits;  // their gate columns
constexpr int kMaxRows = 16;  // RC at most
constexpr int kPairs = kMaxRows * kUnits / kThreads;  // (row, unit) pairs a thread

__device__ __forceinline__ float sigmoid(float x) { return 1.0f / (1.0f + expf(-x)); }

// Floats of dynamic shared memory.
template <int H>
constexpr int fwd_smem_floats(int rc) {
  return 2 * rc * H + kWarps * rc * kCols;
}
template <int H>
constexpr int bwd_smem_floats(int rc) {
  return rc * kCols + kWarps * rc * H + 2 * (H / kUnits) * rc * kUnits;
}

template <int H, int RT>
__global__ void __cluster_dims__(H / kUnits, 1, 1) __launch_bounds__(kThreads, 1)
    lstm_seq_fwd(const float* __restrict__ zx, const float* __restrict__ wh,
                 const float* __restrict__ bh, const float* __restrict__ c0,
                 const float* __restrict__ h0, const bool* __restrict__ reset,
                 float* __restrict__ y, float* __restrict__ c_last,
                 float* __restrict__ gates_out, float* __restrict__ cs_out, int T,
                 int B, int RC) {
  constexpr int C = H / kUnits;
  constexpr int KL = H / kWarps;  // k terms a thread sums: 32, 16, 4
  constexpr int G = 4 * H;
  extern __shared__ float4 smem4[];
  float* hbuf = reinterpret_cast<float*>(smem4);  // [2][RC][H]: h', masked for its step
  float* part = hbuf + 2 * RC * H;  // [kWarps][RC][kCols]: each warp's k slice

  cg::cluster_group cluster = cg::this_cluster();
  const int q = static_cast<int>(cluster.block_rank());
  const int e = blockIdx.y;
  const int b0 = (blockIdx.x / C) * RC;
  const int nr = min(RC, B - b0);
  const int tid = threadIdx.x;
  const int u = tid % kUnits, ks = tid / kUnits;  // lane: unit; warp: k slice
  const int unit0 = q * kUnits;

  // Wh of unit unit0 + u, its four gate rows over this warp's k slice, in
  // registers for the whole window.
  float w[4][KL];
  const float* whe = wh + static_cast<size_t>(e) * G * H + ks * KL;
#pragma unroll
  for (int g = 0; g < 4; ++g) {
#pragma unroll
    for (int k = 0; k < KL; k += 4) {
      const float4 v = *reinterpret_cast<const float4*>(
          whe + static_cast<size_t>(g * H + unit0 + u) * H + k);
      w[g][k] = v.x;
      w[g][k + 1] = v.y;
      w[g][k + 2] = v.z;
      w[g][k + 3] = v.w;
    }
  }
  for (int i = tid; i < 2 * RC * H; i += kThreads) hbuf[i] = 0.0f;
  __syncthreads();
  for (int i = tid; i < nr * H; i += kThreads) {
    const int r = i / H, k = i - r * H;
    const int b = b0 + r;
    hbuf[i] = reset[b] ? 0.0f : h0[(static_cast<size_t>(e) * B + b) * H + k];
  }

  float* peers[C];
#pragma unroll
  for (int p = 0; p < C; ++p) peers[p] = cluster.map_shared_rank(hbuf, p);

  // This thread's (row, unit) pairs, rows ks and ks + 8 of unit u: c in a
  // register, the next step's zx and reset loaded ahead.
  float c[kPairs], bias[4], zx_next[kPairs][4];
  bool rst_next[kPairs];
#pragma unroll
  for (int g = 0; g < 4; ++g) bias[g] = bh[e * G + g * H + unit0 + u];
#pragma unroll
  for (int i = 0; i < kPairs; ++i) {
    const int r = ks + i * kWarps;
    c[i] = 0.0f;
    rst_next[i] = false;
    if (r < nr) {
      const int b = b0 + r;
      c[i] = c0[(static_cast<size_t>(e) * B + b) * H + unit0 + u];
      const float* z = zx + (static_cast<size_t>(e) * T * B + b) * G + unit0 + u;
#pragma unroll
      for (int g = 0; g < 4; ++g) zx_next[i][g] = z[g * H];
      rst_next[i] = reset[b];
    }
  }
  cluster.sync();  // every block of the cluster runs before a remote store

  for (int t = 0; t < T; ++t) {
    float zx_cur[kPairs][4];
    bool rst_cur[kPairs];
#pragma unroll
    for (int i = 0; i < kPairs; ++i) {
      const int r = ks + i * kWarps;
#pragma unroll
      for (int g = 0; g < 4; ++g) zx_cur[i][g] = zx_next[i][g];
      rst_cur[i] = rst_next[i];
      if (r < nr && t + 1 < T) {
        const int b = b0 + r;
        const float* z =
            zx + ((static_cast<size_t>(e) * T + t + 1) * B + b) * G + unit0 + u;
#pragma unroll
        for (int g = 0; g < 4; ++g) zx_next[i][g] = z[g * H];
        rst_next[i] = reset[(t + 1) * B + b];
      }
    }

    // h' Wh^T over this warp's k slice for the four gates of unit u, RT
    // rows at a time; every lane reads the same h (a broadcast).
    const float* hcur = hbuf + (t & 1) * RC * H + ks * KL;
    for (int r0 = 0; r0 < RC; r0 += RT) {
      float acc[RT][4];
#pragma unroll
      for (int r = 0; r < RT; ++r) {
#pragma unroll
        for (int g = 0; g < 4; ++g) acc[r][g] = 0.0f;
      }
#pragma unroll
      for (int k = 0; k < KL; k += 4) {
#pragma unroll
        for (int r = 0; r < RT; ++r) {
          const float4 hv = *reinterpret_cast<const float4*>(hcur + (r0 + r) * H + k);
#pragma unroll
          for (int g = 0; g < 4; ++g) {
            acc[r][g] = fmaf(hv.x, w[g][k], acc[r][g]);
            acc[r][g] = fmaf(hv.y, w[g][k + 1], acc[r][g]);
            acc[r][g] = fmaf(hv.z, w[g][k + 2], acc[r][g]);
            acc[r][g] = fmaf(hv.w, w[g][k + 3], acc[r][g]);
          }
        }
      }
#pragma unroll
      for (int r = 0; r < RT; ++r) {
#pragma unroll
        for (int g = 0; g < 4; ++g) part[(ks * RC + r0 + r) * kCols + g * kUnits + u] = acc[r][g];
      }
    }
    __syncthreads();

    // The cell update of each (row, unit), h_t to every block of the
    // cluster; the step's outputs stay in registers until after the
    // barrier, so that its release does not wait on their global stores.
    const int next = ((t + 1) & 1) * RC * H;
    float out[kPairs][6];  // i, f, g, o, c, h
#pragma unroll
    for (int i = 0; i < kPairs; ++i) {
      const int r = ks + i * kWarps;
      if (r >= nr) continue;
      float z[4];
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        float s = part[r * kCols + g * kUnits + u];
#pragma unroll
        for (int m = 1; m < kWarps; ++m) s += part[(m * RC + r) * kCols + g * kUnits + u];
        z[g] = (s + bias[g]) + zx_cur[i][g];
      }
      const float cp = rst_cur[i] ? 0.0f : c[i];
      out[i][0] = sigmoid(z[0]);
      out[i][1] = sigmoid(z[1]);
      out[i][2] = tanhf(z[2]);
      out[i][3] = sigmoid(z[3]);
      out[i][4] = out[i][1] * cp + out[i][0] * out[i][2];
      out[i][5] = out[i][3] * tanhf(out[i][4]);
      c[i] = out[i][4];
      if (t + 1 < T) {
        const float hm = rst_next[i] ? 0.0f : out[i][5];
#pragma unroll
        for (int pr = 0; pr < C; ++pr) peers[pr][next + r * H + unit0 + u] = hm;
      }
    }
    cluster.sync();

#pragma unroll
    for (int i = 0; i < kPairs; ++i) {
      const int r = ks + i * kWarps;
      if (r >= nr) continue;
      const size_t row = (static_cast<size_t>(e) * T + t) * B + b0 + r;
      const int col = unit0 + u;
      y[row * H + col] = out[i][5];
      if (gates_out != nullptr) {
        float* gp = gates_out + row * G + col;
#pragma unroll
        for (int g = 0; g < 4; ++g) gp[g * H] = out[i][g];
        cs_out[row * H + col] = out[i][4];
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kPairs; ++i) {
    const int r = ks + i * kWarps;
    if (r < nr) c_last[(static_cast<size_t>(e) * B + b0 + r) * H + unit0 + u] = c[i];
  }
}

template <int H, int RT>
__global__ void __cluster_dims__(H / kUnits, 1, 1) __launch_bounds__(kThreads, 1)
    lstm_seq_bwd(const float* __restrict__ dy, const float* __restrict__ dc_last,
                 const float* __restrict__ wh, const float* __restrict__ gates,
                 const float* __restrict__ cs, const float* __restrict__ c0,
                 const bool* __restrict__ reset, float* __restrict__ dz,
                 float* __restrict__ dc0, float* __restrict__ dh0, int T, int B,
                 int RC) {
  constexpr int C = H / kUnits;
  constexpr int JL = kCols / kWarps;  // gate columns a thread sums over: 16
  constexpr int UL = H / kUnits;  // units a thread sums for: 8, 4, 1
  constexpr int G = 4 * H;
  extern __shared__ float4 smem4[];
  float* dzs = reinterpret_cast<float*>(smem4);  // [RC][kCols]
  float* part = dzs + RC * kCols;  // [kWarps][RC][H]: each warp's column slice
  float* recv = part + kWarps * RC * H;  // [2][C][RC][kUnits]: dh_carry from each block

  cg::cluster_group cluster = cg::this_cluster();
  const int q = static_cast<int>(cluster.block_rank());
  const int e = blockIdx.y;
  const int b0 = (blockIdx.x / C) * RC;
  const int nr = min(RC, B - b0);
  const int tid = threadIdx.x;
  const int u = tid % kUnits, js = tid / kUnits;  // lane: unit; warp: column slice
  const int unit0 = q * kUnits;
  const bool carry_grad = dh0 != nullptr;

  // Wh over this warp's 16 gate columns (gate column j of the block is row
  // (j / 32) H + unit0 + j % 32 of Wh), for units u + 32 m, in registers.
  float w[JL][UL];
  const float* whe = wh + static_cast<size_t>(e) * G * H;
#pragma unroll
  for (int jj = 0; jj < JL; ++jj) {
    const int j = js * JL + jj;
    const float* row = whe + static_cast<size_t>((j / kUnits) * H + unit0 + j % kUnits) * H;
#pragma unroll
    for (int m = 0; m < UL; ++m) w[jj][m] = row[u + kUnits * m];
  }
  for (int i = tid; i < RC * kCols; i += kThreads) dzs[i] = 0.0f;

  // Per (row, unit) pair: dc_carry in a register, the step's inputs loaded
  // one step ahead.
  float dcc[kPairs], in_next[kPairs][7];  // i f g o, c_t, c_{t-1}, dy
  bool rst_next[kPairs];
  auto load = [&](int i, int t, float* v, bool& rst) {
    const int b = b0 + js + i * kWarps, col = unit0 + u;
    const size_t row = (static_cast<size_t>(e) * T + t) * B + b;
#pragma unroll
    for (int g = 0; g < 4; ++g) v[g] = gates[row * G + g * H + col];
    v[4] = cs[row * H + col];
    v[5] = t > 0 ? cs[(row - B) * H + col] : c0[(static_cast<size_t>(e) * B + b) * H + col];
    v[6] = dy[row * H + col];
    rst = reset[t * B + b];
  };
#pragma unroll
  for (int i = 0; i < kPairs; ++i) {
    const int r = js + i * kWarps;
    dcc[i] = 0.0f;
    rst_next[i] = false;
    if (r < nr) {
      dcc[i] = dc_last[(static_cast<size_t>(e) * B + b0 + r) * H + unit0 + u];
      load(i, T - 1, in_next[i], rst_next[i]);
    }
  }
  cluster.sync();

  bool rst_later[kPairs];  // reset[t + 1]: cuts dh_carry
#pragma unroll
  for (int i = 0; i < kPairs; ++i) rst_later[i] = true;
  for (int t = T - 1; t >= 0; --t) {
    float in[kPairs][7];
    bool rst[kPairs];
#pragma unroll
    for (int i = 0; i < kPairs; ++i) {
      const int r = js + i * kWarps;
#pragma unroll
      for (int v = 0; v < 7; ++v) in[i][v] = in_next[i][v];
      rst[i] = rst_next[i];
      if (r < nr && t > 0) load(i, t - 1, in_next[i], rst_next[i]);
    }

    // dz of each (row, unit), from dy, the carried gradients and the gates;
    // kept in registers for its global store after the barrier.
    const float* rin = recv + ((t + 1) & 1) * C * RC * kUnits;
    float d[kPairs][4];
#pragma unroll
    for (int i = 0; i < kPairs; ++i) {
      const int r = js + i * kWarps;
      if (r >= nr) continue;
      float dhc = 0.0f;
      if (!rst_later[i]) {
#pragma unroll
        for (int s = 0; s < C; ++s) dhc += rin[(s * RC + r) * kUnits + u];
      }
      const float ig = in[i][0], fg = in[i][1], gg = in[i][2], og = in[i][3];
      const float cp = rst[i] ? 0.0f : in[i][5];
      const float dh = in[i][6] + dhc;
      const float tc = tanhf(in[i][4]);
      const float dc = dcc[i] + dh * og * (1.0f - tc * tc);
      d[i][0] = dc * gg * ig * (1.0f - ig);
      d[i][1] = dc * cp * fg * (1.0f - fg);
      d[i][2] = dc * ig * (1.0f - gg * gg);
      d[i][3] = dh * tc * og * (1.0f - og);
      dcc[i] = rst[i] ? 0.0f : dc * fg;
#pragma unroll
      for (int g = 0; g < 4; ++g) dzs[r * kCols + g * kUnits + u] = d[i][g];
      rst_later[i] = rst[i];
    }
    __syncthreads();

    // dz Wh: this warp's 16 columns for units u + 32 m, RT rows at a time;
    // every lane reads the same dz (a broadcast).  Then the sum over the
    // warps, each unit's to the block that owns it.
    if (t > 0 || carry_grad) {
      for (int r0 = 0; r0 < RC; r0 += RT) {
        float acc[RT][UL];
#pragma unroll
        for (int r = 0; r < RT; ++r) {
#pragma unroll
          for (int m = 0; m < UL; ++m) acc[r][m] = 0.0f;
        }
#pragma unroll
        for (int jj = 0; jj < JL; jj += 4) {
#pragma unroll
          for (int r = 0; r < RT; ++r) {
            const float4 dv =
                *reinterpret_cast<const float4*>(dzs + (r0 + r) * kCols + js * JL + jj);
#pragma unroll
            for (int m = 0; m < UL; ++m) {
              acc[r][m] = fmaf(dv.x, w[jj][m], acc[r][m]);
              acc[r][m] = fmaf(dv.y, w[jj + 1][m], acc[r][m]);
              acc[r][m] = fmaf(dv.z, w[jj + 2][m], acc[r][m]);
              acc[r][m] = fmaf(dv.w, w[jj + 3][m], acc[r][m]);
            }
          }
        }
#pragma unroll
        for (int r = 0; r < RT; ++r) {
#pragma unroll
          for (int m = 0; m < UL; ++m) part[(js * RC + r0 + r) * H + u + kUnits * m] = acc[r][m];
        }
      }
      __syncthreads();
      float* out = recv + (t & 1) * C * RC * kUnits + q * RC * kUnits;
      for (int i = tid; i < nr * H; i += kThreads) {
        const int r = i / H, k = i - r * H;
        float s = part[r * H + k];
#pragma unroll
        for (int m = 1; m < kWarps; ++m) s += part[(m * RC + r) * H + k];
        cluster.map_shared_rank(out, k / kUnits)[r * kUnits + k % kUnits] = s;
      }
    }
    cluster.sync();

#pragma unroll
    for (int i = 0; i < kPairs; ++i) {
      const int r = js + i * kWarps;
      if (r >= nr) continue;
      const size_t row = (static_cast<size_t>(e) * T + t) * B + b0 + r;
#pragma unroll
      for (int g = 0; g < 4; ++g) dz[row * G + g * H + unit0 + u] = d[i][g];
    }
  }

  if (carry_grad) {  // the gradient of the carry before step 0's reset
#pragma unroll
    for (int i = 0; i < kPairs; ++i) {
      const int r = js + i * kWarps;
      if (r >= nr) continue;
      float dhc = 0.0f;
#pragma unroll
      for (int s = 0; s < C; ++s) dhc += recv[(s * RC + r) * kUnits + u];
      const size_t at = (static_cast<size_t>(e) * B + b0 + r) * H + unit0 + u;
      dh0[at] = rst_later[i] ? 0.0f : dhc;
      dc0[at] = dcc[i];
    }
  }
}

// Raise a kernel's dynamic shared memory limit to ``bytes`` (the largest
// RC's) on the current device, once a device: ``allowed`` holds a bit a
// device.  Setting it twice from racing threads is harmless.
template <typename Kernel>
int allow_smem(Kernel kernel, int bytes, unsigned long long* allowed) {
  int dev = 0;
  int err = static_cast<int>(cudaGetDevice(&dev));
  if (err != 0 || dev >= 64) return err != 0 ? err : static_cast<int>(cudaErrorInvalidDevice);
  if ((*allowed >> dev) & 1ull) return 0;
  err = static_cast<int>(
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
  if (err == 0) *allowed |= 1ull << dev;
  return err;
}

template <int H, int RT>
int launch_fwd(const FwdArgs* a) {
  const int rc = static_cast<int>(a->rows);
  auto kernel = lstm_seq_fwd<H, RT>;
  static unsigned long long allowed = 0;
  const int attr = allow_smem(kernel, fwd_smem_floats<H>(kMaxRows) * 4, &allowed);
  if (attr != 0) return attr;
  const int clusters = static_cast<int>((a->b + rc - 1) / rc);
  const dim3 grid(clusters * (H / kUnits), static_cast<unsigned>(a->e));
  kernel<<<grid, kThreads, fwd_smem_floats<H>(rc) * 4,
           reinterpret_cast<cudaStream_t>(a->stream)>>>(
      reinterpret_cast<const float*>(a->zx), reinterpret_cast<const float*>(a->wh),
      reinterpret_cast<const float*>(a->bh), reinterpret_cast<const float*>(a->c0),
      reinterpret_cast<const float*>(a->h0), reinterpret_cast<const bool*>(a->reset),
      reinterpret_cast<float*>(a->y), reinterpret_cast<float*>(a->c_last),
      reinterpret_cast<float*>(a->gates), reinterpret_cast<float*>(a->cs),
      static_cast<int>(a->t), static_cast<int>(a->b), rc);
  return static_cast<int>(cudaGetLastError());
}

template <int H, int RT>
int launch_bwd(const BwdArgs* a) {
  const int rc = static_cast<int>(a->rows);
  auto kernel = lstm_seq_bwd<H, RT>;
  static unsigned long long allowed = 0;
  const int attr = allow_smem(kernel, bwd_smem_floats<H>(kMaxRows) * 4, &allowed);
  if (attr != 0) return attr;
  const int clusters = static_cast<int>((a->b + rc - 1) / rc);
  const dim3 grid(clusters * (H / kUnits), static_cast<unsigned>(a->e));
  kernel<<<grid, kThreads, bwd_smem_floats<H>(rc) * 4,
           reinterpret_cast<cudaStream_t>(a->stream)>>>(
      reinterpret_cast<const float*>(a->dy), reinterpret_cast<const float*>(a->dc_last),
      reinterpret_cast<const float*>(a->wh), reinterpret_cast<const float*>(a->gates),
      reinterpret_cast<const float*>(a->cs), reinterpret_cast<const float*>(a->c0),
      reinterpret_cast<const bool*>(a->reset), reinterpret_cast<float*>(a->dz),
      reinterpret_cast<float*>(a->dc0), reinterpret_cast<float*>(a->dh0),
      static_cast<int>(a->t), static_cast<int>(a->b), rc);
  return static_cast<int>(cudaGetLastError());
}

// The shapes the kernels take (the wrapper checks them first, with messages).
bool valid(int64_t e, int64_t t, int64_t b, int64_t h, int64_t rows) {
  return (h == 32 || h == 128 || h == 256) &&
         (rows == 2 || rows == 4 || rows == 8 || rows == 16) && e >= 1 && e <= 65535 &&
         t >= 1 && b >= 1 && e * t * b * 4 * h <= INT32_MAX;
}

template <typename Args, int (*F32)(const Args*), int (*F128)(const Args*),
          int (*F256)(const Args*)>
int dispatch_h(const Args* a) {
  switch (a->h) {
    case 32: return F32(a);
    case 128: return F128(a);
    default: return F256(a);
  }
}

}  // namespace

// Forward over the window; returns cudaGetLastError() (0 on success).
extern "C" int lstm_seq_forward(const FwdArgs* a) {
  if (!valid(a->e, a->t, a->b, a->h, a->rows) || (a->gates == 0) != (a->cs == 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (a->rows == 2) {
    return dispatch_h<FwdArgs, launch_fwd<32, 2>, launch_fwd<128, 2>, launch_fwd<256, 2>>(a);
  }
  return dispatch_h<FwdArgs, launch_fwd<32, 4>, launch_fwd<128, 4>, launch_fwd<256, 4>>(a);
}

// Backward over the window; returns cudaGetLastError() (0 on success).
extern "C" int lstm_seq_backward(const BwdArgs* a) {
  if (!valid(a->e, a->t, a->b, a->h, a->rows) || (a->dc0 == 0) != (a->dh0 == 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (a->rows == 2) {
    return dispatch_h<BwdArgs, launch_bwd<32, 2>, launch_bwd<128, 2>, launch_bwd<256, 2>>(a);
  }
  return dispatch_h<BwdArgs, launch_bwd<32, 4>, launch_bwd<128, 4>, launch_bwd<256, 4>>(a);
}
