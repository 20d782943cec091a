// Fused n-step Bellman targets and replay priorities for NVIDIA Hopper
// (sm_90a).
//
// Replaces the TPU kernel seed_rl_tpu/ops/pallas/nstep_kernel.py:36
// (_nstep_kernel, launched by _targets_and_priorities_pallas under
// td_loss_and_priorities). It computes what that kernel computes, per batch
// column b of the time-major [T, B] inputs (tq: target-net Q at the online
// argmax, still h-rescaled; r: rewards; d: done as 0/1, read as bool bytes
// or as f32; q: online Q at the replayed action):
//   Q^[0] = 0, Q^[s] = h^-1(tq[s-1]) for 1 <= s <= T,
//   Q^[T+k] = h^-1(tq[T-1]) / gamma^k for 1 <= k < n   (the padded tail),
//   r and d are 0 past T-1,
//   bt[i] = r[i] + g(1-d[i]) (r[i+1] + g(1-d[i+1]) (... (r[i+n-1]
//           + g(1-d[i+n-1]) Q^[i+n])))
//   target[t] = h(bt[t+1])                               for t < T-1,
//   priority  = eta * max_t |target[t] - q[t]| + (1-eta) * mean_t |...|.
// The nested form is the TPU kernel's n-fold padded recursion unrolled for
// one output row: the same multiplications and additions in the same
// order, each rounded once (__fmul_rn/__fadd_rn keep nvcc from contracting
// them into FMAs), so each target agrees with the plain PyTorch version to
// a few ulps. Division and sqrtf are IEEE (no --use_fast_math). The
// priority's sum over t is a block reduction, in another order than the
// plain version's torch.mean, which on the card sums in an order of its own
// too; over T-1 terms of |TD| that moves the mean by a few ulps, far inside
// the 1e-5 the two are held to.
//
// What bounds it on an H100 SXM (700 W; data sheet: 3.35 TB/s of HBM): the
// op reads three f32 [T, B] arrays and done (1 byte an element as bool, 4
// as f32) and writes (T-1)*B*4 + B*4 bytes: 17*T*B bytes with bool done
// (the R2D2 path), ~0.026 us at the loss shape [T, B] = [81, 64] and
// ~0.25 us at the insert shape [81, 610]. Its ~40 flops per element are
// negligible, and it holds no matrix product, so tensor cores and wgmma
// have no role. What it cannot go below at these sizes is a launch plus one
// dependent round trip to memory (load, compute, store), far above the
// byte bound.
//
// Design against that: one block takes kTile = 16 columns and all T rows,
// in chunks of at most kMaxChunk output rows.
//   - Staging. The chunk's rows of tq (the rows its targets start from), of
//     r and d (the chunk plus an n-1 row halo, at most kMaxHalo rows) and of
//     q, and tq[T-1] for the tail, are copied into shared memory with every
//     copy issued before any is used: cp.async for f32 arrays, plain loads
//     for bool bytes (cp.async moves 4 bytes at least); then one wait and
//     one __syncthreads(). No TMA: a tensor map needs a row stride that is a
//     multiple of 16 bytes, and B = 610 or 37 gives none.
//   - Rows in parallel. kRowThreads = 16 threads share a column and take
//     its output rows in turn (row y, y + 16, ...). Each evaluates the depth-n
//     nest for its row from shared memory, writes target[t] (16 neighbouring
//     columns of a row: coalesced) and forms |TD|. Rows of the nest past the
//     staged halo (only where n - 1 > kMaxHalo) are read from device memory.
//   - The tail's gamma^k = (float)pow(gamma_d, k), in double as the plain
//     version takes it, is computed once per block and chunk into a table,
//     one thread per tail row, while the copies are in flight.
//   - Priority: each thread keeps the max and sum of its rows' |TD|; warp
//     shuffles, then shared memory, combine the 16 threads of a column.
// The wrapper's launch_plan picks the chunk R = min(T-1, kMaxChunk) and the
// window W = min(R + min(n-1, kMaxHalo), T-1); the entry point below takes
// the block shape from the constants and the shared memory from layout_of:
//   4 * (kTile * (2W + 2R + 1 + 2 * warps) + R) bytes,  warps = 8,
// i.e. 21,888 B at T = 81, n = 5, and at most 42,560 B for any T and n
// (asserted at compile time): below the 48 KB a launch takes without
// opting in. Blocks = ceil(B / 16): 4 at the loss shape, 39 at the insert
// shape.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kTile = 16;       // columns per block (blockDim.x)
constexpr int kRowThreads = 16; // threads per column (blockDim.y)
constexpr int kThreads = kTile * kRowThreads;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxChunk = 128;  // output rows per chunk, at most
constexpr int kMaxHalo = 64;    // rows of r and d staged past the chunk
// Shared memory a launch takes without opting in to more; the largest
// chunk and halo stay below it.
constexpr int kDefaultSmemBytes = 48 * 1024;
// Elements of the r and d window each thread stages, at most.
constexpr int kWindowPerThread = (kMaxChunk + kMaxHalo) * kTile / kThreads;
static_assert(32 % kTile == 0 && kThreads % 32 == 0, "whole warps");
static_assert((kMaxChunk + kMaxHalo) * kTile % kThreads == 0, "even split");

struct Rescaling {
  float eps;        // eps
  float four_eps;   // 4*eps, rounded from double as the plain version does
  float two_eps;    // 2*eps, likewise
};

// The chunking the wrapper picks (launch_plan in ops/cuda/nstep_kernel.py).
struct Plan {
  int chunk;   // output rows per chunk
  int window;  // rows of r and d staged per chunk
};

// Offsets into the block's shared memory, in floats.
struct Layout {
  int r, d, tq, q, gamma_pow, q_last, red_max, red_sum, total;
};

__host__ __device__ constexpr Layout layout_of(const Plan& p) {
  Layout l{};
  l.r = 0;
  l.d = l.r + p.window * kTile;
  l.tq = l.d + p.window * kTile;
  l.q = l.tq + p.chunk * kTile;
  l.gamma_pow = l.q + p.chunk * kTile;
  l.q_last = l.gamma_pow + p.chunk;
  l.red_max = l.q_last + kTile;
  l.red_sum = l.red_max + kWarps * kTile;
  l.total = l.red_sum + kWarps * kTile;
  return l;
}
static_assert(layout_of(Plan{kMaxChunk, kMaxChunk + kMaxHalo}).total *
                      sizeof(float) <= kDefaultSmemBytes,
              "the largest plan launches without opting in to more");

// Shared memory of a plan in bytes, or -1 for a plan this kernel was not
// built for.
int smem_bytes_of(const Plan& p) {
  if (p.chunk < 1 || p.chunk > kMaxChunk || p.window < 1 ||
      p.window > kMaxChunk + kMaxHalo) {
    return -1;
  }
  return layout_of(p).total * static_cast<int>(sizeof(float));
}

__device__ __forceinline__ float sign_of(float x) {
  return x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : 0.0f);
}

// h(x) = sign(x) * (sqrt(|x| + 1) - 1) + eps * x
__device__ __forceinline__ float rescale(float x, const Rescaling& c) {
  const float root = __fadd_rn(sqrtf(__fadd_rn(fabsf(x), 1.0f)), -1.0f);
  return __fadd_rn(__fmul_rn(sign_of(x), root), __fmul_rn(c.eps, x));
}

// h^-1(x) = sign(x) * (((sqrt(1 + 4eps(|x| + 1 + eps)) - 1) / (2eps))^2 - 1)
__device__ __forceinline__ float unrescale(float x, const Rescaling& c) {
  const float inner = __fadd_rn(__fadd_rn(fabsf(x), 1.0f), c.eps);
  const float root =
      __fadd_rn(sqrtf(__fadd_rn(1.0f, __fmul_rn(c.four_eps, inner))), -1.0f);
  const float ratio = __fdiv_rn(root, c.two_eps);
  return __fmul_rn(sign_of(x), __fadd_rn(__fmul_rn(ratio, ratio), -1.0f));
}

// done as the plain version sees it once cast to f32: 0 or 1 for bool.
__device__ __forceinline__ float done_value(float d) { return d; }
__device__ __forceinline__ float done_value(uint8_t d) {
  return d ? 1.0f : 0.0f;
}

__device__ __forceinline__ void copy_async(float* dst, const float* src) {
  __pipeline_memcpy_async(dst, src, sizeof(float));
}

template <typename DoneT>
__global__ void nstep_forward_kernel(
    const float* __restrict__ tq,
    const float* __restrict__ rewards,
    const DoneT* __restrict__ done,
    const float* __restrict__ replay_q,
    float* __restrict__ targets,
    float* __restrict__ priorities,
    int T, int B, int n_steps,
    float gamma, double gamma_d,
    float eta, float one_minus_eta,
    Rescaling c, Plan plan) {
  extern __shared__ float smem[];
  const Layout lay = layout_of(plan);
  float* r_s = smem + lay.r;
  float* d_s = smem + lay.d;
  float* tq_s = smem + lay.tq;
  float* q_s = smem + lay.q;
  float* gamma_pow_s = smem + lay.gamma_pow;
  float* q_last_s = smem + lay.q_last;

  const int x = threadIdx.x;
  const int y = threadIdx.y;
  const int tid = y * kTile + x;
  const int col0 = blockIdx.x * kTile;
  const int b = col0 + x;
  const int rows_out = T - 1;

  float max_td = 0.0f;
  float sum_td = 0.0f;
  for (int t0 = 0; t0 < rows_out; t0 += plan.chunk) {
    const int rc = min(plan.chunk, rows_out - t0);   // output rows t0 + w
    const int wc = min(plan.window, rows_out - t0);  // r, d rows t0 + 1 + w

    // Stage the chunk: every copy and load is issued before any is waited
    // on. Bool done bytes go through registers (cp.async moves 4 bytes at
    // least), all loaded before the first is stored.
    constexpr bool kDoneIsF32 = std::is_same<DoneT, float>::value;
    [[maybe_unused]] DoneT done_held[kWindowPerThread];
#pragma unroll
    for (int k = 0; k < kWindowPerThread; ++k) {
      const int e = tid + k * kThreads;
      if (e < wc * kTile) {
        const int bb = col0 + e % kTile;
        if (bb < B) {
          const size_t g = static_cast<size_t>(t0 + 1 + e / kTile) * B + bb;
          copy_async(r_s + e, rewards + g);
          if constexpr (kDoneIsF32) {
            copy_async(d_s + e, done + g);
          } else {
            done_held[k] = done[g];
          }
        } else {
          r_s[e] = 0.0f;
          d_s[e] = 0.0f;
        }
      }
    }
    for (int e = tid; e < rc * kTile; e += kThreads) {
      const int bb = col0 + e % kTile;
      const int t = t0 + e / kTile;
      if (bb < B) {
        copy_async(q_s + e, replay_q + static_cast<size_t>(t) * B + bb);
        if (t + n_steps <= rows_out) {  // Q^[t+1+n] = h^-1(tq[t+n])
          copy_async(tq_s + e,
                     tq + static_cast<size_t>(t + n_steps) * B + bb);
        }
      } else {
        q_s[e] = 0.0f;
        tq_s[e] = 0.0f;
      }
    }
    if (t0 == 0 && tid < kTile) {
      if (col0 + tid < B) {
        copy_async(q_last_s + tid,
                   tq + static_cast<size_t>(rows_out) * B + col0 + tid);
      } else {
        q_last_s[tid] = 0.0f;
      }
    }
    __pipeline_commit();
    if constexpr (!kDoneIsF32) {
#pragma unroll
      for (int k = 0; k < kWindowPerThread; ++k) {
        const int e = tid + k * kThreads;
        if (e < wc * kTile && col0 + e % kTile < B) {
          d_s[e] = done_value(done_held[k]);
        }
      }
    }
    // gamma^k of the tail rows, in double and rounded to f32, as the plain
    // version takes it, while the copies are in flight.
    for (int w = tid; w < rc; w += kThreads) {
      const int k = t0 + w + 1 + n_steps - T;
      if (k >= 1) {
        gamma_pow_s[w] =
            static_cast<float>(pow(gamma_d, static_cast<double>(k)));
      }
    }
    __pipeline_wait_prior(0);
    __syncthreads();

    if (b < B) {
      for (int w = y; w < rc; w += kRowThreads) {
        const int t = t0 + w;
        const int i = t + 1;  // the target of row t is bt[t+1]
        float acc;
        if (i + n_steps <= T) {
          acc = unrescale(tq_s[w * kTile + x], c);
        } else {
          acc = __fdiv_rn(unrescale(q_last_s[x], c), gamma_pow_s[w]);
        }
        for (int j = n_steps - 1; j >= 0; --j) {
          const int row = i + j;
          float r = 0.0f;
          float not_done = 1.0f;
          if (row < T) {
            const int wr = row - (t0 + 1);
            float d;
            if (wr < wc) {
              r = r_s[wr * kTile + x];
              d = d_s[wr * kTile + x];
            } else {  // past the staged halo: n - 1 > kMaxHalo
              const size_t k = static_cast<size_t>(row) * B + b;
              r = rewards[k];
              d = done_value(done[k]);
            }
            not_done = __fadd_rn(1.0f, -d);
          }
          acc = __fadd_rn(r, __fmul_rn(__fmul_rn(gamma, not_done), acc));
        }
        const float target = rescale(acc, c);
        targets[static_cast<size_t>(t) * B + b] = target;
        const float td = fabsf(__fadd_rn(target, -q_s[w * kTile + x]));
        max_td = fmaxf(max_td, td);
        sum_td = __fadd_rn(sum_td, td);
      }
    }
    __syncthreads();  // the next chunk overwrites the tile
  }

  // The priority: combine the row threads of each column. Lanes l and
  // l ^ off with off a multiple of kTile hold the same column.
  for (int off = kTile; off < 32; off <<= 1) {
    max_td = fmaxf(max_td, __shfl_xor_sync(0xffffffffu, max_td, off));
    sum_td = __fadd_rn(sum_td, __shfl_xor_sync(0xffffffffu, sum_td, off));
  }
  float* red_max_s = smem + lay.red_max;
  float* red_sum_s = smem + lay.red_sum;
  const int lane = tid % 32;
  const int warp = tid / 32;
  if (lane < kTile) {
    red_max_s[warp * kTile + lane] = max_td;
    red_sum_s[warp * kTile + lane] = sum_td;
  }
  __syncthreads();
  if (tid < kTile && col0 + tid < B) {
    float m = red_max_s[tid];
    float s = red_sum_s[tid];
    for (int k = 1; k < kWarps; ++k) {
      m = fmaxf(m, red_max_s[k * kTile + tid]);
      s = __fadd_rn(s, red_sum_s[k * kTile + tid]);
    }
    const float mean_td = __fdiv_rn(s, static_cast<float>(rows_out));
    priorities[col0 + tid] =
        __fadd_rn(__fmul_rn(eta, m), __fmul_rn(one_minus_eta, mean_td));
  }
}

template <typename DoneT>
int launch(const void* tq, const void* rewards, const void* done,
           const void* replay_q, void* targets, void* priorities,
           int T, int B, int n_steps, double gamma, double eta,
           const Rescaling& c, const Plan& plan, int smem_bytes,
           cudaStream_t stream) {
  const dim3 grid((B + kTile - 1) / kTile);
  const dim3 block(kTile, kRowThreads);
  nstep_forward_kernel<DoneT><<<grid, block, smem_bytes, stream>>>(
      static_cast<const float*>(tq),
      static_cast<const float*>(rewards),
      static_cast<const DoneT*>(done),
      static_cast<const float*>(replay_q),
      static_cast<float*>(targets),
      static_cast<float*>(priorities),
      T, B, n_steps,
      static_cast<float>(gamma), gamma,
      static_cast<float>(eta), static_cast<float>(1.0 - eta), c, plan);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches on `stream` (PyTorch's current stream) and returns
// cudaGetLastError() as an int, 0 on success. Pointers are device pointers
// to contiguous arrays: f32 [T, B] tq, rewards and replay_q, [T, B] done
// (bool bytes where done_is_bool, else f32), f32 [T-1, B] targets and [B]
// priorities. chunk and window are the wrapper's launch plan; a plan past
// the kernel's maxima, T < 2, B < 1 or n_steps < 1 returns
// cudaErrorInvalidValue and launches nothing.
extern "C" int seed_rl_nstep_forward(
    const void* tq, const void* rewards, const void* done,
    const void* replay_q, void* targets, void* priorities,
    int T, int B, int n_steps, double gamma, double eta, double eps,
    int done_is_bool, int chunk, int window, void* stream) {
  const Plan plan{chunk, window};
  const int smem_bytes = smem_bytes_of(plan);
  if (T < 2 || B < 1 || n_steps < 1 || smem_bytes < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Rescaling c{static_cast<float>(eps), static_cast<float>(4.0 * eps),
                    static_cast<float>(2.0 * eps)};
  const auto s = static_cast<cudaStream_t>(stream);
  if (done_is_bool) {
    return launch<uint8_t>(tq, rewards, done, replay_q, targets, priorities,
                           T, B, n_steps, gamma, eta, c, plan, smem_bytes, s);
  }
  return launch<float>(tq, rewards, done, replay_q, targets, priorities,
                       T, B, n_steps, gamma, eta, c, plan, smem_bytes, s);
}

// The launch seed_rl_nstep_forward makes for B columns under a plan: its
// blocks, threads per block and shared memory per block in bytes. Returns
// 0, or cudaErrorInvalidValue for B < 1 or a plan past the kernel's maxima.
extern "C" int seed_rl_nstep_launch_shape(int B, int chunk, int window,
                                          int* blocks, int* threads,
                                          int* smem_bytes) {
  const int bytes = smem_bytes_of(Plan{chunk, window});
  if (B < 1 || bytes < 0) return static_cast<int>(cudaErrorInvalidValue);
  *blocks = (B + kTile - 1) / kTile;
  *threads = kThreads;
  *smem_bytes = bytes;
  return 0;
}
