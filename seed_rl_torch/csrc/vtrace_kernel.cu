// Fused V-trace forward for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel seed_rl_tpu/ops/pallas/vtrace_kernel.py:29
// (_vtrace_kernel, launched by from_importance_weights_pallas). It computes
// what that kernel computes, per batch column b of the time-major [T, B]
// inputs:
//   rho_t    = exp(target_logp_t - behaviour_logp_t)
//   delta_t  = min(rho_bar, rho_t) * (r_t + gamma_t * V_{t+1} - V_t)
//   acc_t    = delta_t + gamma_t * (lambda * min(1, rho_t)) * acc_{t+1}
//   vs_t     = acc_t + V_t
//   pg_adv_t = min(rho_bar_pg, rho_t) * (r_t + gamma_t * vs_{t+1} - V_t)
// with V_T = vs_T = bootstrap. Either clip may be off (the flags below).
// expf (not __expf) and the expressions above, written as in the plain
// version, keep the result within 1e-5 of it.
//
// What bounds it on an H100 SXM (700 W; data sheet: 3.35 TB/s of HBM): the
// op reads (5T+1)*B*4 bytes and writes 2*T*B*4, 0.92 MB or ~0.28 us at the
// main path's T = 32, B = 1024; its ~18 flops per element are negligible,
// and it holds no matrix product, so tensor cores and wgmma have no role.
// What it cannot go below at this size is a launch plus one dependent round
// trip to memory (load, compute, store), far above the byte bound. Only
// acc_t is truly serial; rho, the clips, delta_t, the decay gamma_t * c_t
// and, once vs is known, pg_adv_t are elementwise over (t, b).
//
// Design against that: one block takes kTile = 32 columns (one warp wide,
// so every row of a tile is one 128-byte line) and walks T in chunks of at
// most kMaxChunk rows, from the last chunk to the first.
//   - Staging. The five inputs of a chunk are copied into shared memory by
//     cp.async, every copy issued before any is waited on. While a chunk is
//     computed, the copies of the one before it are in flight into a second
//     buffer. No TMA: a tensor map needs a row stride that is a multiple of
//     16 bytes, and an odd B gives none.
//   - Phase 1, parallel over (t, b): kRowThreads = 8 threads per column
//     take the chunk's rows in turn and turn each element's inputs into
//     delta_t, the decay a_t = gamma_t * c_t and the clipped pg rho, in
//     shared memory. V_{t+1} of the chunk's last row is carried from the
//     chunk after it (the bootstrap for the last).
//   - Phase 2, one thread per column: acc_t = delta_t + a_t * acc_{t+1} and
//     vs_t = acc_t + V_t, t descending, from shared memory loaded a batch of
//     kBatch rows ahead of the chain: two operations per step.
//   - Phase 3, parallel over (t, b): pg_adv_t from vs_{t+1}; vs and pg_adv
//     are written a row of 32 columns at a time (coalesced).
//   acc, V and vs of a chunk's first row carry to the chunk before it.
// The wrapper's launch_plan picks R = min(T, kMaxChunk) rows per chunk and
// buffers = 1 where T <= R, else 2; the entry point below takes the block
// shape from the constants and the shared memory from smem_floats:
//   4 * kTile * (R * (5 * buffers + 1) + 2) bytes,
// i.e. 24,832 B at T = 32 and at most 45,312 B for any T (asserted at
// compile time): below the 48 KB a launch takes without opting in.
// Blocks = ceil(B / 32): 32 at B = 1024.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 32;        // columns per block (blockDim.x)
constexpr int kRowThreads = 8;   // threads per column (blockDim.y)
constexpr int kThreads = kTile * kRowThreads;
constexpr int kMaxChunk = 32;    // rows per chunk, at most
constexpr int kInputs = 5;       // target, behaviour, discount, reward, value
constexpr int kBatch = 8;        // phase-2 rows loaded ahead of the chain
// Shared memory a launch takes without opting in to more; the largest
// chunk, double-buffered, stays below it.
constexpr int kDefaultSmemBytes = 48 * 1024;

// The chunking the wrapper picks (launch_plan in ops/cuda/vtrace_kernel.py).
struct Plan {
  int chunk;    // rows per chunk
  int buffers;  // staging buffers: 2 where T spans several chunks
};

__host__ __device__ constexpr int smem_floats(const Plan& p) {
  return kTile * (p.chunk * (kInputs * p.buffers + 1) + 2);
}
static_assert(smem_floats(Plan{kMaxChunk, 2}) * sizeof(float) <=
                  kDefaultSmemBytes,
              "the largest plan launches without opting in to more");

// Shared memory of a plan for T rows in bytes, or -1 for a plan this kernel
// was not built for (a chunk past its maximum, one buffer for several
// chunks).
int smem_bytes_of(const Plan& p, int T) {
  if (p.chunk < 1 || p.chunk > kMaxChunk ||
      p.buffers < (T > p.chunk ? 2 : 1) || p.buffers > 2) {
    return -1;
  }
  return smem_floats(p) * static_cast<int>(sizeof(float));
}

__device__ __forceinline__ void copy_async(float* dst, const float* src) {
  __pipeline_memcpy_async(dst, src, sizeof(float));
}

struct Inputs {
  const float* target_logp;
  const float* behaviour_logp;
  const float* discounts;
  const float* rewards;
  const float* values;
};

// Issues the copies of rows [r0, r0 + rows) of the five inputs into
// `buffer` (kInputs planes of `plane` floats) and commits them as one group.
__device__ __forceinline__ void stage_chunk(float* buffer, int plane,
                                            const Inputs& in, int r0,
                                            int rows, int B, int col0,
                                            int tid) {
  for (int e = tid; e < rows * kTile; e += kThreads) {
    const int bb = col0 + e % kTile;
    if (bb < B) {
      const size_t g = static_cast<size_t>(r0 + e / kTile) * B + bb;
      copy_async(buffer + e, in.target_logp + g);
      copy_async(buffer + plane + e, in.behaviour_logp + g);
      copy_async(buffer + 2 * plane + e, in.discounts + g);
      copy_async(buffer + 3 * plane + e, in.rewards + g);
      copy_async(buffer + 4 * plane + e, in.values + g);
    } else {
#pragma unroll
      for (int k = 0; k < kInputs; ++k) buffer[k * plane + e] = 0.0f;
    }
  }
  __pipeline_commit();
}

__global__ void vtrace_forward_kernel(
    Inputs in,
    const float* __restrict__ bootstrap,
    float* __restrict__ vs_out,
    float* __restrict__ pg_adv_out,
    int T, int B,
    int clip_rho, float clip_rho_threshold,
    int clip_pg_rho, float clip_pg_rho_threshold,
    float lambda, Plan plan) {
  extern __shared__ float smem[];
  const int plane = plan.chunk * kTile;  // one input's rows in one buffer
  float* pg_rho_s = smem + plan.buffers * kInputs * plane;
  float* v_carry_s = pg_rho_s + plane;     // V of the next chunk's first row
  float* vs_carry_s = v_carry_s + kTile;   // vs of the same

  const int x = threadIdx.x;
  const int y = threadIdx.y;
  const int tid = y * kTile + x;
  const int col0 = blockIdx.x * kTile;
  const int b = col0 + x;
  const int chunks = (T + plan.chunk - 1) / plan.chunk;

  stage_chunk(smem, plane, in, (chunks - 1) * plan.chunk,
              T - (chunks - 1) * plan.chunk, B, col0, tid);
  if (y == 0) {
    const float boot = b < B ? bootstrap[b] : 0.0f;
    v_carry_s[x] = boot;
    vs_carry_s[x] = boot;
  }

  float acc = 0.0f;  // vs_{t+1} - V_{t+1}, kept by the phase-2 thread
  for (int c = chunks - 1, it = 0; c >= 0; --c, ++it) {
    float* buf = smem + (it & 1) * kInputs * plane;
    __pipeline_wait_prior(0);
    __syncthreads();  // the chunk's inputs and the carries are in place
    if (c > 0) {  // the chunk before this one, while this one is computed
      stage_chunk(smem + ((it + 1) & 1) * kInputs * plane, plane, in,
                  (c - 1) * plan.chunk, plan.chunk, B, col0, tid);
    }
    const int r0 = c * plan.chunk;
    const int rc = min(plan.chunk, T - r0);
    float* delta_s = buf;              // target_logp, then delta, then vs
    float* decay_s = buf + plane;      // behaviour_logp, then gamma_t * c_t
    const float* discount_s = buf + 2 * plane;
    const float* reward_s = buf + 3 * plane;
    const float* value_s = buf + 4 * plane;

    // Phase 1: everything elementwise before the chain.
    for (int w = y; w < rc; w += kRowThreads) {
      const int e = w * kTile + x;
      const float rho = expf(delta_s[e] - decay_s[e]);
      const float clipped_rho =
          clip_rho ? fminf(clip_rho_threshold, rho) : rho;
      pg_rho_s[e] = clip_pg_rho ? fminf(clip_pg_rho_threshold, rho) : rho;
      const float cc = lambda * fminf(1.0f, rho);
      const float discount = discount_s[e];
      const float value = value_s[e];
      const float v_next = w + 1 < rc ? value_s[e + kTile] : v_carry_s[x];
      delta_s[e] = clipped_rho * (reward_s[e] + discount * v_next - value);
      decay_s[e] = discount * cc;
    }
    __syncthreads();

    // Phase 2: the serial chain, one thread per column.
    if (y == 0) {
      for (int top = rc - 1; top >= 0; top -= kBatch) {
        float delta[kBatch], decay[kBatch], value[kBatch];
#pragma unroll
        for (int k = 0; k < kBatch; ++k) {
          const int e = (top - k) * kTile + x;
          if (top - k >= 0) {
            delta[k] = delta_s[e];
            decay[k] = decay_s[e];
            value[k] = value_s[e];
          }
        }
#pragma unroll
        for (int k = 0; k < kBatch; ++k) {
          if (top - k >= 0) {
            acc = delta[k] + decay[k] * acc;
            delta_s[(top - k) * kTile + x] = acc + value[k];  // vs
          }
        }
      }
    }
    __syncthreads();

    // Phase 3: pg_adv from vs_{t+1}; both outputs written.
    for (int w = y; w < rc; w += kRowThreads) {
      const int e = w * kTile + x;
      const float vs = delta_s[e];
      const float vs_next = w + 1 < rc ? delta_s[e + kTile] : vs_carry_s[x];
      if (b < B) {
        const size_t g = static_cast<size_t>(r0 + w) * B + b;
        vs_out[g] = vs;
        pg_adv_out[g] = pg_rho_s[e] *
                        (reward_s[e] + discount_s[e] * vs_next - value_s[e]);
      }
    }
    if (c > 0) {
      __syncthreads();  // every read of the carries is done
      if (y == 0) {
        v_carry_s[x] = value_s[x];
        vs_carry_s[x] = delta_s[x];
      }
    }
  }
}

__global__ void launch_floor_kernel() {}

}  // namespace

// Launches on `stream` (PyTorch's current stream) and returns
// cudaGetLastError() as an int, 0 on success. Pointers are device pointers
// to contiguous f32 arrays: five [T, B], bootstrap [B], two [T, B] outputs.
// chunk and buffers are the wrapper's launch plan; a plan this kernel was
// not built for, T < 1 or B < 1 returns cudaErrorInvalidValue and launches
// nothing.
extern "C" int seed_rl_vtrace_forward(
    const void* target_logp, const void* behaviour_logp,
    const void* discounts, const void* rewards, const void* values,
    const void* bootstrap, void* vs_out, void* pg_adv_out,
    int T, int B,
    int clip_rho, float clip_rho_threshold,
    int clip_pg_rho, float clip_pg_rho_threshold,
    float lambda, int chunk, int buffers, void* stream) {
  const Plan plan{chunk, buffers};
  const int smem_bytes = smem_bytes_of(plan, T);
  if (T < 1 || B < 1 || smem_bytes < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Inputs in{static_cast<const float*>(target_logp),
                  static_cast<const float*>(behaviour_logp),
                  static_cast<const float*>(discounts),
                  static_cast<const float*>(rewards),
                  static_cast<const float*>(values)};
  vtrace_forward_kernel<<<(B + kTile - 1) / kTile, dim3(kTile, kRowThreads),
                          smem_bytes, static_cast<cudaStream_t>(stream)>>>(
      in, static_cast<const float*>(bootstrap),
      static_cast<float*>(vs_out), static_cast<float*>(pg_adv_out),
      T, B, clip_rho, clip_rho_threshold, clip_pg_rho, clip_pg_rho_threshold,
      lambda, plan);
  return static_cast<int>(cudaGetLastError());
}

// The launch seed_rl_vtrace_forward makes for [T, B] under a plan: its
// blocks, threads per block and shared memory per block in bytes. Returns
// 0, or cudaErrorInvalidValue for T < 1, B < 1 or a plan it refuses.
extern "C" int seed_rl_vtrace_launch_shape(int T, int B, int chunk,
                                           int buffers, int* blocks,
                                           int* threads, int* smem_bytes) {
  const int bytes = smem_bytes_of(Plan{chunk, buffers}, T);
  if (T < 1 || B < 1 || bytes < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  *blocks = (B + kTile - 1) / kTile;
  *threads = kThreads;
  *smem_bytes = bytes;
  return 0;
}

// Launches one empty kernel (one block of 32 threads) on `stream`: the
// least any launch costs on the card, the floor under every kernel's time.
extern "C" int seed_rl_launch_floor(void* stream) {
  launch_floor_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
