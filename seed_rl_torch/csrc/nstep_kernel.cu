// Fused n-step Bellman targets and replay priorities for NVIDIA Hopper
// (sm_90a).
//
// Replaces the TPU kernel seed_rl_tpu/ops/pallas/nstep_kernel.py:36
// (_nstep_kernel, launched by _targets_and_priorities_pallas under
// td_loss_and_priorities). It computes what that kernel computes, per batch
// column b of the time-major [T, B] inputs (tq: target-net Q at the online
// argmax, still h-rescaled; r: rewards; d: done as 0/1; q: online Q at the
// replayed action):
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
// them into FMAs), so the result agrees with the plain PyTorch version to a
// few ulps. Division and sqrtf are IEEE (no --use_fast_math).
//
// Bound on an H100 SXM at its 700 W power limit (data sheet: 3.35 TB/s of
// HBM bandwidth): the op reads 4*T*B*4 bytes and writes (T-1)*B*4 + B*4,
// i.e. 20*T*B bytes; its ~40 flops per element are negligible. At the two
// shapes of the R2D2 path that is ~104 KB (~0.03 us) for the loss at
// [T, B] = [81, 64] and ~0.99 MB (~0.3 us) at insert, [81, 610]. In practice
// it is bound by the launch and by the latency of the serial walk over T,
// not by bytes: 64 or 610 columns fill one to five blocks of a 132-SM card.
//
// Design against that bound: one thread per column walks t forward once,
// writes target[t] as it goes and keeps the running max and sum of |TD| in
// registers, so the priority needs no second pass and nothing intermediate
// touches memory. The arrays are time-major, so the 32 threads of a warp
// read 32 neighbouring floats of one row: every load and store is
// coalesced. Each output row re-reads n rows of r and d; after the first
// touch those reads hit L1, so device memory sees each input once. Blocks of
// 128 threads cover ceil(B/128) blocks and the tail b >= B is masked, so any
// B works (the TPU kernel tiled B by 128 or ran one program).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

struct Rescaling {
  float eps;        // eps
  float four_eps;   // 4*eps, rounded from double as the plain version does
  float two_eps;    // 2*eps, likewise
};

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

__global__ void nstep_forward_kernel(
    const float* __restrict__ tq,
    const float* __restrict__ rewards,
    const float* __restrict__ done,
    const float* __restrict__ replay_q,
    float* __restrict__ targets,
    float* __restrict__ priorities,
    int T, int B, int n_steps,
    float gamma, double gamma_d,
    float eta, float one_minus_eta,
    Rescaling c) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;

  // Q^ past the end of the sequence: h^-1(tq[T-1]) / gamma^k, gamma^k taken
  // in double and rounded to f32, as the plain version does.
  const float q_last =
      unrescale(tq[static_cast<size_t>(T - 1) * B + b], c);

  float max_td = 0.0f;
  float sum_td = 0.0f;
  for (int t = 0; t < T - 1; ++t) {
    const int i = t + 1;  // the target of row t is bt[t+1]
    const int s = i + n_steps;
    float acc;
    if (s <= T) {
      acc = unrescale(tq[static_cast<size_t>(s - 1) * B + b], c);
    } else {
      const float gamma_k =
          static_cast<float>(pow(gamma_d, static_cast<double>(s - T)));
      acc = __fdiv_rn(q_last, gamma_k);
    }
    for (int j = n_steps - 1; j >= 0; --j) {
      const int row = i + j;
      float r = 0.0f;
      float not_done = 1.0f;
      if (row < T) {
        const size_t k = static_cast<size_t>(row) * B + b;
        r = rewards[k];
        not_done = __fadd_rn(1.0f, -done[k]);
      }
      acc = __fadd_rn(r, __fmul_rn(__fmul_rn(gamma, not_done), acc));
    }
    const size_t out = static_cast<size_t>(t) * B + b;
    const float target = rescale(acc, c);
    targets[out] = target;
    const float td = fabsf(__fadd_rn(target, -replay_q[out]));
    max_td = fmaxf(max_td, td);
    sum_td = __fadd_rn(sum_td, td);
  }
  const float mean_td = __fdiv_rn(sum_td, static_cast<float>(T - 1));
  priorities[b] =
      __fadd_rn(__fmul_rn(eta, max_td), __fmul_rn(one_minus_eta, mean_td));
}

}  // namespace

// Launches on `stream` (PyTorch's current stream) and returns
// cudaGetLastError() as an int, 0 on success. Pointers are device pointers
// to contiguous f32 arrays: four [T, B] inputs, [T-1, B] targets and [B]
// priorities. Needs T >= 2 and n_steps >= 1 (the wrapper checks both).
extern "C" int seed_rl_nstep_forward(
    const void* tq, const void* rewards, const void* done,
    const void* replay_q, void* targets, void* priorities,
    int T, int B, int n_steps, double gamma, double eta, double eps,
    void* stream) {
  const int blocks = (B + kThreads - 1) / kThreads;
  const Rescaling c{static_cast<float>(eps), static_cast<float>(4.0 * eps),
                    static_cast<float>(2.0 * eps)};
  nstep_forward_kernel<<<blocks, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(tq),
      static_cast<const float*>(rewards),
      static_cast<const float*>(done),
      static_cast<const float*>(replay_q),
      static_cast<float*>(targets),
      static_cast<float*>(priorities),
      T, B, n_steps,
      static_cast<float>(gamma), gamma,
      static_cast<float>(eta), static_cast<float>(1.0 - eta), c);
  return static_cast<int>(cudaGetLastError());
}
