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
//
// Bound on an H100 SXM at its 700 W power limit (data sheet: 3.35 TB/s of
// HBM bandwidth): the op reads (5T+1)*B*4 bytes and writes
// 2*T*B*4 bytes, about 15 flops per element. At the main path's T=32,
// B=1024 that is 0.92 MB, or about 0.28 us of memory time; its flops are
// negligible. In practice it is bound by the launch and by the latency of
// the serial chain over T, not by bytes.
//
// Design against that bound: one thread per column walks t = T-1 .. 0 once,
// keeping acc, V_{t+1} and vs_{t+1} in registers, so vs_t and pg_adv_t are
// emitted in the same iteration and nothing intermediate touches memory.
// Each input element is read once and each output written once. The arrays
// are time-major, so the 32 threads of a warp read 32 neighbouring floats of
// one row: every load and store is coalesced. Loads of a row do not depend
// on acc, so the unrolled loop lets the compiler issue them ahead of the
// chain. Blocks of 128 threads cover ceil(B/128) blocks and the tail b >= B
// is masked, so any B works (the TPU kernel needed B % 128 == 0).
// expf (not __expf) keeps the result within 1e-5 of the plain version.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

__global__ void vtrace_forward_kernel(
    const float* __restrict__ target_logp,
    const float* __restrict__ behaviour_logp,
    const float* __restrict__ discounts,
    const float* __restrict__ rewards,
    const float* __restrict__ values,
    const float* __restrict__ bootstrap,
    float* __restrict__ vs_out,
    float* __restrict__ pg_adv_out,
    int T, int B,
    int clip_rho, float clip_rho_threshold,
    int clip_pg_rho, float clip_pg_rho_threshold,
    float lambda) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;

  const float boot = bootstrap[b];
  float v_next = boot;   // V_{t+1}
  float vs_next = boot;  // vs_{t+1}
  float acc = 0.0f;      // vs_{t+1} - V_{t+1}
#pragma unroll 4
  for (int t = T - 1; t >= 0; --t) {
    const size_t i = static_cast<size_t>(t) * B + b;
    const float rho = expf(target_logp[i] - behaviour_logp[i]);
    const float clipped_rho = clip_rho ? fminf(clip_rho_threshold, rho) : rho;
    const float clipped_pg_rho =
        clip_pg_rho ? fminf(clip_pg_rho_threshold, rho) : rho;
    const float c = lambda * fminf(1.0f, rho);
    const float discount = discounts[i];
    const float reward = rewards[i];
    const float value = values[i];

    const float delta = clipped_rho * (reward + discount * v_next - value);
    acc = delta + (discount * c) * acc;
    const float vs = acc + value;
    vs_out[i] = vs;
    pg_adv_out[i] = clipped_pg_rho * (reward + discount * vs_next - value);
    v_next = value;
    vs_next = vs;
  }
}

}  // namespace

// Launches on `stream` (PyTorch's current stream) and returns
// cudaGetLastError() as an int, 0 on success. Pointers are device pointers
// to contiguous f32 arrays: five [T, B], bootstrap [B], two [T, B] outputs.
extern "C" int seed_rl_vtrace_forward(
    const void* target_logp, const void* behaviour_logp,
    const void* discounts, const void* rewards, const void* values,
    const void* bootstrap, void* vs_out, void* pg_adv_out,
    int T, int B,
    int clip_rho, float clip_rho_threshold,
    int clip_pg_rho, float clip_pg_rho_threshold,
    float lambda, void* stream) {
  const int blocks = (B + kThreads - 1) / kThreads;
  vtrace_forward_kernel<<<blocks, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(target_logp),
      static_cast<const float*>(behaviour_logp),
      static_cast<const float*>(discounts),
      static_cast<const float*>(rewards),
      static_cast<const float*>(values),
      static_cast<const float*>(bootstrap),
      static_cast<float*>(vs_out),
      static_cast<float*>(pg_adv_out),
      T, B, clip_rho, clip_rho_threshold, clip_pg_rho, clip_pg_rho_threshold,
      lambda);
  return static_cast<int>(cudaGetLastError());
}
