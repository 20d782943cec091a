"""``cudnn_conv_roofline`` and ``torso_conv_pool_fwd_ms``, which tell the
convs' and the torso's kernels by name, read from hand-built traces
(``harness/trace.py``): kernel names as an H100 trace of the cells gives
them, launched from ATen ops or from a CUDA graph's replay."""

import types

import pytest
from torch.autograd import DeviceType

from perfbench.harness import cell as cells
from perfbench.harness import trace as traces

US = 1000.0  # a ms in the profiler's µs

FPROP = ("sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc_"
         "tilesize64x64x64_warpgroupsize1x1x1_g1_execute_segment_k_off_kernel")
DIRECT = ("void convolve_common_engine_float_NHWC<__nv_bfloat16, "
          "__nv_bfloat16, 128, 5, 5, 3, 3, 3, true, false, false, false>")
TO_NCHW = ("void cudnn::engines_precompiled::nhwcToNchwKernel<__nv_bfloat16, "
           "float, float, true, false, (cudnnKernelDataType_t)0>")
POOL = ("void at::native::(anonymous namespace)::max_pool_forward_nhwc"
        "<c10::BFloat16, int>(c10::BFloat16 const*, int, int)")
WGRAD = ("sm80_xmma_wgrad_implicit_gemm_indexed_bf16bf16_bf16f32_f32_"
         "nhwckrsc_nhwc_tilesize64x32x64_stage5_warpsize2x2x1_g1_tensor16x8x16")
DGRAD = ("sm80_xmma_dgrad_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc_"
         "tilesize256x32x32_stage4_warpsize4x1x1_g1_tensor16x8x16")
CUTLASS = ("_ZN17cutlass__5x_cudnn6KernelINS_4conv6kernel23ImplicitGemm"
           "ConvolutionINS1_11threadblock22ImplicitGemmMultistage")
PADDING = ("void nhwcAddPaddingKernel<__nv_bfloat16, __nv_bfloat16, float, "
           "true, (cudnnKernelDataType_t)0>(int, int, int, int)")
POOL_BACK = ("void at::native::(anonymous namespace)::max_pool_backward_nhwc"
             "<c10::BFloat16, int>(c10::BFloat16 const*, int)")
BIAS_ADD = ("void at::native::elementwise_kernel<128, 4, at::native::"
            "gpu_kernel_impl_nocast<at::native::CUDAFunctor_add<c10::"
            "BFloat16> >(at::TensorIteratorBase&)>")
RELU = ("void at::native::vectorized_elementwise_kernel<8, at::native::"
        "(anonymous namespace)::launch_clamp_scalar(at::TensorIteratorBase&)>")
GEMMS = ("nvjet_tst_64x32_64x16_4x1_v_bz_splitK_bias_TNT",
         "void cublasLt::splitKreduce_kernel<32, 16, int, float, "
         "__nv_bfloat16, float, __nv_bfloat16, false>",
         "sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64")
FORWARD = (FPROP, DIRECT, TO_NCHW, POOL)
CONVS = (FPROP, DIRECT, TO_NCHW, WGRAD, DGRAD, CUTLASS, PADDING)


def _event(name, device, start, ms):
    return types.SimpleNamespace(
        name=name, device_type=device,
        time_range=types.SimpleNamespace(start=start, end=start + ms * US))


def _profile(events, conv_ops_ms=0.0):
    rows = [types.SimpleNamespace(key="aten::convolution",
                                  device_time_total=conv_ops_ms * US)]
    return types.SimpleNamespace(events=lambda: events,
                                 key_averages=lambda: rows)


def _read(kernels, steps=2, in_graph=False, conv_bound_s=0.001):
    """The two readings, and ``conv_roofline``'s, of a trace of ``steps``
    steps whose device ran ``kernels`` (name, ms), each 1 ms apart;
    ``in_graph``: launched by a graph's replay, so the host's trace holds no
    convolution op."""
    device = [_event(name, DeviceType.CUDA, 1000 * US * k, ms)
              for k, (name, ms) in enumerate(kernels)]
    window = _event(traces.WINDOW, DeviceType.CPU, 0, 1000 * len(kernels))
    conv_ops_ms = 0.0 if in_graph else sum(
        ms for name, ms in kernels if name in CONVS)
    reading = traces.read(_profile(device), _profile(
        [window] + device, conv_ops_ms), steps)
    run = types.SimpleNamespace(trace=reading, cell=types.SimpleNamespace(
        conv_seconds_per_step=conv_bound_s))
    return {name: cells.module("layer_metrics", name).read(run)
            for name in ("cudnn_conv_roofline", "torso_conv_pool_fwd_ms",
                         "conv_roofline")}


KERNELS = [(FPROP, 4.0), (DIRECT, 2.0), (TO_NCHW, 1.0), (POOL, 3.0),
           (WGRAD, 1.5), (DGRAD, 0.5), (CUTLASS, 0.6), (PADDING, 0.4),
           (POOL_BACK, 5.0), (BIAS_ADD, 2.5), (RELU, 1.0),
           *((name, 7.0) for name in GEMMS)]


def test_counts_cudnns_kernels_and_the_torsos_forward_by_name():
    got = _read(KERNELS, steps=2, conv_bound_s=0.001)
    conv_ms = 4.0 + 2.0 + 1.0 + 1.5 + 0.5 + 0.6 + 0.4
    assert got["cudnn_conv_roofline"] == pytest.approx(
        100.0 * 0.001 * 2 / (conv_ms / 1e3))
    # Forward convs, cuDNN's layout transform and the pool's forward, a step.
    assert got["torso_conv_pool_fwd_ms"] == pytest.approx(
        (4.0 + 2.0 + 1.0 + 3.0) / 2)


@pytest.mark.parametrize("in_graph", [False, True], ids=["ops", "graph"])
def test_a_graphs_kernels_count_as_an_ops_do(in_graph):
    eager = _read(KERNELS)
    got = _read(KERNELS, in_graph=in_graph)
    assert got["cudnn_conv_roofline"] == eager["cudnn_conv_roofline"]
    assert got["torso_conv_pool_fwd_ms"] == eager["torso_conv_pool_fwd_ms"]
    # The op-based reading loses the graph's convs.
    assert (got["conv_roofline"] is None) == in_graph


def test_none_where_no_such_kernel_ran():
    got = _read([(BIAS_ADD, 1.0), (RELU, 1.0), *((n, 1.0) for n in GEMMS)])
    assert got["cudnn_conv_roofline"] is None
    assert got["torso_conv_pool_fwd_ms"] is None
    run = types.SimpleNamespace(trace=None, cell=None)
    for name in ("cudnn_conv_roofline", "torso_conv_pool_fwd_ms"):
        assert cells.module("layer_metrics", name).read(run) is None
