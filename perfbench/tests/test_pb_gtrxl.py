"""The ``gtrxl_dmlab`` configuration on the CPU at a tiny size: the plain
reference's names against the net's, a sound run correct and each fault
and the control not, the frozen counts against a brute-force count, and
the core's readers on hand-built trace events."""

import io
import json
import types

import pytest
import torch
from torch.autograd import DeviceType

from perfbench.counts import gtrxl
from perfbench.harness import cell as cells
from perfbench.harness import runner
from perfbench.harness import trace as traces
from perfbench.reference import common
from perfbench.tests.conftest import ROOT, tiny_checkout

CELL = "gtrxl_dmlab.envs512_t32"
# Episodes of 11 steps, a memory of 8 (a ring of 9) and 20 acting steps
# before the checked unrolls of 5: the ring has wrapped, and the episode
# boundary at step 22 falls inside the first checked unroll.
TINY_NET = {"frame_shape": [12, 16, 3], "num_layers": 2, "model_size": 16,
            "num_heads": 2, "head_size": 8, "memory_length": 8,
            "mlp_size": 32}


def tiny(tmp_path, float32=True):
    root = tiny_checkout(tmp_path, float32=float32)
    path = root / "perfbench" / "configs" / "gtrxl_dmlab.json"
    config = json.loads(path.read_text())
    config["env"].update(frame_shape=[12, 16], episode_length=11)
    config["net"].update(TINY_NET)
    config["acting_steps"] = 20
    path.write_text(json.dumps(config))
    (root / "perfbench" / "traffic" / "envs512_t32.json").write_text(
        json.dumps({"num_envs": 3, "unroll_length": 5, "profile_steps": 2}))
    return root


def run(root, fault=None, trace=0):
    bench = cells.benchmark(root)
    config = cells.config(bench, "gtrxl_dmlab", root)
    plant = (cells.module("builders", config["builder"], root).FAULTS[fault]
             if fault else None)
    out, err = io.StringIO(), io.StringIO()
    args = types.SimpleNamespace(workload=CELL, seed=2**31 + 77, seconds=0.2,
                                 trace=trace)
    assert runner.run(args, 0.0, device=torch.device("cpu"), plant=plant,
                      root=root, out=out, err=err) == 0
    return json.loads(out.getvalue().splitlines()[-1])


def test_the_reference_names_the_net_s_parameters():
    from seed_rl_torch.models import ImpalaGTrXL

    config = cells.config(cells.benchmark(), "gtrxl_dmlab")
    reference = cells.module("reference", config["reference"])
    net_knobs = dict(config["net"], **TINY_NET)
    net = ImpalaGTrXL(
        net_knobs["num_actions"], tuple(net_knobs["frame_shape"]),
        **{k: net_knobs[k] for k in ("num_layers", "model_size", "num_heads",
                                     "head_size", "memory_length",
                                     "mlp_size", "gate_bias")},
        device="cpu")
    shapes = reference.parameter_shapes(dict(config, net=net_knobs))
    assert list(shapes) == [n for n, _ in net.named_parameters()]
    assert all(tuple(p.shape) == shapes[n]
               for n, p in net.named_parameters())
    # The draw's zeros where the net starts elsewhere.
    drawn = reference.starting_values(
        config, {n: torch.zeros(s) for n, s in shapes.items()})
    assert float(drawn["layers.1.norm2.weight"][0]) == 1.0
    assert float(drawn["layers.0.gate1.bias"][0]) == 2.0
    assert float(drawn["layers.0.mlp1.bias"].abs().sum()) == 0.0


def test_a_sound_run_is_correct_and_reads_the_core(tmp_path):
    line = run(tiny(tmp_path), trace=1)
    assert line["correct"] is True, line["check"]
    assert line["check"]["memory"]["value"] < 1e-5
    # Lockstep 11-step episodes under a window of 9: an episode's queries
    # attend 1, 2, .., 9, 9, 9 keys, 63 of 99.
    fill = line["metrics"]["core_memory_fill"]["value"]
    assert 50.0 < fill < 75.0


@pytest.mark.parametrize("fault", ["frozen", "half_batch", "altered",
                                   "no_reset", "ring_shift"])
def test_a_broken_run_is_not_correct(tmp_path, fault):
    line = run(tiny(tmp_path), fault)
    assert line["correct"] is False, line["check"]


def test_the_cores_faults_fail_their_own_numbers(tmp_path):
    root = tiny(tmp_path)
    assert run(root, "no_reset")["check"]["rollout"]["value"] > 0.01
    assert run(root, "ring_shift")["check"]["memory"]["value"] > 0.1


def test_the_control_is_not_correct(tmp_path):
    root = tiny(tmp_path, float32=False)
    bench = cells.benchmark(root)
    config = cells.config(bench, "gtrxl_dmlab", root)
    traffic = cells.traffic("envs512_t32", root)
    builder = cells.module("builders", config["builder"], root)
    reference = cells.module("reference", config["reference"], root)
    cell = builder.build(config, traffic, 12, torch.device("cpu"), reference)
    _, inputs = builder.check_steps(cell, config["check_steps"])
    followed = reference.follow(config, traffic, inputs, common.Precision(),
                                torch.device("cpu"))
    control = reference.compare(reference.follow(
        config, traffic, inputs, common.Precision.control(config),
        torch.device("cpu")), followed)
    limits = config["limits"]
    assert any(control[n] > limits[n] for n in limits), (control, limits)


def test_mean_keys_by_hand():
    # 1,000-step episodes, memory 512: steps 0..511 attend t + 1 keys, the
    # other 488 attend 513.
    by_hand = (512 * 513 / 2 + 488 * 513) / 1000
    assert gtrxl.mean_keys(512, 1000) == pytest.approx(by_hand)
    assert by_hand / 513 == pytest.approx(0.744, abs=5e-4)


def test_the_counts_against_a_brute_force_count():
    # Count a tiny net's work by hand: each matmul of its forward, 2 FLOPs
    # a multiply-accumulate.
    config = cells.config(cells.benchmark(), "gtrxl_dmlab")
    config = dict(config, net=dict(config["net"], **TINY_NET),
                  env=dict(config["env"], episode_length=11))
    traffic = {"num_envs": 3, "unroll_length": 5}
    d, inner, mlp, layers = 16, 16, 32, 2
    keys = sum(min(t, 8) + 1 for t in range(11)) / 11
    per_layer_row = 2 * (4 * d * inner + 12 * d * d + 2 * d * mlp)
    attention = 3 * 2 * inner * keys
    row = layers * (per_layer_row + attention)
    h, w = 12, 16
    torso = 2 * 9 * (h * w * 3 * 16 + 4 * 6 * 8 * 16 * 16
                     + 6 * 8 * 16 * 32 + 4 * 3 * 4 * 32 * 32
                     + 3 * 4 * 32 * 32 + 4 * 2 * 2 * 32 * 32)
    frame = torso + 2 * (2 * 2 * 32) * 256 + 2 * 266 * d + 2 * d * 9 + 2 * d
    memory_kv = layers * 8 * 2 * 2 * d * inner
    want = 5 * 3 * (frame + row) + 3 * 3 * (6 * (frame + row) + memory_kv)
    assert gtrxl.step_flops(config, traffic) == pytest.approx(want)
    # The bound: acting's memory read once a step (bf16), against its
    # products; the update's products forward and backward.
    acting = max(5 * 3 * layers * 8 * d * 2 / 3.35e12,
                 5 * 3 * layers * attention / 989e12)
    update = 3 * 3 * 6 * layers * attention / 989e12
    assert gtrxl.attention_seconds(config, traffic) == pytest.approx(
        acting + update)


def _event(name, device, start, ms):
    return types.SimpleNamespace(
        name=name, device_type=device,
        time_range=types.SimpleNamespace(start=start, end=start + ms * 1e3))


FORWARD = ("fmha_cutlassF_bf16_aligned_32x128_gmem_sm80(PyTorchMemEff"
           "Attention::AttentionKernel<cutlass::bfloat16_t, cutlass::arch::"
           "Sm80, true, 32, 128, 65536, true, true>")
BACKWARD = ("fmha_cutlassB_bf16_aligned_128x64_k65536_sm80(PyTorchMemEff"
            "Attention::AttentionBackwardKernel<cutlass::arch::Sm80, "
            "cutlass::bfloat16_t, true, false, false, 128, 64, 65536>")
GEMM = "nvjet_tst_64x32_64x16_4x1_v_bz_splitK_bias_TNT"
SOFTMAX = ("void at::native::(anonymous namespace)::cunn_SoftMaxForward<4, "
           "float, float, float, at::native::(anonymous namespace)::"
           "SoftMaxForwardEpilogue>(float*, float const*, int)")


def _reading(kernels, steps):
    device = [_event(name, DeviceType.CUDA, 2e3 * k, ms)
              for k, (name, ms) in enumerate(kernels)]
    window = _event(traces.WINDOW, DeviceType.CPU, 0.0, 2.0 * len(kernels))
    profile = types.SimpleNamespace(events=lambda: device,
                                    key_averages=lambda: [])
    host = types.SimpleNamespace(events=lambda: [window] + device,
                                 key_averages=lambda: [])
    return traces.read(profile, host, steps)


def test_the_attention_readers_on_hand_built_events():
    reading = _reading([(FORWARD, 3.0), (BACKWARD, 5.0), (GEMM, 7.0),
                        (SOFTMAX, 1.0), (FORWARD, 2.0)], steps=2)
    run_ = types.SimpleNamespace(trace=reading, cell=types.SimpleNamespace(
        kernel_seconds_per_step={gtrxl.ATTENTION_KERNELS: 0.002}))
    ms = cells.module("layer_metrics", "core_attention_ms").read(run_)
    assert ms == pytest.approx((3.0 + 5.0 + 2.0) / 2)
    share = cells.module("layer_metrics",
                         "core_attention_roofline").read(run_)
    assert share == pytest.approx(100.0 * 0.002 * 2 / 0.010)


def test_the_attention_readers_find_nothing_elsewhere():
    reading = _reading([(GEMM, 7.0), (SOFTMAX, 1.0)], steps=2)
    run_ = types.SimpleNamespace(trace=reading, cell=types.SimpleNamespace(
        kernel_seconds_per_step={}))
    for name in ("core_attention_ms", "core_attention_roofline"):
        assert cells.module("layer_metrics", name).read(run_) is None
        assert cells.module("layer_metrics", name).read(
            types.SimpleNamespace(trace=None, cell=run_.cell)) is None


def test_the_fill_reader_finds_nothing_without_counters():
    net = types.SimpleNamespace()
    run_ = types.SimpleNamespace(cell=types.SimpleNamespace(
        learner=types.SimpleNamespace(agent=types.SimpleNamespace(net=net)),
        extra={}))
    assert cells.module("layer_metrics", "core_memory_fill").read(
        run_) is None


def test_the_parent_stops_at_once_without_the_net(tmp_path, monkeypatch):
    # A port that lacks ImpalaGTrXL: the builder's first import fails,
    # before anything is allocated.
    import seed_rl_torch.models as models

    monkeypatch.delattr(models, "ImpalaGTrXL")
    root = tiny(tmp_path)
    args = types.SimpleNamespace(workload=CELL, seed=1, seconds=0.1,
                                 trace=0)
    with pytest.raises(ImportError):
        runner.run(args, 0.0, device=torch.device("cpu"), root=root,
                   out=io.StringIO(), err=io.StringIO())
    assert (ROOT / "perfbench" / "builders" / "gtrxl_vtrace.py").exists()
