"""The port's measurement tools (``seed_rl_torch/tools/``) on the CPU.

Each tool's ``main`` runs at a tiny size with ``--device=cpu`` and must
print the names and keys of the JAX script it ports (``scripts/<name>.py``,
read from its source with ``ast`` where it prints a JSON line), with every
rate finite and > 0. Beside them:

- ``utils/flops.py::impala_flops_per_frame`` and
  ``impala_hbm_bytes_per_frame`` equal ``scripts/profile_impala.py``'s
  exactly (integers), at the default shapes and at another;
- ``exp_pool_vjp``'s two arms (``max_pool2d``'s ceiling mode and the port's
  ``max_pool_same``) agree on the CPU: the outputs exactly, the input
  gradients within 1e-6 (both route a window's gradient to its first
  maximum, so they are equal here);
- ``bench_scaling`` runs 1 and 2 gloo ranks on the CPU (the 2 ranks in one
  spawn), and its summary's keys are the JAX script's.

The builders of ``bench_scaling``, ``profile_sac_visual`` and
``profile_ppo_atari`` are held against the JAX scripts' in
``tests/test_torch_tools_parity.py``.
"""

import ast
import json
import math
import os

import pytest
import torch

from seed_rl_torch.tools import (
    bench_batcher,
    bench_fleet,
    bench_football,
    bench_r2d2,
    bench_scaling,
    exp_bwd_decomp,
    exp_pool_vjp,
    profile_bench,
    profile_impala,
    profile_ppo_atari,
    profile_sac_visual,
    profile_torso,
    sweep_bench,
)
from seed_rl_torch.utils import flops

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = "--device=cpu"


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Many small ops: one intra-op thread (see tests/test_torch_ppo.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _script(name):
    with open(os.path.join(ROOT, "scripts", f"{name}.py")) as f:
        return f.read()


def _json_keys(name):
    """The keys of the dict literals that hold a ``"metric"`` key in the
    JAX script, and the keys it later assigns to a variable holding one."""
    tree = ast.parse(_script(name))
    keys, holders = set(), set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Dict):
            names = {k.value for k in node.keys
                     if isinstance(k, ast.Constant)}
            if "metric" in names:
                keys |= names
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and any(isinstance(k, ast.Constant) and k.value == "metric"
                        for k in node.value.keys)):
            holders |= {t.id for t in node.targets
                        if isinstance(t, ast.Name)}
    for node in ast.walk(tree):
        if (isinstance(node, ast.Subscript)
                and isinstance(node.ctx, ast.Store)
                and isinstance(node.value, ast.Name)
                and node.value.id in holders):
            keys.add(node.slice.value)
    return keys


def _positive(*rates):
    for rate in rates:
        assert math.isfinite(rate) and rate > 0, rates


def _rows_ok(rows, names):
    assert [r.name for r in rows] == names
    for r in rows:
        _positive(r.ms)
        if r.fps is not None:
            _positive(r.fps)
        # Device metrics are not measured on the CPU.
        assert r.busy_ms is r.launches is r.idle is None


def test_bench_r2d2_prints_the_scripts_line(capsys, monkeypatch):
    for name, value in (("UNROLL", 6), ("BURN_IN", 2), ("BATCH_SIZE", 4),
                        ("REPLAY_BUFFER_SIZE", 16)):
        monkeypatch.setattr(bench_r2d2, name, value)
    line = bench_r2d2.main([CPU, "--num_envs=4", "--calls=1"])
    assert json.loads(capsys.readouterr().out.strip()) == line
    assert set(line) == _json_keys("bench_r2d2") | {"card"}
    assert line["metric"] == "r2d2_atari_env_frames_per_sec_per_chip"
    assert f'"{line["metric"]}"' in _script("bench_r2d2")
    assert line["vs_baseline"] is None and line["card"] == "cpu"
    _positive(line["value"])


def test_bench_football_prints_the_scripts_line(capsys):
    result = bench_football.main(["4", "4", CPU, "--calls=1"])
    out = capsys.readouterr().out.splitlines()
    metric = "football_vtrace_env_frames_per_sec_per_chip"
    assert f'f"{metric}: "' in _script("bench_football")
    assert out[0].startswith(f"{metric}: ") and out[0].endswith(" ms/step)")
    assert out[1] == "cpu" and result["metric"] == metric
    _positive(result["value"], result["ms_per_step"])


def test_sweep_bench_prints_a_line_a_spec(capsys):
    results = sweep_bench.main(["4,4,1", "2,4,2", CPU, "--calls=1"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("envs=    4 unroll=  4 spc=1 -> ")
    assert out[1].startswith("envs=    2 unroll=  4 spc=2 -> ")
    assert all(line.endswith("k fps") for line in out[:2])
    assert list(results) == ["4,4,1", "2,4,2"]
    _positive(*results.values())
    assert all(len(spec.split(",")) == 3 for spec in sweep_bench.GRID)


def test_profile_bench_rows(monkeypatch):
    monkeypatch.setattr(profile_bench, "UNROLL", 4)
    result = profile_bench.main([CPU, "--num_envs=4", "--iters=1"])
    # The script's four rows, and the update alone.
    _rows_ok(result["rows"], ["full train_step", "rollout only",
                              "update only", "loss forward", "loss fwd+bwd"])
    assert result["card"] == "cpu"


def test_profile_torso_rows(monkeypatch):
    monkeypatch.setattr(profile_torso, "T", 2)
    result = profile_torso.main([CPU, "--B=2", "--iters=1"])
    names = ["torso fwd [T*B]", "torso fwd+bwd [T*B]",
             "frame stacking scan [T,B]", "LSTM(256) scan fwd [T,B]",
             "LSTM(256) scan fwd+bwd [T,B]", "conv 4->32 k8s4 @84",
             "conv 32->64 k4s2 @20", "conv 64->64 k3s1 @9",
             "conv1 as s2d 64->32 k2s1 @21", "dense 3136->512"]
    script = _script("profile_torso")
    for name in names:
        if not name.startswith("conv "):  # the script formats those
            assert f'"{name}"' in script, name
    _rows_ok(result["rows"], names)


def test_profile_impala_tables_and_model(capsys):
    result = profile_impala.main([CPU, "--envs=2", "--unroll=2",
                                  "--iters=1", "--remat"])
    out = capsys.readouterr().out
    assert "== stage table (B=2, T=2, remat=True; cpu) ==" in out
    assert "stage shares of full step" in out
    _rows_ok(list(result["stages"].values()), [
        "full train step", "rollout only", "update only (loss+bwd+opt)",
        "loss forward", "loss fwd+bwd"])
    _rows_ok(list(result["torso"].values()), [
        "torso fwd", "torso fwd+bwd", "stack0 3->16ch @72x96",
        "stack1 16->32ch @36x48", "stack2 32->32ch @18x24",
        "dense 3456->256", "LSTM(256) scan fwd [T+1,B]",
        "LSTM(256) scan fwd+bwd [T+1,B]"])
    assert (result["flops_per_frame"], result["flops_detail"]) == (
        flops.impala_flops_per_frame())
    assert result["hbm_bytes_per_frame"] == (
        flops.impala_hbm_bytes_per_frame())
    # The mfu is a device metric: not measured on the CPU; the peak the
    # card's run would use is the H100's bf16 one.
    assert result["mfu"] is None and "mfu: not measured" in out
    assert result["peak"] == "bf16"
    assert profile_impala.PEAK_FLOPS == flops.PEAK_BF16_FLOPS == 989e12


def _jax_profile_impala():
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "jax_profile_impala", os.path.join(ROOT, "scripts",
                                           "profile_impala.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("kw", [
    {},
    dict(h=84, w=84, cin=4, stacks=((16, 2), (32, 2), (32, 2), (32, 2)),
         dense_out=512, lstm=128, num_actions=18),
])
def test_impala_flops_and_hbm_models_equal_the_scripts(kw, monkeypatch):
    """Exact: the models count integers."""
    monkeypatch.setenv("SEED_RL_TPU_CACHE_DIR", "")
    jax_script = _jax_profile_impala()
    assert flops.impala_flops_per_frame(**kw) == (
        jax_script.impala_flops_per_frame(**kw))
    hbm_kw = {k: v for k, v in kw.items()
              if k in ("h", "w", "cin", "stacks")}
    for bytes_per_el in (2, 4):
        assert flops.impala_hbm_bytes_per_frame(
            **hbm_kw, bytes_per_el=bytes_per_el) == (
            jax_script.impala_hbm_bytes_per_frame(
                **hbm_kw, bytes_per_el=bytes_per_el))
    if not kw:
        assert flops.impala_flops_per_frame()[0] == flops.impala_deep()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_exp_pool_vjp_arms_agree(dtype):
    """Forward exactly, input gradients within 1e-6, on inputs quantised
    to a few levels so that windows tie."""
    gen = torch.Generator().manual_seed(0)
    for h, w, c in exp_pool_vjp.SHAPES:
        x = torch.randint(0, 4, (2, c, h, w), generator=gen).to(dtype)
        x.requires_grad_()
        ct = torch.randn((2, c, -(-h // 2), -(-w // 2)),
                         generator=gen).to(dtype)
        outs = [pool(x) for pool in exp_pool_vjp.POOLS.values()]
        assert torch.equal(outs[0], outs[1])
        grads = [torch.autograd.grad(o, x, ct)[0] for o in outs]
        torch.testing.assert_close(grads[0], grads[1], rtol=0, atol=1e-6)


def test_exp_pool_vjp_library_arm_refuses_a_low_edge_pad():
    with pytest.raises(ValueError, match="low edge"):
        exp_pool_vjp.library_pool(torch.zeros(1, 1, 21, 21))


def test_exp_pool_vjp_sections(capsys, monkeypatch):
    monkeypatch.setattr(exp_pool_vjp, "UNROLL", 2)
    result = exp_pool_vjp.main([CPU, "--n=2", "--envs=2", "--iters=1"])
    assert set(result["agreement"]) == set(exp_pool_vjp.SHAPES)
    for agreement in result["agreement"].values():
        assert agreement == {"outputs_equal": True,
                             "grad_max_abs_diff": 0.0}
    assert set(result["torso"]) == set(result["train_step"]) == {
        "library", "port"}
    for row in result["train_step"].values():
        _positive(row.ms, row.fps)
    # The residual stacks' pool is the port's again afterwards.
    from seed_rl_torch.models import resnets
    from seed_rl_torch.ops.pooling import max_pool_same

    assert resnets.max_pool_same is max_pool_same
    assert "== full DmLab V-trace train step (B=2, T=2) ==" in (
        capsys.readouterr().out)


def test_exp_bwd_decomp_rows():
    result = exp_bwd_decomp.main([CPU, "--n=2", "--iters=1"])
    rows = result["rows"]
    assert {"torso fwd", "torso bwd(vjp, rand ct)",
            "stack0 3->16 @72x96 bwd(vjp, rand ct)",
            "pool @18x24x32 bwd(vjp, rand ct)",
            "stack1 res conv  dp only (incl fwd)"} <= set(rows)
    # 2 torso + 3 x 2 stacks + 3 x 2 pools + 4 x 4 convs.
    assert len(rows) == 2 + 6 + 6 + 16
    for row in rows.values():
        _positive(row.ms)


def test_exp_bwd_decomp_uses_a_random_cotangent(monkeypatch):
    """Every backward gets ``grad_outputs``: no cotangent of ones."""
    seen = []
    grad = torch.autograd.grad

    def recording(outputs, inputs, grad_outputs=None, **kw):
        seen.append(grad_outputs)
        return grad(outputs, inputs, grad_outputs, **kw)

    monkeypatch.setattr(torch.autograd, "grad", recording)
    exp_bwd_decomp.main([CPU, "--n=1", "--iters=1"])
    assert seen and all(isinstance(ct, torch.Tensor) for ct in seen)
    assert not any(bool((ct == 1).all()) for ct in seen)


def test_profile_ppo_atari_rows(capsys):
    result = profile_ppo_atari.main([CPU, "--num_envs=8", "--unroll=2",
                                     "--iters=1"])
    names = ["full step (shuffle 2ep x 8mb)", "rollout only",
             "update only (shuffle 2ep x 8mb)",
             "update only (repeat 2ep x 8mb, no gather)",
             "update only (repeat 1ep x 1mb = 1 fwd+bwd)",
             "update only (repeat 1ep x 8mb)",
             "16 minibatch gathers (take axis=1)",
             "16 minibatch gathers (flattened obs)"]
    script = _script("profile_ppo_atari")
    for name in names:
        assert f'"{name}"' in script, name
    _rows_ok(list(result["rows"].values()), names)
    out = capsys.readouterr().out
    assert "decomposition: rollout " in out
    assert "shuffle-vs-repeat update delta (gather cost): " in out


def test_profile_sac_visual_sections(monkeypatch):
    for name, value in (("NUM_ENVS", 4), ("BATCH_SIZE", 4),
                        ("MINIBATCHES", 2)):
        monkeypatch.setattr(profile_sac_visual, name, value)
    result = profile_sac_visual.main([
        CPU, "--torso_batches=2,4", "--sweep=4x2,2x4", "--iters=1"])
    names = ["full train step", "rollout+insert+stats",
             "single minibatch update", "replay sample alone",
             "loss forward only", "loss fwd+bwd",
             "polyak target update alone"]
    script = _script("profile_sac_visual")
    for name in names:
        assert f'"{name}"' in script, name
    _rows_ok(list(result["stages"].values()), names)
    assert set(result["torso"]) == {(p, n) for p in ("fwd", "fwd+bwd")
                                    for n in (2, 4)}
    assert set(result["sweep"]) == {(4, 2), (2, 4)}
    # 8 env frames a step; 2 minibatches of 4 x (2 x 3 + 3) passes.
    assert result["accounting"]["passes_per_env_frame"] == (8 + 2 * 36) / 8
    _positive(result["accounting"]["fps"],
              result["accounting"]["passes_per_sec"])
    assert profile_sac_visual.SWEEP == "128x2,256x2,512x2,128x4,256x4"


def test_bench_batcher_counts_calls_and_batches(capsys):
    result = bench_batcher.main(["4", "2", "0.5"])
    line = capsys.readouterr().out.strip()
    assert line.startswith("clients=4 batch=2: ") and " QPS (" in line
    assert "mean fill" in line and "batches/s" in line
    _positive(result["calls_per_sec"], result["batches_per_sec"],
              result["mean_fill"])
    assert result["mean_fill"] <= 2


def test_bench_fleet_one_actor(capsys):
    """The script's workload (V-trace on HalfCheetah over the fleet), one
    actor at 10 train steps of 8 envs x 16."""
    pytest.importorskip("gymnasium")
    lines = bench_fleet.main(["1280", "1", CPU, "--warmup_frames=0"])
    assert [json.loads(x) for x in capsys.readouterr().out.splitlines()
            if x.startswith('{"metric"')] == lines
    (line,) = lines
    assert set(line) == _json_keys("bench_fleet") | {"card"}
    assert line["metric"] == "fleet_env_frames_per_sec"
    assert line["actors"] == 1 and line["platform"] == "cpu"
    _positive(line["value"], line["inference_qps"], line["window_secs"],
              line["batcher_mean_fill"])


def test_bench_scaling_one_and_two_gloo_ranks(capsys):
    summary = bench_scaling.main([
        CPU, "--replicas=2,1", "--envs_per_replica=4", "--unroll=4",
        "--steps_per_call=1", "--calls=1"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("replicas=  1 envs=     4 -> ")
    assert out[1].startswith("replicas=  2 envs=     8 -> ")
    assert json.loads(out[-1]) == summary
    assert set(summary) == _json_keys("bench_scaling") | {"card"}
    assert summary["metric"] == "scaling_efficiency_1_to_2_replicas"
    assert summary["note"] == bench_scaling.CPU_NOTE
    _positive(summary["value"], *summary["frames_per_sec"].values())


def test_bench_scaling_puts_ranks_on_cards(monkeypatch):
    """NCCL ranks need a card each; gloo ranks share them."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="NCCL refuses"):
        bench_scaling.rank_devices(2, "cuda", "nccl")
    assert bench_scaling.rank_devices(2, "cuda", "gloo") == ["cuda:0"] * 2
    assert bench_scaling.rank_devices(1, "cuda", "nccl") == ["cuda:0"]
    assert bench_scaling.rank_devices(2, "cpu", "gloo") == ["cpu", "cpu"]


def test_tools_default_to_the_card(monkeypatch):
    """Without --device a tool asks for the card and raises without one."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for tool in (bench_r2d2, profile_bench, bench_scaling):
        with pytest.raises(RuntimeError, match="--device=cpu"):
            tool.main([])


def test_read_scalars_gives_back_what_the_writer_wrote(tmp_path):
    """``utils/metrics.py::read_scalars`` (bench_fleet's window) reads the
    event file ``EventFileWriter`` writes: steps, tags and float32 values
    in order, wall times non-decreasing; the version record skipped."""
    import glob

    import numpy as np

    from seed_rl_torch.utils import metrics

    writer = metrics.EventFileWriter(str(tmp_path))
    written = [(0, "server/total_batches", 0.0), (5, "losses/total", -1.5),
               (300, "server/total_batches", 1.234e4), (2 ** 40, "a/b", 0.1)]
    for step, tag, value in written:
        writer.add_scalar(tag, value, step)
    writer.close()
    (path,) = glob.glob(str(tmp_path / "events.out.*"))
    read = metrics.read_scalars(path)
    assert [(s, t, v) for _, s, t, v in read] == [
        (s, t, float(np.float32(v))) for s, t, v in written]
    walls = [w for w, *_ in read]
    assert walls == sorted(walls)
