"""The port's bench (seed_rl_torch/bench.py) on the CPU.

``main`` runs every workload at its full width with a tiny ``num_envs``,
one call and one window, and must print one JSON line per workload under
the root ``bench.py``'s metric names and in its ``main``'s order (R2D2
last; no scaling line without two cards), with the fields ``metric``,
``value`` (finite, > 0), ``unit``, ``vs_baseline`` (null), ``spread``,
``tracking`` where ``bench.py`` sets it, and ``mfu`` in (0, 1]. Nothing
else goes to stdout. The workloads' default sizes are read out of
``bench.py``'s source, which is JAX code and is not imported.
"""

import ast
import functools
import inspect
import json
import math
import pathlib

import pytest
import torch

from seed_rl_torch import bench

ROOT = pathlib.Path(__file__).resolve().parents[1]
JAX_BENCH = ast.parse((ROOT / "bench.py").read_text())
# The smallest env counts each workload's minibatching takes: PPO's split
# mode cuts 32 minibatches out of num_envs * 16 frames, conv PPO's shuffle
# mode 8 out of the envs.
TINY_ENVS = {"bench_ppo": 32, "bench_ppo_atari": 8}


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Many small ops: one intra-op thread (see tests/test_torch_ppo.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _functions(tree):
    return {node.name: node for node in tree.body
            if isinstance(node, ast.FunctionDef)}


def _jax_main_order():
    main = _functions(JAX_BENCH)["main"]
    return [stmt.value.func.id for stmt in main.body
            if isinstance(stmt, ast.Expr) and isinstance(stmt.value, ast.Call)]


def _jax_metric(fn):
    """The metric name and tracking flag of a bench.py workload."""
    for node in ast.walk(_functions(JAX_BENCH)[fn]):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
                and node.func.id == "_emit"):
            tracking = any(k.arg == "tracking" and k.value.value
                           for k in node.keywords)
            return node.args[0].value, tracking
    return None


def _jax_sizes(fn):
    """``num_envs`` and ``calls`` of a bench.py workload's first tuple
    assignment."""
    for node in ast.walk(_functions(JAX_BENCH)[fn]):
        if isinstance(node, ast.Assign) and isinstance(node.targets[0],
                                                       ast.Tuple):
            names = [t.id for t in node.targets[0].elts]
            values = [v.value for v in node.value.elts]
            if "num_envs" in names:
                sizes = dict(zip(names, values))
                return sizes["num_envs"], sizes["calls"]
    return None


def test_workloads_are_bench_pys_in_its_order():
    assert [fn.__name__ for fn in bench.WORKLOADS] == _jax_main_order()
    assert _jax_main_order()[-1] == "bench_r2d2"


@pytest.mark.parametrize("fn", [f for f in bench.WORKLOADS
                                if f is not bench.bench_scaling],
                         ids=lambda f: f.__name__)
def test_default_sizes_are_bench_pys(fn):
    params = inspect.signature(fn).parameters
    assert list(params) == ["device", "num_envs", "calls", "windows"]
    assert (params["num_envs"].default,
            params["calls"].default) == _jax_sizes(fn.__name__)
    assert params["windows"].default is None  # BENCH_WINDOWS, default 3
    assert bench.NUM_WINDOWS == 3


def test_main_on_the_cpu_emits_bench_pys_lines(monkeypatch, capsys):
    monkeypatch.setattr(bench, "WORKLOADS", tuple(
        functools.partial(fn, num_envs=TINY_ENVS.get(fn.__name__, 2),
                          calls=1, windows=1)
        for fn in bench.WORKLOADS))
    lines = bench.main(["--device=cpu"])
    captured = capsys.readouterr()
    printed = [json.loads(s) for s in captured.out.splitlines()]
    assert printed == lines
    want = [_jax_metric(fn) for fn in _jax_main_order()
            if _jax_metric(fn) is not None]  # the scaling line prints apart
    assert [(line["metric"], line.get("tracking", False))
            for line in lines] == want
    assert lines[-1]["metric"] == "r2d2_atari_env_frames_per_sec_per_chip"
    for line in lines:
        keys = {"metric", "value", "unit", "vs_baseline", "spread", "mfu"}
        assert set(line) == keys | ({"tracking"} if "tracking" in line
                                    else set()), line
        assert line["unit"] == "frames/s"
        assert line["vs_baseline"] is None
        assert math.isfinite(line["value"]) and line["value"] > 0, line
        assert line["spread"] == 0.0  # one window
        assert 0 < line["mfu"] <= 1, line


def test_scaling_prints_nothing_without_two_cards(capsys):
    assert bench.bench_scaling(torch.device("cpu")) is None
    assert capsys.readouterr().out == ""


def test_the_card_is_the_default_device():
    assert bench.parse_args([]).device == "cuda"
    assert bench.parse_args(["--device=cpu"]).device == "cpu"
    if not torch.cuda.is_available():  # no silent fall-back to the CPU
        with pytest.raises(RuntimeError, match="--device=cpu"):
            bench.main([])
