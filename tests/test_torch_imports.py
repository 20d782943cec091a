"""The port stands alone: no JAX, no seed_rl_tpu, and the card by default.

The import check is a static scan of the source, because the process that
runs the tests may import JAX before any test starts (tests/conftest.py),
so ``sys.modules`` cannot tell who imported what. A second scan finds no
string in the code (docstrings aside) that names a path inside
``seed_rl_tpu/``: the port builds its own copy of the batcher
(``csrc/batcher.cc``) into the git-ignored ``build/``; only the kernels
line's ``file:line`` references to the TPU kernels it replaces name one.

The packages of the real environments (gymnasium, cv2, ALE, DeepMind Lab,
gfootball, MuJoCo) are not on the card's machine: the port imports them
only inside the adapter functions that build such an env, and a process
without gymnasium and cv2 runs the host data path end to end. An actor
process (``--run_mode=actor``) runs with JAX, seed_rl_tpu, gymnasium and
cv2 all blocked, and ends with CUDA not initialised.
"""

import ast
import json
import os
import pathlib
import re
import signal
import subprocess
import sys
import textwrap

import pytest
import torch

from seed_rl_torch import train
from seed_rl_torch.runtime.transport import unique_socket_path

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "tensorboardX",
             "tensorboard", "seed_rl_tpu"}
ENV_PACKAGES = {"gymnasium", "cv2", "ale_py", "deepmind_lab", "gfootball",
                "mujoco"}
# The only places that may import ENV_PACKAGES: (file, function).
ADAPTER_FUNCTIONS = {
    ("seed_rl_torch/envs/mujoco.py", "create_environment"),
    ("seed_rl_torch/envs/atari.py", "AtariPreprocessing._pool_and_resize"),
    ("seed_rl_torch/envs/atari.py", "pool_and_resize_frames"),
    ("seed_rl_torch/envs/atari.py", "create_environment"),
    ("seed_rl_torch/envs/dmlab.py", "DmLab.__init__"),
    ("seed_rl_torch/envs/football.py", "create_environment"),
}


def _port_sources():
    files = sorted((ROOT / "seed_rl_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    return files


def _imports(path):
    """(line, imported root package, enclosing function's qualified name or
    None at module level) of every import in ``path``."""
    tree = ast.parse(path.read_text(), filename=str(path))

    def roots(node):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module:
            if node.level == 0:
                yield node.module.split(".")[0]
        elif (
            isinstance(node, ast.Call)
            and getattr(node.func, "attr", getattr(node.func, "id", ""))
            in ("import_module", "__import__")
            and node.args
            and isinstance(node.args[0], ast.Constant)
            and isinstance(node.args[0].value, str)
        ):
            yield node.args[0].value.split(".")[0]

    def walk(node, scope, in_function):
        for child in ast.iter_child_nodes(node):
            for root in roots(child):
                yield child.lineno, root, scope if in_function else None
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.ClassDef)):
                name = f"{scope}.{child.name}" if scope else child.name
                yield from walk(child, name,
                                not isinstance(child, ast.ClassDef))
            else:
                yield from walk(child, scope, in_function)

    yield from walk(tree, None, False)


def _imported_roots(path):
    for line, root, _ in _imports(path):
        yield line, root


def test_port_imports_no_jax_and_nothing_of_seed_rl_tpu():
    files = _port_sources()
    assert len(files) > 15
    offenders = [
        f"{path.relative_to(ROOT)}:{line} imports {root}"
        for path in files
        for line, root in _imported_roots(path)
        if root in FORBIDDEN
    ]
    assert not offenders, offenders


def test_scan_covers_the_parallel_package():
    """The scale-out package and the data-parallel tests' rank module are
    held to the rule too (the ranks import that module by name)."""
    files = {str(p.relative_to(ROOT)) for p in _port_sources()}
    assert {"seed_rl_torch/parallel/__init__.py",
            "seed_rl_torch/parallel/mesh.py",
            "seed_rl_torch/parallel/dp.py",
            "seed_rl_torch/parallel/collectives.py",
            "seed_rl_torch/parallel/draws.py"} <= files
    workers = ROOT / "tests" / "torch_dp_workers.py"
    assert not {root for _, root in _imported_roots(workers)} & FORBIDDEN


def test_scan_covers_the_bench_and_its_utils():
    """The port's bench and the modules it brought in are held to the rule:
    no JAX, nothing of seed_rl_tpu (not even its plain-Python flops.py)."""
    files = {str(p.relative_to(ROOT)) for p in _port_sources()}
    new = {"seed_rl_torch/bench.py", "seed_rl_torch/utils/flops.py",
           "seed_rl_torch/utils/compilation_cache.py"}
    assert new <= files
    for name in new:
        roots = {root for _, root in _imported_roots(ROOT / name)}
        assert not roots & FORBIDDEN, name


def test_scan_covers_the_example_module_the_tools_and_the_launchers():
    """The example ``--agent_module``, the soak harness and the reference
    launchers are held to the rule: the Python files import no JAX and
    nothing of seed_rl_tpu, and the launchers run the port's modules and
    name none of the JAX package's."""
    files = {str(p.relative_to(ROOT)) for p in _port_sources()}
    assert {"seed_rl_torch/examples/__init__.py",
            "seed_rl_torch/examples/custom_ppo_composition.py",
            "seed_rl_torch/tools/__init__.py",
            "seed_rl_torch/tools/soak_r2d2_replay.py"} <= files
    launchers = sorted((ROOT / "seed_rl_torch").rglob("*.sh"))
    assert len(launchers) == 5
    for path in launchers:
        text = path.read_text()
        assert "python -m seed_rl_torch." in text, path
        assert "seed_rl_tpu" not in text and "jax" not in text.lower(), path


TOOLS = ("_timing", "bench_r2d2", "bench_football", "sweep_bench",
         "profile_bench", "profile_torso", "profile_impala", "exp_pool_vjp",
         "exp_bwd_decomp", "profile_ppo_atari", "profile_sac_visual",
         "bench_batcher", "bench_fleet", "bench_scaling")


def test_scan_covers_the_measurement_tools():
    """Every measurement tool is held to the rule: no JAX, nothing of
    seed_rl_tpu, and no TPU's peak rate in its code."""
    files = {str(p.relative_to(ROOT)) for p in _port_sources()}
    for name in TOOLS:
        path = f"seed_rl_torch/tools/{name}.py"
        assert path in files, path
        roots = {root for _, root in _imported_roots(ROOT / path)}
        assert not roots & FORBIDDEN, path
        text = (ROOT / path).read_text()
        assert "197e12" not in text and "819e9" not in text, path


def test_env_packages_only_inside_the_adapter_functions():
    """gymnasium and the emulators stay off the card's path: never at
    module level, and inside a function only in the adapters that build a
    real env."""
    offenders, used = [], set()
    for path in _port_sources():
        rel = str(path.relative_to(ROOT))
        for line, root, function in _imports(path):
            if root not in ENV_PACKAGES:
                continue
            if (rel, function) in ADAPTER_FUNCTIONS:
                used.add((rel, function))
            else:
                offenders.append(f"{rel}:{line} imports {root} in "
                                 f"{function or 'the module'}")
    assert not offenders, offenders
    assert used == ADAPTER_FUNCTIONS


def test_scope_scan_sees_functions_and_methods(tmp_path):
    src = tmp_path / "scoped.py"
    src.write_text(textwrap.dedent("""\
        import gymnasium
        class Env:
            import cv2
            def step(self):
                import ale_py
        def make():
            def inner():
                import gfootball
            import mujoco
    """))
    assert sorted(_imports(src)) == [
        (1, "gymnasium", None), (3, "cv2", None), (5, "ale_py", "Env.step"),
        (8, "gfootball", "make.inner"), (9, "mujoco", "make")]


def test_host_path_runs_without_gymnasium_and_cv2():
    """In a process where importing gymnasium or cv2 fails, the host data
    path imports and trains R2D2 and V-trace on synthetic_atari_host for a
    cycle on the CPU."""
    script = textwrap.dedent("""\
        import sys
        sys.modules["gymnasium"] = None
        sys.modules["cv2"] = None
        import seed_rl_torch.envs.host
        import seed_rl_torch.host_loop
        import seed_rl_torch.host_offpolicy
        import seed_rl_torch.replay_host
        import seed_rl_torch.rollout_host
        from seed_rl_torch import train
        common = ["--env=synthetic_atari_host", "--device=cpu",
                  "--num_envs=4", "--unroll_length=6", "--burn_in=2",
                  "--n_steps=2", "--batch_size=4",
                  "--replay_buffer_size=16", "--replay_buffer_min_size=4",
                  "--total_environment_frames=24"]
        for agent, flags in (("r2d2", ["--replay_ratio=1.0"]),
                             ("vtrace", [])):
            _, state, _ = train.main([f"--agent={agent}"] + common + flags)
            assert state.step == 1, (agent, state)
        assert "gymnasium" not in sys.modules or (
            sys.modules["gymnasium"] is None)
        print("ran without gymnasium")
    """)
    result = subprocess.run([sys.executable, "-c", script], cwd=ROOT,
                            capture_output=True, text=True, timeout=300)
    assert result.returncode == 0, result.stderr
    assert "ran without gymnasium" in result.stdout


def test_scan_catches_a_forbidden_import(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text(
        "import os\nfrom jax import numpy\n"
        "def f():\n    import seed_rl_tpu.types\n"
        "importlib.import_module('optax')\n"
    )
    assert {root for _, root in _imported_roots(bad)} == {
        "os", "jax", "seed_rl_tpu", "optax"
    }


def test_train_main_needs_the_card_unless_told(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device=cpu"):
        train.main(["--agent=vtrace", "--env=toy"])


# A file:line reference to the TPU kernel a kernel replaces (the kernels
# line's "replaces" key), not a path the code opens.
KERNEL_REFERENCE = re.compile(r"seed_rl_tpu/[\w/]+\.py:\d+")


def _code_strings(path):
    """(line, value) of every string constant in ``path`` that is not a
    docstring."""
    tree = ast.parse(path.read_text(), filename=str(path))
    docstrings = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                             ast.AsyncFunctionDef)) and node.body:
            first = node.body[0]
            if isinstance(first, ast.Expr) and isinstance(first.value,
                                                          ast.Constant):
                docstrings.add(id(first.value))
    for node in ast.walk(tree):
        if (isinstance(node, ast.Constant) and isinstance(node.value, str)
                and id(node) not in docstrings):
            yield node.lineno, node.value


def _names_a_jax_package_path(value):
    return (value == "seed_rl_tpu" or "seed_rl_tpu/" in value) and (
        not KERNEL_REFERENCE.fullmatch(value))


def test_no_code_names_a_path_inside_the_jax_package():
    offenders = [f"{path.relative_to(ROOT)}:{line} {value!r}"
                 for path in _port_sources()
                 for line, value in _code_strings(path)
                 if _names_a_jax_package_path(value)]
    assert not offenders, offenders
    from seed_rl_torch.runtime import inference_server

    assert inference_server.SOURCE == (
        ROOT / "seed_rl_torch" / "csrc" / "batcher.cc")
    assert inference_server.BUILD_DIR == ROOT / "build" / "batcher"
    assert "/build/" in (ROOT / ".gitignore").read_text().split()


def test_path_scan_catches_a_path_into_the_jax_package(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text(textwrap.dedent('''\
        """Port of ``seed_rl_tpu/runtime/batcher.cc``."""
        SRC = "seed_rl_tpu/runtime/batcher.cc"
        PARTS = ("seed_rl_tpu", "runtime")
        REPLACES = "seed_rl_tpu/ops/pallas/nstep_kernel.py:36"
    '''))
    flagged = [value for _, value in _code_strings(bad)
               if _names_a_jax_package_path(value)]
    assert flagged == ["seed_rl_tpu/runtime/batcher.cc", "seed_rl_tpu"]


ACTOR = textwrap.dedent("""\
    import runpy, sys
    for name in ("jax", "jaxlib", "seed_rl_tpu", "gymnasium", "cv2"):
        sys.modules[name] = None  # importing any of them fails
    sys.argv = ["seed_rl_torch.train"] + sys.argv[1:]
    runpy.run_module("seed_rl_torch.train", run_name="__main__")
""")


def test_actor_process_runs_without_jax_gymnasium_cv2_and_cuda():
    """An actor process steps synthetic_atari_host against a learner in
    this process with JAX, seed_rl_tpu, gymnasium and cv2 blocked; stopped
    by SIGTERM, it reports its steps and that CUDA was never initialised."""
    path = unique_socket_path("srt")
    flags = ["--agent=vtrace", "--env=synthetic_atari_host",
             f"--server_address={path}", "--unroll_length=4"]
    actor = subprocess.Popen(
        [sys.executable, "-c", ACTOR, "--run_mode=actor", "--num_envs=2",
         *flags], cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, env={**os.environ, "PYTHONPATH": str(ROOT)})
    try:
        _, state, _ = train.main(["--run_mode=learner", "--device=cpu",
                                  "--num_envs=2",
                                  "--total_environment_frames=16", *flags])
    finally:
        # The learner needed the actor's unrolls: it has started and stops
        # cleanly on SIGTERM.
        if actor.poll() is None:
            actor.send_signal(signal.SIGTERM)
        out, err = actor.communicate(timeout=60)
    assert state.step == 2
    assert actor.returncode == 0, err
    final = json.loads(out.splitlines()[-1])["actor"]
    assert final["steps"] >= 8
    assert final["cuda_initialized"] is False
