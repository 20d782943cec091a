"""The port stands alone: no JAX, no seed_rl_tpu, and the card by default.

The import check is a static scan of the source, because the process that
runs the tests may import JAX before any test starts (tests/conftest.py),
so ``sys.modules`` cannot tell who imported what.

The packages of the real environments (gymnasium, cv2, ALE, DeepMind Lab,
gfootball, MuJoCo) are not on the card's machine: the port imports them
only inside the adapter functions that build such an env, and a process
without gymnasium and cv2 runs the host data path end to end.
"""

import ast
import pathlib
import subprocess
import sys
import textwrap

import pytest
import torch

from seed_rl_torch import train

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
