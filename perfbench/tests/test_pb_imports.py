"""Nothing the benchmark runs imports JAX, the JAX package, or the parts of
the port it does not use; the plain references import nothing of the port."""

import ast
import io
import sys
import types

import pytest
import torch

from perfbench.harness import runner
from perfbench.tests.conftest import ROOT, tiny_checkout

FORBIDDEN_TOP = {"jax", "jaxlib", "flax", "seed_rl_tpu"}
FORBIDDEN = ("seed_rl_torch.bench", "seed_rl_torch.tools",
             "seed_rl_torch.utils.flops")


def imports(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
            yield from (f"{node.module}.{a.name}" for a in node.names)


def run_files():
    return [p for p in sorted((ROOT / "perfbench").rglob("*.py"))
            if "tests" not in p.relative_to(ROOT / "perfbench").parts]


def test_no_file_of_the_benchmark_imports_jax_or_the_jax_package():
    assert run_files()
    for path in run_files():
        for name in imports(path):
            assert name.split(".")[0] not in FORBIDDEN_TOP, (path, name)
            assert not any(name == f or name.startswith(f + ".")
                           for f in FORBIDDEN), (path, name)


def test_the_references_import_nothing_of_the_port():
    for path in sorted((ROOT / "perfbench" / "reference").glob("*.py")):
        for name in imports(path):
            assert name.split(".")[0] != "seed_rl_torch", (path, name)
            if name.split(".")[0] == "perfbench":
                assert (name.startswith("perfbench.reference")
                        or name in ("perfbench.harness",
                                    "perfbench.harness.check")), name


def test_the_whole_name_is_compared():
    # The port's name begins with the JAX package's: only whole top-level
    # names count.
    assert "seed_rl_torch".split(".")[0] not in FORBIDDEN_TOP
    sys.modules["seed_rl_tpu_like"] = types.ModuleType("seed_rl_tpu_like")
    try:
        assert "seed_rl_tpu_like" not in runner.forbidden_modules()
    finally:
        del sys.modules["seed_rl_tpu_like"]


def test_a_run_holding_jax_prints_no_result(tmp_path, monkeypatch):
    root = tiny_checkout(tmp_path, float32=True)
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    out, err = io.StringIO(), io.StringIO()
    args = types.SimpleNamespace(workload="dmlab_vtrace.envs256_t32", seed=1,
                                 seconds=0.1, trace=0)
    assert runner.run(args, 0.0, device=torch.device("cpu"), root=root,
                      out=out, err=err) != 0
    assert out.getvalue() == ""
    assert "jax" in err.getvalue()


def test_no_card_no_result(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out, err = io.StringIO(), io.StringIO()
    args = types.SimpleNamespace(workload="dmlab_vtrace.envs256_t32", seed=1,
                                 seconds=1, trace=0)
    assert runner.run(args, 0.0, out=out, err=err) != 0
    assert out.getvalue() == ""


@pytest.mark.parametrize("script", ["run.py", "readings.py"])
def test_scripts_parse_without_the_port(script):
    ast.parse((ROOT / "perfbench" / script).read_text())
