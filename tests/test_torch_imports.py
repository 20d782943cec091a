"""The port stands alone: no JAX, no seed_rl_tpu, and the card by default.

The import check is a static scan of the source, because the process that
runs the tests may import JAX before any test starts (tests/conftest.py),
so ``sys.modules`` cannot tell who imported what.
"""

import ast
import pathlib

import pytest
import torch

from seed_rl_torch import train

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "tensorboardX",
             "tensorboard", "seed_rl_tpu", "gymnasium"}


def _port_sources():
    files = sorted((ROOT / "seed_rl_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    return files


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module:
            if node.level == 0:
                yield node.lineno, node.module.split(".")[0]
        elif (
            isinstance(node, ast.Call)
            and getattr(node.func, "attr", getattr(node.func, "id", ""))
            in ("import_module", "__import__")
            and node.args
            and isinstance(node.args[0], ast.Constant)
            and isinstance(node.args[0].value, str)
        ):
            yield node.lineno, node.args[0].value.split(".")[0]


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
