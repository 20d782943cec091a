"""The port's build directory (seed_rl_torch/utils/compilation_cache.py).

``SEED_RL_TORCH_BUILD_DIR`` moves both native builds, the batcher (g++,
built here) and the CUDA kernels (nvcc, not here: only their paths are
checked). Unset, they stay in the checkout's ``build/``. A directory that
cannot be written warns once and builds into a fresh temporary directory.
"""

import pathlib
import tempfile
import warnings

import pytest
import torch

from seed_rl_torch.ops.cuda import build as cuda_build
from seed_rl_torch.runtime import inference_server
from seed_rl_torch.utils import compilation_cache

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread, as in every port test file (see
    tests/test_torch_ppo.py): the test workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def fresh(monkeypatch, tmp_path):
    """No fallback made yet, and temporary directories under tmp_path."""
    monkeypatch.setattr(compilation_cache, "_fallback", None)
    scratch = tmp_path / "tmp"
    scratch.mkdir()
    monkeypatch.setattr(tempfile, "tempdir", str(scratch))
    return scratch


def test_default_is_the_checkouts_build_directory(monkeypatch, fresh):
    monkeypatch.delenv(compilation_cache.ENV_VAR, raising=False)
    assert compilation_cache.build_root() == ROOT / "build"
    assert inference_server.library_path().parent == ROOT / "build" / "batcher"
    assert (cuda_build.library_path("vtrace_kernel").parent
            == ROOT / "build" / "kernels")
    # An empty variable is the default too.
    monkeypatch.setenv(compilation_cache.ENV_VAR, "")
    assert compilation_cache.build_root() == ROOT / "build"


def test_the_variable_moves_the_batcher_build(monkeypatch, fresh, tmp_path):
    target = tmp_path / "elsewhere"
    monkeypatch.setenv(compilation_cache.ENV_VAR, str(target))
    built = inference_server.build()
    assert built.exists()
    assert built.parent == target / "batcher"
    assert built.name.startswith("libbatcher-")
    assert (cuda_build.library_path("nstep_kernel").parent
            == target / "kernels")
    assert not list(fresh.iterdir())  # no fallback made


def test_an_unwritable_directory_warns_once_and_builds_elsewhere(
        monkeypatch, fresh, tmp_path):
    blocker = tmp_path / "a_file"
    blocker.write_text("not a directory")
    # Under a regular file no directory can be made, even by root.
    monkeypatch.setenv(compilation_cache.ENV_VAR, str(blocker / "build"))
    with pytest.warns(RuntimeWarning, match="cannot write the build"):
        built = inference_server.build()
    assert built.exists()
    fallback = built.parent.parent
    assert built.parent.name == "batcher"
    assert fallback.parent == fresh
    assert fallback.name.startswith("seed_rl_torch_build_")
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # once: a second call is silent
        assert inference_server.build() == built
        assert (cuda_build.library_path("vtrace_kernel").parent
                == fallback / "kernels")
