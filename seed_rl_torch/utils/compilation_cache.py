"""The build directory: the port's counterpart of a persistent compile cache.

The JAX package's ``utils/compilation_cache.py`` points XLA's persistent
compilation cache at a disk directory, so that a restart loads its compiled
programs instead of compiling them again. The port compiles no graph; what
it builds at run time is its native code: the CUDA kernels
(``ops/cuda/build.py``, with nvcc) and the batcher of the remote-actor
runtime (``runtime/inference_server.py``, with g++). Each library is named
by a hash of its source and flags and kept in a build directory, so a
restart, an eval job or a benchmark reuses what an earlier process built:
that directory is the port's persistent cache.

``SEED_RL_TORCH_BUILD_DIR`` moves it (the kernels go to ``<dir>/kernels``,
the batcher to ``<dir>/batcher``); unset or empty, it is ``build/`` at the
root of the checkout, a directory ``.gitignore`` lists. As the JAX module
does, this never fails hard: where the directory cannot be written it
warns once and builds into a fresh temporary directory, from the same
sources.
"""

import os
import pathlib
import tempfile
import threading
import warnings

ENV_VAR = "SEED_RL_TORCH_BUILD_DIR"
DEFAULT_DIR = pathlib.Path(__file__).resolve().parents[2] / "build"

_lock = threading.Lock()
_fallback = None  # this process's temporary build directory, once made


def _writable(directory: pathlib.Path) -> bool:
    try:
        directory.mkdir(parents=True, exist_ok=True)
        with tempfile.NamedTemporaryFile(dir=directory):
            pass
        return True
    except OSError:
        return False


def build_root() -> pathlib.Path:
    """The directory builds go to: ``SEED_RL_TORCH_BUILD_DIR``, else the
    checkout's ``build/``; a temporary one where that cannot be written."""
    global _fallback
    root = pathlib.Path(os.environ.get(ENV_VAR) or DEFAULT_DIR)
    if _writable(root):
        return root
    with _lock:
        if _fallback is None:
            _fallback = pathlib.Path(
                tempfile.mkdtemp(prefix="seed_rl_torch_build_"))
            warnings.warn(
                f"seed_rl_torch: cannot write the build directory {root} "
                f"(set {ENV_VAR} to move it); building into {_fallback}",
                RuntimeWarning, stacklevel=2)
        return _fallback


def build_dir(kind: str) -> pathlib.Path:
    """``<build root>/<kind>``, made if missing."""
    directory = build_root() / kind
    directory.mkdir(parents=True, exist_ok=True)
    return directory
