"""Builds the port's CUDA sources with nvcc and loads them with ctypes.

Each ``seed_rl_torch/csrc/<name>.cu`` exposes a plain C function and is
compiled on its own into ``build/kernels/<name>-<hash>.so`` at the root of
the checkout (a directory ``.gitignore`` lists; ``SEED_RL_TORCH_BUILD_DIR``
moves it, see ``utils/compilation_cache.py``), the first time a kernel is
needed. The hash covers the source and the flags, so an edited source is
rebuilt. Several sources compile in parallel, one ``nvcc`` each.

Nothing here runs at import: the CPU tests import every module, and there
is no ``nvcc`` where they run.
"""

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess

from seed_rl_torch.utils import compilation_cache

_PACKAGE = pathlib.Path(__file__).resolve().parents[2]
CSRC_DIR = _PACKAGE / "csrc"
# The default build directory; ``SEED_RL_TORCH_BUILD_DIR`` moves it.
BUILD_DIR = compilation_cache.DEFAULT_DIR / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

# Compiler output (ptxas register and spill report) of each build made by
# this process, by kernel name.
build_logs = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    candidate = os.path.join(home, "bin", "nvcc")
    if os.path.exists(candidate):
        return candidate
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found: set CUDA_HOME or put nvcc on PATH to build "
            "the CUDA kernels"
        )
    return found


def library_path(name: str) -> pathlib.Path:
    source = CSRC_DIR / f"{name}.cu"
    digest = hashlib.sha256(
        source.read_bytes() + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    return compilation_cache.build_dir("kernels") / f"{name}-{digest}.so"


def build(names) -> None:
    """Compiles every named source that is not built yet, all at once."""
    pending = [n for n in names if not library_path(n).exists()]
    if not pending:
        return
    nvcc = _nvcc()
    jobs = []
    for name in pending:
        target = library_path(name)
        tmp = target.with_name(f"{target.name}.{os.getpid()}.tmp")
        proc = subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")],
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            text=True,
        )
        jobs.append((name, target, tmp, proc))
    failures = []
    for name, target, tmp, proc in jobs:
        output, _ = proc.communicate()
        build_logs[name] = output
        if proc.returncode != 0:
            failures.append(f"{name}:\n{output}")
            continue
        os.replace(tmp, target)  # atomic: a reader never sees half a file
    if failures:
        raise RuntimeError("nvcc failed for " + "\n".join(failures))


def load_library(name: str) -> ctypes.CDLL:
    build([name])
    return ctypes.CDLL(str(library_path(name)))
