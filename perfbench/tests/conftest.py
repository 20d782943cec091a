"""Shared pieces of the benchmark's CPU tests: a checkout of the benchmark's
files with the cells cut to a size the CPU runs in seconds."""

import json
import pathlib
import shutil
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

TINY_TRAFFIC = {
    "envs256_t32": {"num_envs": 4, "unroll_length": 5, "profile_steps": 2},
    "envs32_t32": {"num_envs": 3, "unroll_length": 4, "profile_steps": 2},
    "ratio075": {"num_envs": 8, "num_eval_envs": 2, "unroll_length": 6,
                 "burn_in": 2, "batches_per_step": 2, "profile_steps": 2},
    "ratio010": {"num_envs": 8, "num_eval_envs": 2, "unroll_length": 6,
                 "burn_in": 2, "batches_per_step": 1, "profile_steps": 2},
}
TINY_CONFIG = {"r2d2_atari": {"replay": {"size": 40, "min_size": 10}}}
TINY_LEARNER = {"r2d2_atari": {"batch_size": 4}}


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def tiny_checkout(directory: pathlib.Path, float32: bool = False
                  ) -> pathlib.Path:
    """``BENCHMARK.json`` and ``perfbench/`` copied under ``directory``,
    every traffic mix and configuration cut to ``TINY_*``; ``float32``:
    every part of every net computed in float32."""
    shutil.copy(ROOT / "BENCHMARK.json", directory / "BENCHMARK.json")
    shutil.copytree(ROOT / "perfbench", directory / "perfbench",
                    ignore=shutil.ignore_patterns(".cache", "tests",
                                                  "__pycache__"))
    for name, sizes in TINY_TRAFFIC.items():
        path = directory / "perfbench" / "traffic" / f"{name}.json"
        path.write_text(json.dumps(dict(json.loads(path.read_text()),
                                        **sizes)))
    for path in (directory / "perfbench" / "configs").glob("*.json"):
        config = json.loads(path.read_text())
        config.update(TINY_CONFIG.get(config["name"], {}))
        config["learner"].update(TINY_LEARNER.get(config["name"], {}))
        if float32:
            config["compute_dtypes"] = {part: "float32"
                                        for part in config["compute_dtypes"]}
        path.write_text(json.dumps(config))
    return directory
