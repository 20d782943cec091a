"""Finds a cell's parts by the names ``BENCHMARK.json`` gives them.

- the configuration: the file its ``configs`` entry names, a JSON object
  that names its builder (``builders/<builder>.py``) and its plain
  reference (``reference/<reference>.py``);
- the traffic mix: ``traffic/<traffic>.json``;
- a per-layer metric: ``layer_metrics/<name>.py``, whose ``read(run)``
  returns the metric or None where the run holds nothing to read.

A new configuration, mix or metric is a new file: nothing here changes.
"""

import dataclasses
import importlib.util
import json
import pathlib
from typing import Any, Dict, List, Tuple

ROOT = pathlib.Path(__file__).resolve().parents[2]
PACKAGE = ROOT / "perfbench"


def load_json(path: pathlib.Path):
    with open(path) as f:
        return json.load(f)


def benchmark(root: pathlib.Path = ROOT) -> Dict[str, Any]:
    return load_json(root / "BENCHMARK.json")


def _entry(entries: List[dict], name: str, what: str) -> dict:
    for entry in entries:
        if entry["name"] == name:
            return entry
    raise KeyError(f"BENCHMARK.json has no {what} named {name!r}")


def workload(bench: dict, name: str) -> dict:
    return _entry(bench["workloads"], name, "workload")


def config(bench: dict, name: str, root: pathlib.Path = ROOT) -> dict:
    return load_json(root / _entry(bench["configs"], name, "config")["file"])


def traffic(name: str, root: pathlib.Path = ROOT) -> dict:
    return load_json(root / "perfbench" / "traffic" / f"{name}.json")


def module(kind: str, name: str, root: pathlib.Path = ROOT):
    """``perfbench/<kind>/<name>.py``, loaded by its path."""
    path = root / "perfbench" / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"perfbench.{kind}.{name}", path)
    if spec is None or not path.exists():
        raise FileNotFoundError(path)
    loaded = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(loaded)
    return loaded


def metrics_of(bench: dict, cell_name: str, kind: str) -> List[dict]:
    """The ``end_to_end`` or ``per_layer`` metrics a cell reports: those
    that list it, or list no cells."""
    return [m for m in bench[kind]
            if cell_name in m.get("workloads", [cell_name])]


@dataclasses.dataclass
class Cell:
    """One cell built on the device, as a builder hands it to the runner."""

    learner: Any
    state: Any
    frames_per_step: int
    # (owner, method name, span name): the calls the runner times.
    spans: List[Tuple[Any, str, str]]
    # The window's per-step loss in the learner's metrics.
    loss_key: str
    # Frozen counts of one train step: model FLOPs, the convolutions'
    # bound and each hand kernel's bound (by a part of its name), seconds.
    flops_per_step: float
    conv_seconds_per_step: float
    kernel_seconds_per_step: Dict[str, float]
    # What the builder's ``check_steps`` reads beside the program: the
    # weights drawn (by the reference's names), the program's names of its
    # leaves, the leaves as the first step finds them, and what else the
    # builder keeps for its check (R2D2: how set-up filled the replay).
    theta0: Dict[str, Any] = dataclasses.field(default_factory=dict)
    names: List[str] = dataclasses.field(default_factory=list)
    start: List[Any] = dataclasses.field(default_factory=list)
    extra: Dict[str, Any] = dataclasses.field(default_factory=dict)
