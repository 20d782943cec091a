"""The reading of the program's spans (``harness/program_trace.py``) on
hand-built event lists, its readers, and a traced run on the CPU."""

import io
import json
import sys
import types

import torch

from perfbench.harness import cell as cells
from perfbench.harness import program_trace as pt
from perfbench.harness import runner
from perfbench.tests.conftest import tiny_checkout

MS = 1_000_000  # ns
MAIN, BACKWARD = 1, 2
NEW = ["rollout_launches_per_step", "update_launches_per_step",
       "rollout_idle_ms", "update_idle_ms", "host_syncs_per_step",
       "torso_fwd_ms"]


def span(name, start, end, thread=MAIN, corr=0):
    return pt.Event("span", pt.PREFIX + name, thread, start * MS, end * MS,
                    corr)


def op(start, end, corr, thread=MAIN):
    return pt.Event("op", "aten::add", thread, start * MS, end * MS, corr)


def launch(op_corr, cupti, at, kernel=(90, 91)):
    """The runtime call at ``at`` (on the profiler's own thread id, as
    kineto gives it) and its kernel on the device at ``kernel``."""
    return [pt.Event("runtime", "cudaLaunchKernel", 77, at * MS,
                     at * MS + 1, cupti, op_corr),
            pt.Event("kernel", "k", 7, kernel[0] * MS, kernel[1] * MS, cupti,
                     op_corr)]


def sync(op_corr, cupti, at, name="cudaStreamSynchronize"):
    return pt.Event("runtime", name, 77, at * MS, at * MS + 1, cupti,
                    op_corr)


def test_a_launch_in_nested_spans_goes_to_the_innermost():
    events = [span("train_step", 0, 100, corr=1),
              span("rollout", 10, 60, corr=2),
              span("rollout.policy_step", 20, 30, corr=3),
              span("torso", 21, 29, corr=4),
              op(22, 28, corr=5),
              op(40, 50, corr=6),
              *launch(5, 500, 23), *launch(6, 501, 41, kernel=(92, 95))]
    table = pt.table(events)
    assert table["torso"]["self_launches"] == 1
    assert table["torso"]["device_ms"] == 1
    assert table["rollout.policy_step"]["self_launches"] == 0
    assert table["rollout.policy_step"]["launches"] == 1
    assert table["rollout"]["self_launches"] == 1
    assert table["rollout"]["launches"] == 2
    assert table["rollout"]["device_ms"] == 4
    assert table["train_step"]["launches"] == 2
    assert table["train_step"]["self_launches"] == 0
    assert table["rollout.policy_step"]["calls"] == 1
    assert table["rollout"]["host_ms"] == 50


def test_a_launch_placed_by_its_call_not_by_the_kernel():
    # The kernel runs long after its launch, while the host is elsewhere.
    events = [span("train_step", 0, 100, corr=1),
              span("rollout", 10, 20, corr=2),
              span("update", 30, 100, corr=3),
              op(11, 19, corr=4),
              *launch(4, 500, 12, kernel=(50, 60))]
    table = pt.table(events)
    assert table["rollout"]["launches"] == 1
    assert table["update"]["launches"] == 0


def test_an_operator_that_does_not_hold_the_call_gives_no_thread():
    # Another host event under the launching operator's id, on another
    # thread: the call's own thread is the launching one.
    events = [span("train_step", 0, 100, corr=1),
              span("update", 10, 90, corr=2),
              span("torso", 50, 60, thread=BACKWARD, corr=3),
              op(5, 6, corr=4, thread=BACKWARD),
              pt.Event("runtime", "cudaLaunchKernel", MAIN, 20 * MS,
                       20 * MS + 1, 500, 4),
              pt.Event("kernel", "k", 7, 90 * MS, 91 * MS, 500, 4)]
    table = pt.table(events)
    assert table["update"]["self_launches"] == 1
    assert table["torso"]["launches"] == 0


def test_a_backward_thread_launch_goes_to_the_span_open_on_the_caller():
    events = [span("train_step", 0, 100, corr=1),
              span("update", 10, 90, corr=2),
              span("update.backward", 20, 80, corr=3),
              op(30, 40, corr=4, thread=BACKWARD),
              # A checkpointed torso's recompute on the backward thread.
              span("torso", 50, 60, thread=BACKWARD, corr=5),
              op(52, 58, corr=6, thread=BACKWARD),
              *launch(4, 500, 31), *launch(6, 501, 53)]
    table = pt.table(events)
    assert table["update.backward"]["self_launches"] == 1
    assert table["torso"]["self_launches"] == 1
    assert table["update.backward"]["launches"] == 2
    assert table["update"]["launches"] == 2
    assert table["train_step"]["launches"] == 2
    # Idle is read on the main thread only.
    assert table["torso"]["idle_ms"] == 0


def test_syncs_count_inside_train_step_only():
    events = [span("train_step", 0, 100, corr=1),
              span("replay.update_priorities", 80, 90, corr=2),
              op(81, 89, corr=3), op(95, 99, corr=4), op(120, 130, corr=5),
              sync(3, 600, 82), sync(4, 601, 96, name="cudaMemcpy"),
              sync(4, 602, 97, name="cudaMemcpyAsync"),
              sync(5, 603, 121), sync(5, 604, 122, "cudaDeviceSynchronize")]
    table = pt.table(events)
    assert table["replay.update_priorities"]["syncs"] == 1
    assert table["train_step"]["syncs"] == 2
    assert pt.OUTSIDE not in table


def test_an_idle_gap_is_split_at_a_span_edge():
    events = [span("train_step", 0, 100, corr=1),
              span("rollout", 0, 50, corr=2),
              span("update", 50, 100, corr=3),
              pt.Event("kernel", "k", 7, 10 * MS, 20 * MS),
              pt.Event("device", "Memcpy HtoD", 7, 40 * MS, 70 * MS)]
    table = pt.table(events)
    # Idle: 0-10, 20-40 in the rollout; 70-100 in the update.
    assert table["rollout"]["idle_ms"] == 30
    assert table["update"]["idle_ms"] == 30
    assert table["train_step"]["idle_ms"] == 60


def test_values_are_per_train_step():
    events = [span("train_step", 0, 100, corr=1), op(1, 2, corr=2),
              span("train_step", 100, 200, corr=3), op(101, 102, corr=4),
              *launch(2, 500, 1), *launch(4, 501, 101, kernel=(150, 151)),
              *launch(4, 502, 101, kernel=(151, 152))]
    table = pt.table(events)
    assert table["train_step"]["launches"] == 1.5
    assert table["train_step"]["calls"] == 1
    assert table["train_step"]["idle_ms"] == (99 + 98) / 2


def _readers(events):
    run = types.SimpleNamespace(program_spans=pt.table(events))
    return {name: cells.module("layer_metrics", name).read(run)
            for name in NEW}


def test_readers_give_none_without_program_spans():
    events = [op(0, 10, corr=1), *launch(1, 500, 1),
              sync(1, 501, 2)]
    assert pt.table(events) is None
    assert set(_readers(events).values()) == {None}


def test_no_sync_reads_zero_not_none():
    events = [span("train_step", 0, 100, corr=1),
              span("rollout", 0, 50, corr=2), span("update", 50, 100, corr=3),
              span("torso", 10, 20, corr=4), op(11, 19, corr=5),
              *launch(5, 500, 12, kernel=(12, 15))]
    values = _readers(events)
    assert values["host_syncs_per_step"] == 0
    assert values["host_syncs_per_step"] is not None
    assert values["rollout_launches_per_step"] == 1
    assert values["update_launches_per_step"] == 0
    assert values["torso_fwd_ms"] == 3
    assert values["rollout_idle_ms"] == 47
    assert values["update_idle_ms"] == 50


def test_a_program_without_spans_is_not_traced(monkeypatch):
    # The parent program: ``seed_rl_torch.utils.profiling`` has no
    # ``recording``.
    monkeypatch.setitem(sys.modules, "seed_rl_torch.utils.profiling",
                        types.ModuleType("seed_rl_torch.utils.profiling"))
    cell = types.SimpleNamespace(learner=None, state=None)
    assert pt.trace(cell, 2, torch.device("cpu")) is None


def test_a_traced_run_on_the_cpu_reports_the_new_metrics(tmp_path):
    root = tiny_checkout(tmp_path, float32=True)
    out, err = io.StringIO(), io.StringIO()
    args = types.SimpleNamespace(workload="r2d2_atari.ratio010", seed=2**31,
                                 seconds=0.2, trace=1)
    assert runner.run(args, 0.0, device=torch.device("cpu"), root=root,
                      out=out, err=err) == 0
    line = json.loads(out.getvalue().splitlines()[-1])
    assert line["correct"] is True
    metrics = line["metrics"]
    assert set(NEW) <= set(metrics)
    # No kernels on the CPU: no launches and no device time; the host is
    # never waited on.
    assert metrics["rollout_launches_per_step"]["value"] == 0
    assert metrics["host_syncs_per_step"]["value"] == 0
    assert metrics["rollout_idle_ms"]["value"] > 0
    assert metrics["update_idle_ms"]["value"] > 0


def test_the_table_of_a_cell_on_the_cpu(tmp_path):
    root = tiny_checkout(tmp_path, float32=True)
    table = pt.cell_table("dmlab_vtrace.envs256_t32", 2**31 + 3,
                          torch.device("cpu"), root)
    # 5 env steps a rollout (TINY_TRAFFIC), a torso in each policy step
    # and one in the loss.
    assert table["train_step"]["calls"] == 1
    assert table["rollout.policy_step"]["calls"] == 5
    assert table["rollout.env_step"]["calls"] == 5
    assert table["torso"]["calls"] == 6
    assert table["update.loss"]["calls"] == 1
    assert table["train_step"]["launches"] == 0


class _Kineto:
    """A stand-in for one of ``kineto_results.events()``."""

    def __init__(self, name, device, thread, start, end, corr, linked=0):
        self._row = (name, device, thread, start * MS, (end - start) * MS,
                     corr, linked)

    def name(self):
        return self._row[0]

    def device_type(self):
        return self._row[1]

    def start_thread_id(self):
        return self._row[2]

    def start_ns(self):
        return self._row[3]

    def duration_ns(self):
        return self._row[4]

    def correlation_id(self):
        return self._row[5]

    def linked_correlation_id(self):
        return self._row[6]


def test_kineto_events_are_read_by_kind():
    from torch.autograd import DeviceType

    cpu, cuda = DeviceType.CPU, DeviceType.CUDA
    events = pt._events_of([
        _Kineto("seed_rl_torch.train_step", cpu, MAIN, 0, 100, 1),
        _Kineto("seed_rl_torch.update", cpu, MAIN, 10, 90, 2),
        _Kineto("aten::nonzero", cpu, MAIN, 20, 30, 3),
        # A runtime call with no operator, under an operator's id.
        _Kineto("cudaDeviceSynchronize", cpu, MAIN, 40, 41, 2),
        _Kineto("cudaStreamSynchronize", cpu, MAIN, 21, 22, 501, 3),
        _Kineto("Activity Buffer Request", cpu, MAIN, 0, 60, 3),
        _Kineto("cudaLaunchKernel", cpu, MAIN, 23, 24, 502, 3),
        _Kineto("k", cuda, 7, 50, 51, 502, 3),
        _Kineto("Memcpy DtoH (Device -> Pinned)", cuda, 7, 52, 53, 0),
        # The device's mirror of a host range.
        _Kineto("seed_rl_torch.update", cuda, 7, 10, 90, 2),
    ])
    kinds = [(e.kind, e.name) for e in events]
    assert ("runtime", "cudaDeviceSynchronize") in kinds
    assert ("op", "aten::nonzero") in kinds
    assert ("kernel", "k") in kinds
    assert ("device", "Memcpy DtoH (Device -> Pinned)") in kinds
    assert [k for k, n in kinds if n == "seed_rl_torch.update"] == ["span"]
    table = pt.table(events)
    assert table["update"]["syncs"] == 2
    assert table["update"]["self_launches"] == 1
