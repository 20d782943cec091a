"""The CUDA kernels' launch plans, checked on the CPU.

Each wrapper picks its kernel's row chunking from the shape
(``launch_plan``) and passes it to the kernel. The kernel takes its block
shape and shared memory from its own constants and the plan, and refuses a
plan past the maxima it is built for; ``tests/test_torch_cuda.py`` checks
the launch it makes on the card. These tests check what the wrappers
decide, for every T up to 4096: that the chunks cover each row exactly
once, that each chunk stages the rows its results need, and that no plan
passes the kernels' maxima. Also the run counter both wrappers share
(``run_count``), on CPU counters.
"""

import numpy as np
import pytest
import torch

from seed_rl_torch.ops.cuda import nstep_kernel, run_count, vtrace_kernel

MAX_T = 4096


def _row_counts(rows, starts, chunk):
    """Rows written when chunk k takes rows [starts[k], starts[k] + chunk),
    cut at ``rows``."""
    counts = np.zeros(rows, dtype=np.int64)
    for s in starts:
        counts[s:min(s + chunk, rows)] += 1
    return counts


def test_vtrace_plan_covers_each_row_once():
    for T in range(1, MAX_T + 1):
        chunk, buffers = vtrace_kernel.launch_plan(T)
        assert 1 <= chunk <= vtrace_kernel.MAX_CHUNK, T
        # The kernel walks chunks from the last, c = ceil(T / chunk) - 1,
        # down to 0; a second buffer takes the copies of the chunk before.
        chunks = -(-T // chunk)
        starts = [c * chunk for c in range(chunks - 1, -1, -1)]
        assert (_row_counts(T, starts, chunk) == 1).all(), T
        assert buffers == (1 if chunks == 1 else 2), T


@pytest.mark.parametrize("n_steps", (1, 2, 5, 64, 65, 80, 100, 10_000))
def test_nstep_plan_covers_each_row_once(n_steps):
    halo = min(n_steps - 1, nstep_kernel.MAX_HALO)
    for T in range(2, MAX_T + 1):
        chunk, window = nstep_kernel.launch_plan(T, n_steps)
        assert 1 <= chunk <= nstep_kernel.MAX_CHUNK, T
        assert (chunk <= window
                <= nstep_kernel.MAX_CHUNK + nstep_kernel.MAX_HALO), T
        rows = T - 1  # target rows
        starts = range(0, rows, chunk)
        assert (_row_counts(rows, starts, chunk) == 1).all(), T
        for t0 in starts:
            # Target row t nests rewards and done of rows t+1 .. t+n, those
            # below T. The chunk stages rows t0+1 .. t0+min(window, rows-t0)
            # of them: all where the halo holds n-1 rows, else the first
            # halo rows past the chunk (the kernel reads the rest from
            # device memory).
            last_needed = min(t0 + min(chunk, rows - t0) - 1 + n_steps, rows)
            last_staged = t0 + min(window, rows - t0)
            assert last_staged == min(last_needed, t0 + chunk + halo, rows)


@pytest.mark.parametrize("plan,want", [
    # The V-trace path: unroll 32 (1024 envs), one chunk, one buffer.
    (lambda: vtrace_kernel.launch_plan(32), (32, 1)),
    # The R2D2 loss and insert: unroll 80 + 1 after the burn-in, n = 5: one
    # chunk of 80 target rows whose window is cut at T - 1.
    (lambda: nstep_kernel.launch_plan(81, 5), (80, 80)),
    # A long unroll: full chunks, and the n - 1 row halo.
    (lambda: nstep_kernel.launch_plan(300, 5), (128, 132)),
])
def test_plans_at_the_path_shapes(plan, want):
    assert tuple(plan()) == want


@pytest.mark.parametrize("plan", [
    lambda: vtrace_kernel.launch_plan(0),
    lambda: nstep_kernel.launch_plan(1, 5),
    lambda: nstep_kernel.launch_plan(8, 0),
])
def test_plans_refuse_empty_shapes(plan):
    with pytest.raises(ValueError):
        plan()


def test_runs_are_counted_per_kernel_and_reset_in_place():
    cpu = torch.device("cpu")
    for _ in range(3):
        run_count.add("counted_a", cpu)
    run_count.add("counted_b", cpu)
    assert run_count.read("counted_a") == 3
    assert run_count.read("counted_b") == 1
    counter = run_count._counts["counted_a", cpu]
    run_count.reset()
    assert run_count.read("counted_a") == run_count.read("counted_b") == 0
    # Zeroed in place: a graph that captured an add keeps adding to it.
    assert run_count._counts["counted_a", cpu] is counter
    run_count.add("counted_a", cpu)
    assert run_count.read("counted_a") == 1
