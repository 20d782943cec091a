"""Off-policy training loop: host envs, host-RAM replay, device training.

Port of ``seed_rl_tpu/host_offpolicy.py``, the rebuilt data plane of the
reference's R2D2 and SAC learners: acting and training are decoupled
through a host-RAM replay under the replay-ratio contract (each stored
item is trained on ``replay_ratio`` times in expectation; the reference's
``insertion_batch = batch_size / replay_ratio``). The threads:
- the main thread: a rollout (``HostRolloutEngine``), the unroll turned into
  items and initial priorities on the device, the insert into host RAM,
  then the cycle's owed batches;
- the replay's prefetch thread: draws, gathers and copies batch k+1 while
  batch k trains; batch k's priorities are written back after batch k+1
  is drawn (the reference's staleness window);
- with ``pipeline=True``, a rollout thread that steps the envs and the
  policy for cycle k+1 while the main thread trains on cycle k.

Works with any learner that has ``init()``, ``agent``,
``num_training_envs``, ``batch_size``, ``priority_exponent``,
``frames_per_cycle``, ``make_items_and_priorities(unroll)`` and
``train_on_batch(state, items, weights)`` (and optionally
``on_unroll(state, unroll)``): ``R2D2HostLearner`` and ``SACHostLearner``.
"""

import queue
import threading
import time
from typing import Any, Dict, Optional, Tuple

import torch
import torch.utils._pytree as pytree

from seed_rl_torch.replay_host import HostReplayBuffer
from seed_rl_torch.utils import episode_stats


def _window_means(window_logs):
    return {k: float(torch.mean(torch.stack([log[k] for log in window_logs])))
            for k in window_logs[0]}


class _RolloutThread:
    """Steps the host envs and the policy in the background, one unroll
    ahead: a queue of one bounds both the behaviour parameters' staleness
    and the env frames lost at shutdown. An error in the thread reaches
    the main thread through ``next``."""

    def __init__(self, engine, host_state):
        self._engine = engine
        self._queue = queue.Queue(maxsize=1)
        self._stop = threading.Event()
        self._error = []
        self._thread = threading.Thread(target=self._run, args=(host_state,),
                                        daemon=True)
        self._thread.start()

    def _run(self, host_state):
        try:
            while not self._stop.is_set():
                host_state, unroll = self._engine.rollout(host_state)
                while not self._stop.is_set():
                    try:
                        self._queue.put(unroll, timeout=0.5)
                        break
                    except queue.Full:
                        continue
        except BaseException as e:  # reaches the main thread through next()
            self._error.append(e)

    def next(self):
        """The next unroll; bounded waits, so a dead thread raises its
        error instead of the main thread waiting forever."""
        while True:
            try:
                return self._queue.get(timeout=5.0)
            except queue.Empty:
                if self._error:
                    raise RuntimeError(
                        "pipelined rollout worker died") from self._error[0]
                if not self._thread.is_alive():
                    raise RuntimeError(
                        "pipelined rollout worker exited unexpectedly")

    def stop(self):
        self._stop.set()
        try:  # unblock a producer waiting on a full queue
            self._queue.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=30)
        if self._thread.is_alive():
            raise RuntimeError("pipelined rollout worker did not stop")
        if self._error:
            raise RuntimeError(
                "pipelined rollout worker died") from self._error[0]


def train_owed(learner, replay, state, owed: float, new_items: float,
               max_batches: Optional[int] = None):
    """The replay-ratio contract of one cycle: adds ``new_items / batch_size``
    batches to the ``owed`` carry (``new_items`` is replay_ratio x the items
    the cycle inserted) and trains the whole ones (at most ``max_batches``),
    each on a prioritized sample whose priorities it writes back. Returns
    (state, the carry left, each trained batch's logs).
    """
    owed += new_items / learner.batch_size
    budget = int(owed)
    if max_batches is not None:
        budget = min(budget, max_batches)
    priority_exp = learner.priority_exponent
    batch_logs = []
    for k in range(budget):
        owed -= 1.0
        if replay._prefetch_thread is None:
            replay.sample_async(learner.batch_size, priority_exp)
        indices, weights, batch = replay.wait_sample()
        state, new_priorities, logs = learner.train_on_batch(
            state, batch, torch.as_tensor(weights, device=learner.device))
        # Draw and copy the next batch while this one trains, before
        # waiting for its priorities.
        if k + 1 < budget:
            replay.sample_async(learner.batch_size, priority_exp)
        if priority_exp:
            replay.update_priorities(indices, new_priorities)
        batch_logs.append(logs)
    return state, owed, batch_logs


def host_offpolicy_loop(
    learner,
    host_engine,
    replay: HostReplayBuffer,
    total_environment_frames: int,
    replay_ratio: float,
    replay_buffer_min_size: int,
    logger=None,
    checkpoint=None,
    log_every_cycles: int = 10,
    seed: int = 0,
    max_train_batches_per_cycle: Optional[int] = None,
    pipeline: bool = False,
    replay_dir: Optional[str] = None,
) -> Tuple[Any, Dict[str, Any]]:
    """Trains until the frame budget; returns the final train state and the
    last batch's logs.

    Once the replay holds ``replay_buffer_min_size`` items, each cycle owes
    ``replay_ratio * num_training_envs / batch_size`` batches; the fraction
    carries over in a Python float, so a non-integer ratio is honoured
    exactly (capped at ``max_train_batches_per_cycle`` a cycle).

    With ``pipeline=True`` the rollout thread acts with the parameters
    published after the last cycle's training (one cycle stale); the
    off-policy losses read the stored behaviour outputs, so staleness only
    shifts exploration, as with the reference's remote actors.

    With a ``checkpoint`` manager the loop restores on start and offers a
    save after every cycle; with ``replay_dir`` the replay is restored
    before the first rollout and saved beside every checkpoint save.
    """
    num_envs = host_engine.env.num_envs
    num_training = learner.num_training_envs
    state = learner.init()
    if checkpoint is not None:
        state = checkpoint.restore_or(learner, state)
    if replay_dir is not None and replay.restore(replay_dir):
        print(f"Restored replay buffer from {replay_dir}: "
              f"{replay.num_inserted} items, "
              f"{replay.nbytes() / 2**30:.2f} GiB", flush=True)
    host_engine.publish(learner.agent)
    host_state = host_engine.init(seed=seed)
    on_unroll = getattr(learner, "on_unroll", None)

    first_new = host_engine.overlap + 1  # timesteps [o+1:] are new
    device = learner.device
    stats = episode_stats.init(num_training, device)
    eval_stats = episode_stats.init(max(num_envs - num_training, 1), device)

    owed = 0.0
    cycles = 0
    frames = 0
    window_logs = []
    logs: Dict[str, Any] = {}
    rollout_wait_s = 0.0
    train_s = 0.0
    worker = _RolloutThread(host_engine, host_state) if pipeline else None
    try:
        while frames < total_environment_frames:
            t0 = time.perf_counter()
            if worker is not None:
                unroll = worker.next()
            else:
                host_state, unroll = host_engine.rollout(host_state)
            rollout_wait_s += time.perf_counter() - t0
            if on_unroll is not None:
                # Folds fresh observations into the statistics: the policy
                # changed without an optimizer step, so publish it again.
                state = on_unroll(state, unroll)
                host_engine.publish(learner.agent)
            items, priorities = learner.make_items_and_priorities(unroll)
            replay.insert(items, priorities)
            new_steps = pytree.tree_map(lambda x: x[first_new:],
                                        unroll.timesteps.env_output)
            stats = episode_stats.update(stats, pytree.tree_map(
                lambda x: x[:, :num_training], new_steps))
            if num_envs > num_training:
                eval_stats = episode_stats.update(eval_stats, pytree.tree_map(
                    lambda x: x[:, num_training:], new_steps))
            cycles += 1
            frames += learner.frames_per_cycle

            if replay.num_inserted >= replay_buffer_min_size:
                t1 = time.perf_counter()
                state, owed, batch_logs = train_owed(
                    learner, replay, state, owed,
                    replay_ratio * num_training, max_train_batches_per_cycle)
                if batch_logs:
                    window_logs.extend(batch_logs)
                    logs = batch_logs[-1]
                    host_engine.publish(learner.agent)
                train_s += time.perf_counter() - t1

            if logger is not None and cycles % log_every_cycles == 0:
                metrics = {}
                if window_logs:
                    metrics.update(_window_means(window_logs))
                    window_logs = []
                # A window lasts until an episode completes in it.
                n = float(stats.num_episodes)
                if n > 0:
                    metrics["episodes/mean_return"] = float(
                        stats.sum_return) / n
                    metrics["episodes/mean_length"] = float(
                        stats.sum_length) / n
                    stats = episode_stats.reset_window(stats)
                n_eval = float(eval_stats.num_episodes)
                if n_eval > 0:
                    metrics["eval_episodes/mean_return"] = float(
                        eval_stats.sum_return) / n_eval
                    metrics["eval_episodes/mean_length"] = float(
                        eval_stats.sum_length) / n_eval
                    eval_stats = episode_stats.reset_window(eval_stats)
                metrics["replay/num_inserted"] = replay.num_inserted
                metrics["replay/ram_gb"] = round(replay.nbytes() / 2**30, 3)
                # With pipeline=True, rollout_wait is the time the loop
                # waited for env data; train is the training span.
                metrics["time/rollout_wait_s"] = round(rollout_wait_s, 4)
                metrics["time/train_s"] = round(train_s, 4)
                rollout_wait_s = train_s = 0.0
                logger.log(state.step, metrics, frames=frames)
            if checkpoint is not None:
                # The replay rides the checkpoint cadence, so a restart
                # resumes with both the parameters and the experience.
                if checkpoint.maybe_save(state.step, learner, state):
                    if replay_dir is not None:
                        replay.save(replay_dir)
    finally:
        if worker is not None:
            worker.stop()
    if checkpoint is not None:
        checkpoint.maybe_save(state.step, learner, state, force=True)
        if replay_dir is not None:
            replay.save(replay_dir)
    return state, logs
