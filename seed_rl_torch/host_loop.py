"""Training loop for host-process environments, on-policy learners.

Port of ``seed_rl_tpu/host_loop.py``: drives a learner with
``init / update`` (V-trace, PPO) and a ``HostRolloutEngine``: the host
collects an unroll (env stepping on the host, policy steps on the device),
then ``update`` trains on it.
"""

from typing import Any, Dict, Tuple

from seed_rl_torch.utils import episode_stats


def host_learner_loop(
    learner,
    host_engine,
    total_environment_frames: int,
    logger=None,
    checkpoint=None,
    log_every_steps: int = 10,
    seed: int = 0,
    pipeline: bool = False,
) -> Tuple[Any, Dict[str, Any]]:
    """Trains until the frame budget; returns the final state and the last
    update's metrics.

    With ``pipeline=True`` the unroll for step k+1 is collected with the
    parameters from before update k: the engine's behaviour copy is
    refreshed before each update, and its rollout (on the engine's own
    stream on the card) runs while the device still executes the update.
    The reference's actors act on the parameters of the last completed
    update in the same way, and the loss weighs the stored behaviour
    policy. The last collected unroll is trained on after the loop,
    rather than discarding its env frames. Without it, each rollout sees
    the previous update's parameters (strictly on-policy).

    The episode-stat window resets only when a log line reports it. With
    a ``checkpoint`` manager the loop restores on start, offers a save
    after every step and forces one at the end.
    """
    state = learner.init()
    if checkpoint is not None:
        state = checkpoint.restore_or(learner, state)
    host_engine.publish(learner.agent)
    host_state = host_engine.init(seed=seed)

    metrics: Dict[str, Any] = {}
    frames_per_step = learner.frames_per_step
    pending = None  # the unroll awaiting training when pipelining
    while state.step * frames_per_step < total_environment_frames:
        host_engine.publish(learner.agent)
        if pipeline:
            if pending is None:
                host_state, pending = host_engine.rollout(host_state)
            state, metrics = learner.update(state, pending)
            host_state, pending = host_engine.rollout(host_state)
        else:
            host_state, unroll = host_engine.rollout(host_state)
            state, metrics = learner.update(state, unroll)
        step = state.step
        if logger is not None and step % log_every_steps == 0:
            stats = state.stats
            n = float(stats.num_episodes)
            if n > 0:
                metrics = dict(metrics)
                metrics["episodes/mean_return"] = float(stats.sum_return) / n
                metrics["episodes/mean_length"] = float(stats.sum_length) / n
                state = state._replace(
                    stats=episode_stats.reset_window(stats))
            logger.log(step, metrics, frames=step * frames_per_step)
        if checkpoint is not None:
            checkpoint.maybe_save(step, learner, state)
    if pipeline and pending is not None:
        state, metrics = learner.update(state, pending)
    if checkpoint is not None:
        checkpoint.maybe_save(state.step, learner, state, force=True)
    return state, metrics
