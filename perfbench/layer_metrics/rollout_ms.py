"""rollout_ms: the rollout's span (``RolloutEngine.rollout``, CUDA events
around the call) a train step over the window, in ms."""


def read(run):
    ms = run.span_ms.get("rollout")
    return sum(ms) / run.steps if ms else None
