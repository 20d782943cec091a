"""replay_sample_ms: the replay's sample span (``PrioritizedReplay.sample``,
CUDA events around each call) a batch over the window, in ms."""


def read(run):
    ms = run.span_ms.get("sample")
    return sum(ms) / len(ms) if ms else None
