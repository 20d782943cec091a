"""update_ms: the learner's update spans (``VTraceLearner.update``,
``R2D2Learner.train_on_batch``; CUDA events around each call), summed
over a train step and averaged over the window, in ms."""


def read(run):
    ms = run.span_ms.get("update")
    return sum(ms) / run.steps if ms else None
