"""launches_per_step: kernels launched a train step in the trace."""


def read(run):
    trace = run.trace
    if trace is None or not trace.launches:
        return None
    return trace.launches / trace.steps
