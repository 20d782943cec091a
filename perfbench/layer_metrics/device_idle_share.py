"""device_idle_share: 1 - the union of device activity's intervals over
the traced window's length, in %."""


def read(run):
    trace = run.trace
    if trace is None or not trace.busy_s:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
