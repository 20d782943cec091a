"""core_memory_fill: the share of the GTrXL core's window its acting
queries attended, in %: the keys attended over the queries times
``memory_length + 1``, from the core's counters (device tensors that acting
updates in place, a CUDA graph's replays too) since set-up ended, read
after the window (and the traced steps after it). None where the program
has no such counters."""


def read(run):
    net = run.cell.learner.agent.net
    counters = getattr(net, "counters", None)
    start = run.cell.extra.get("counters")
    if counters is None or start is None:
        return None
    queries = int(counters["queries"]) - start["queries"]
    if queries <= 0:
        return None
    keys = int(counters["keys"]) - start["keys"]
    return 100.0 * keys / (queries * (net.memory_length + 1))
