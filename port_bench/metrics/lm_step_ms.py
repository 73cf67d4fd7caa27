"""Wall time of every LM call of the window over the LM steps those calls
made, in ms (calls under the profiler left out)."""


def read(rec):
    if rec["kind"] != "lm":
        return None
    calls = [c for c in rec["calls"] if not c["traced"]]
    steps = sum(c["steps"] for c in calls)
    return 1e3 * sum(c["wall_s"] for c in calls) / steps if steps else None
