"""Collocation points × fit steps over the wall time of those steps: every
rung of the window, each timed from its call to fit's own host reads of its
results (rungs under the profiler left out)."""


def read(rec):
    if rec["kind"] != "fit":
        return None
    rungs = [r for r in rec["rungs"] if not r["traced"]]
    wall = sum(r["wall_s"] for r in rungs)
    return rec["n_points"] * sum(r["steps"] for r in rungs) / wall if wall > 0 else None
