"""CUDA runtime calls that launch device work (kernels and graphs) per fit
step, over the profiled rung (its init_state and best-params read-back
included), from the profiler's runtime events."""


def read(rec):
    tr = rec.get("trace")
    if rec["kind"] != "fit" or tr is None:
        return None
    steps = sum(r["steps"] for r in rec["rungs"] if r["traced"])
    return tr.launch_calls() / steps
