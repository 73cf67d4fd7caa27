"""CG iterations per LM step: each CG matvec replays the solver's CUDA graph
once, so the profiled call's graph launches over its steps."""


def read(rec):
    tr = rec.get("trace")
    if rec["kind"] != "lm" or tr is None:
        return None
    steps = sum(c["steps"] for c in rec["calls"] if c["traced"])
    return tr.graph_launches() / steps
