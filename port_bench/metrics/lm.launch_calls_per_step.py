"""Kernel launches outside the CUDA graph per LM step (the step's own vjp,
jvp and residual, CG's vector updates, the graph's capture and warm-up),
over the profiled call."""


def read(rec):
    tr = rec.get("trace")
    if rec["kind"] != "lm" or tr is None:
        return None
    steps = sum(c["steps"] for c in rec["calls"] if c["traced"])
    return (tr.launch_calls() - tr.graph_launches()) / steps
