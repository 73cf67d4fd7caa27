"""Share (%) of the profiled LM call's span in which nothing ran on the
card: one less the union of the device's activity intervals over the span."""


def read(rec):
    tr = rec.get("trace")
    if rec["kind"] != "lm" or tr is None:
        return None
    s = tr.idle_share()
    return None if s is None else 100.0 * s
