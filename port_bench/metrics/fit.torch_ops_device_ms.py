"""Device ms per fit step in kernels that are not the port's own CUDA
kernels (namespace gpe::): the optimizer, fit's bookkeeping, the boundary
term, the fresh value sums. Copies and sets are not kernels."""


def read(rec):
    tr = rec.get("trace")
    if rec["kind"] != "fit" or tr is None:
        return None
    steps = sum(r["steps"] for r in rec["rungs"] if r["traced"])
    us = tr.device_us(lambda n: "gpe::" not in n
                      and not n.startswith(("Memcpy", "Memset")))
    return us * 1e-3 / steps
