"""Is the numeric base's card result steady? `physics/numeric.py:
SineSeries2D` (the committed lattice γ = 0 state, `runs/gpe2d_lattice/
oracle_cache.npz`) at `gpe2d_lattice_plpinn`'s 16,384 points, in float64, on
the card against the CPU, call after call, in fresh processes.

Each process (`--child`) evaluates the series `--calls` times on the card
and once on the CPU and reports, per call, the max |card − CPU| of value,
∇ and Δ over each field's max |·| (chip_smoke.py 12b's reading), whether
the call is bitwise equal to the process's first and second, and a digest
of the first call's bits. `--order` says what the process does first:
"cold" (the series is the process's first work on the card, on points
made on the CPU) or "batch" (as 12b: `make_batch` on the card, whose base
triple evaluates the series there, then the calls on its points). The
parent runs `--procs` children of each order and prints one JSON object:
the first calls' and the later calls' largest errors, and whether the card
varied within a process or across processes.

Run on the card:
    python -m gpe_tpu_torch.experiments.numeric_probe [--procs 4] [--calls 50]
On the CPU (both sides CPU, every reading 0): add --cpu.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CACHE = os.path.join(ROOT, "runs", "gpe2d_lattice", "oracle_cache.npz")


def _fields(t) -> list:
    return [t.value, t.grad, t.lap]


def probe(calls: int, order: str, device) -> dict:
    """One process's readings (see the module docstring)."""
    import numpy as np
    import torch

    from gpe_tpu_torch.experiments import gpe2d_lattice_plpinn as lp
    from gpe_tpu_torch.physics.numeric import register_numeric_basis
    from gpe_tpu_torch.train.problem import make_batch

    series, lb, ub = lp.lattice_base(np.load(CACHE))
    spec = lp.lattice_spec(register_numeric_basis("probe", series), lb, ub)
    if order == "cold":
        x = make_batch(spec, 0, device="cpu")["x"].double().to(device)
    elif order == "batch":
        x = make_batch(spec, 0, device=device)["x"].double()
    else:
        raise ValueError(f"order {order!r}: 'cold' or 'batch'")
    runs, seconds = [], []
    for _ in range(calls):
        t0 = time.perf_counter()
        runs.append([f.cpu() for f in _fields(series(x))])
        seconds.append(time.perf_counter() - t0)
    cpu = _fields(series(x.cpu()))
    err = [[float((a - b).abs().max() / b.abs().max()) for a, b in zip(r, cpu)]
           for r in runs]
    same = lambda r, s: all(torch.equal(a, b) for a, b in zip(r, s))  # noqa: E731
    digest = hashlib.sha256(b"".join(f.numpy().tobytes() for f in runs[0])).hexdigest()
    return {"order": order, "calls": calls, "err": err,
            "equal_first": [same(r, runs[0]) for r in runs],
            "equal_second": [same(r, runs[1]) for r in runs[1:]] if calls > 1 else [],
            "digest_first": digest[:16], "first_ms": 1e3 * seconds[0],
            "later_ms": 1e3 * min(seconds[1:] or seconds),
            "device": str(device)}


def summarize(readings: list) -> dict:
    """The parent's verdict over the children's readings: the first calls'
    and the later calls' largest errors; whether a later call differed from
    the second ("later_calls_vary") or the first from the second
    ("first_call_differs") in any process; the first calls' digests."""
    later = [max(max(e) for e in r["err"][1:]) for r in readings if r["calls"] > 1]
    return {"procs": len(readings), "calls": readings[0]["calls"],
            "first_err": [max(r["err"][0]) for r in readings],
            "later_max_err": max(later or [0.0]),
            "later_calls_vary": not all(all(r["equal_second"]) for r in readings),
            "first_call_differs": not all(r["equal_first"][1:2] == [True]
                                          for r in readings if r["calls"] > 1),
            "digests": sorted({r["digest_first"] for r in readings}),
            "first_ms": [r["first_ms"] for r in readings],
            "later_ms": min(r["later_ms"] for r in readings)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--procs", type=int, default=4)
    ap.add_argument("--calls", type=int, default=50)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--child", choices=("cold", "batch"), default=None)
    args = ap.parse_args(argv)
    if args.child:
        import torch

        from gpe_tpu_torch.device import resolve_device
        print(json.dumps(probe(args.calls, args.child,
                               torch.device("cpu") if args.cpu else resolve_device())))
        return 0
    out = {}
    for order in ("cold", "batch"):
        readings = []
        for _ in range(args.procs):
            cmd = [sys.executable, "-m", "gpe_tpu_torch.experiments.numeric_probe",
                   "--child", order, "--calls", str(args.calls)] + \
                  (["--cpu"] if args.cpu else [])
            res = subprocess.run(cmd, capture_output=True, text=True, check=True,
                                 cwd=ROOT, timeout=600)
            readings.append(json.loads(res.stdout.strip().splitlines()[-1]))
        out[order] = summarize(readings)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
