"""The readings the limits of `correct` are set from, on the card at each
cell's own size: the program on many seeds (sound runs), the control (the
reference in the program's place, its GEMM operands rounded to TF32) and
each planted fault of port_bench/faults.py on a few seeds, each with the
verdict of the cell's limits. Not run by the benchmark's runs.

    python3 port_bench/controls.py --workload <name> --seeds 1 2 ... \
        [--control-seeds ...] [--fault-seeds ...] [--seconds <s>] [--out <file>]

One JSON line a reading: {"workload", "seed", "kind": "sound" | "control"
| <fault>, "correct", "readings": {...}}. A window follows each set-up, so
the answers of the window are read too: one rung or one cycle of calls, or
`--seconds` of them (the cell's `run_seconds`: a fit cell's last rung then
starts from params trained as in a run).
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def readings(name: str, seed: int, kind: str, device=None, overrides=None,
             seconds: float = 1e-6) -> dict:
    """One set-up, a window of `seconds` (at least one rung or one cycle of
    calls), and the comparison, with `kind` "sound", "control" (the control's outputs judged
    in the program's place) or a planted fault; `correct` is the verdict of
    the cell's limits on them."""
    from port_bench.run import _environment
    _environment(ROOT)
    import torch

    from port_bench import faults, harness

    dev = torch.device("cuda" if device is None else device)
    cell = harness.find_cell(ROOT, name, seed, dev)
    if overrides is not None:
        overrides(cell)
    drv = harness.driver(cell)
    planted = kind in faults.FAULTS + faults.LM_FAULTS
    with faults.planted(kind) if planted else contextlib.nullcontext():
        st = drv.setup(cell)
        rec = drv.window(cell, st, seconds, False)
    if kind == "control":
        got = drv.control_readings(cell, st, rec)
    else:
        got = drv.check(cell, st, rec)
    units = rec.get("rungs", rec.get("calls"))
    ok, _ = harness.judge(got, cell.limits)
    return {"workload": name, "seed": seed, "kind": kind, "correct": ok,
            "readings": got, "walls": [u["wall_s"] for u in units]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=1e-6)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    from port_bench import faults

    sink = open(args.out, "a") if args.out else None
    jobs = ([(s, "sound") for s in args.seeds]
            + [(s, "control") for s in args.control_seeds]
            + [(s, f) for f in faults.FAULTS for s in args.fault_seeds])
    for seed, kind in jobs:
        t0 = time.perf_counter()
        row = readings(args.workload, seed, kind, seconds=args.seconds)
        row["seconds"] = time.perf_counter() - t0
        line = json.dumps(row)
        print(line, flush=True)
        if sink:
            sink.write(line + "\n")
            sink.flush()
    return 0


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))
    raise SystemExit(main())
