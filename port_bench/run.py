"""Run one cell of the port's benchmark once and print its result line.

    python3 port_bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell (BENCHMARK.json's `workloads`) names a
configuration and a traffic mix; set-up builds the port's problem and the
seeded inputs and drives the window's own call through its first steps,
then the window runs for `--seconds`, then the reference judges what the
window produced. `--trace 0` reports the cell's end-to-end metrics,
`--trace 1` its per-layer metrics from a profiled part of the window.
The last line of standard output is one JSON object; the numbers compared
and their limits are also the last lines of standard error. Exits 2 with no
result without a CUDA card, and 3 if JAX or the JAX package was loaded.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def _environment(root: Path) -> None:
    """The port's path switches cleared, so the environment cannot change
    the measured path; the CUDA JIT cache inside the checkout."""
    for k in [k for k in os.environ if k.startswith("GPE_TPU_TORCH_")]:
        del os.environ[k]
    os.environ["CUDA_CACHE_PATH"] = str(root / "build" / "port_bench" / "cuda_cache")
    if str(root) not in sys.path:
        sys.path.insert(0, str(root))


def run_cell(name: str, seed: int, seconds: float, trace: bool, root: Path = ROOT,
             device=None, t_start: float = None, overrides=None) -> dict:
    """One run: the result dict (without printing). `device` None is the
    CUDA card; tests pass the CPU and `overrides` (a function that edits the
    Cell: a smaller size) and skip the card's checks."""
    _environment(root)
    import torch

    from port_bench import harness

    if t_start is None:
        t_start = time.perf_counter()
    dev = torch.device("cuda" if device is None else device)
    cell = harness.find_cell(root, name, seed, dev)
    if overrides is not None:
        overrides(cell)
    drv = harness.driver(cell)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    st = drv.setup(cell)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    setup_s = time.perf_counter() - t_start
    record = drv.window(cell, st, seconds, trace)
    record["setup_s"] = setup_s
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    found = harness.forbidden_modules()
    if found:
        raise harness.ForbiddenModules(", ".join(found))
    for k in ("batch", "vag", "solver", "loss_fn", "opt"):
        st.pop(k, None)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    readings = drv.check(cell, st, record)
    correct, rows = harness.judge(readings, cell.limits)
    units = record["rungs"] if record["kind"] == "fit" else record["calls"]
    failed = sum(1 for u in units if not harness.finite_answer(u))
    metrics = {}
    for m in harness.metrics_of(root, name, trace):
        v = harness.read_metric(m["name"], record)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    out = {"correct": bool(correct and failed == 0), "attempted": len(units),
           "failed": failed, "metrics": metrics}
    if dev.type == "cuda":
        out["device"] = {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
                         "count": 1, "memory_peak_bytes": int(peak)}
    else:
        out["device"] = {"platform": "cpu", "kind": "cpu", "count": 1,
                         "memory_peak_bytes": 0}
    if trace and record["trace"] is not None:
        from port_bench import trace as tracing

        tr = record["trace"]
        out["device"]["busy_s"] = tr.busy_us() * 1e-6
        out["device"]["window_s"] = tr.span_us() * 1e-6
        out["breakdown"] = tracing.breakdown(tr)
    if "path" in record:
        out["path"] = record["path"]
    out["checks"] = {k: {"value": v, "limit": lim} for k, v, lim in rows}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # one process with one CPU thread for torch's host ops: the timed paths
    # run none, and idle pool threads only compete for the host's cores
    os.environ["OMP_NUM_THREADS"] = "1"
    _environment(ROOT)
    import torch

    from port_bench import harness

    chips = {w["name"]: w for w in harness.load_benchmark(ROOT)["workloads"]}[
        args.workload]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    try:
        out = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                       t_start=T_START)
    except harness.ForbiddenModules as e:
        print(f"loaded in the process that would print the result: {e}",
              file=sys.stderr)
        return 3
    for k, c in out["checks"].items():
        print(f"check {k}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
