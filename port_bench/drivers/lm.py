"""The LM window: calls of the port's `train/gauss_newton.py:make_lm_solver`
solver on `make_gpe_residual_fn(spec)` at the configuration's last polish
γ, each call starting afresh from one of a fixed set of starts.

Traffic keys: `refine`, `call_steps`, `cg_iters`, `check_steps` (how many
steps of a call the reference follows), `weights_seeds` (the starts).

The LM's work a step is CG's iterations to its 1e-5 stop, and in float32
they follow the inputs chaotically: weights drawn from different seeds made
one call take twice as long as another, and the same weights with the
points summed in another order parted within a few steps, CG counts and
all. So every seed gets the same work: the starts are the weights of the
traffic's `weights_seeds` on the points in the grid's order, every call
starts afresh from one of them (a faster solver does the same work, not
more of the polish), and the window runs whole cycles of calls, one from
each start, in an order drawn from the run's seed. Set-up makes the starts,
their perturbation scales and the batch, builds the window's solver, and
warms every shape with a call of a solver of `check_steps` steps.
"""
from __future__ import annotations

import time

from port_bench import harness


def setup(cell) -> dict:
    import torch

    from gpe_tpu_torch.train.gauss_newton import make_gpe_residual_fn, make_lm_solver

    tr, cfg = cell.traffic, cell.config
    n_side = cfg["spec"]["n_points"] * tr["refine"]
    spec, batch = harness.program_problem(cell, n_side)
    starts = [harness.seeded_params(spec.layers, s, cell.device)
              for s in tr["weights_seeds"]]
    scales = [harness.perturb_scale(p, cell, n_side) for p in starts]
    gamma = float(cfg["polish_gammas"][-1])
    residual = make_gpe_residual_fn(spec)
    solver = make_lm_solver(residual, starts[0], steps=tr["call_steps"],
                            cg_iters=tr["cg_iters"])
    warm = make_lm_solver(residual, starts[0], steps=tr["check_steps"],
                          cg_iters=tr["cg_iters"])
    warm(starts[0], batch, gamma, scales[0])
    g = torch.Generator().manual_seed(cell.seed % 2 ** 63)
    order = torch.randperm(len(starts), generator=g).tolist()
    return {"spec": spec, "batch": batch, "starts": starts, "scales": scales,
            "n_side": n_side, "solver": solver, "gamma": gamma, "order": order}


def _cycle(st, calls: list, traced: bool) -> None:
    """One call from each start, in the seed's order."""
    for i in st["order"]:
        t0 = time.perf_counter()
        res = st["solver"](st["starts"][i], st["batch"], st["gamma"], st["scales"][i])
        calls.append({"wall_s": time.perf_counter() - t0,
                      "steps": len(res.loss_history), "start": i, "params": res.params,
                      "losses": [float(v) for v in res.loss_history], "traced": traced})


def window(cell, st, seconds: float, trace: bool) -> dict:
    """Whole cycles of calls until `seconds` have passed (traced: the second
    cycle under the profiler, and at least three cycles). Each call ends in
    its own host read of the loss history."""
    from port_bench import trace as tracing

    calls, traced = [], None
    t_start = time.perf_counter()
    k = 0
    while k == 0 or time.perf_counter() - t_start < seconds or (trace and k < 3):
        if trace and k == 1:
            _, traced = tracing.profiled(lambda: _cycle(st, calls, True))
        else:
            _cycle(st, calls, False)
        k += 1
    return {"kind": "lm", "calls": calls, "trace": traced,
            "n_points": st["n_side"] ** 2, "layers": list(st["spec"].layers),
            "n_boundary": int(st["batch"]["bx"].shape[0]),
            "cg_iters": cell.traffic["cg_iters"],
            "window_s": time.perf_counter() - t_start}


def followed(cell, st, steps: int, tf32: bool = False) -> list:
    """The reference's own run of `steps` steps from each start, in float32
    (TF32 GEMM operands with tf32=True: the control)."""
    import torch

    prob = harness.reference_problem(cell, st["n_side"], torch.float32)
    ref = harness.reference_of(cell)
    return [ref.lm_steps(p, prob, st["gamma"], s, steps, cell.traffic["cg_iters"],
                         tf32=tf32)
            for p, s in zip(st["starts"], st["scales"])]


def step_readings(got: list, ref: list) -> dict:
    """The first steps' losses of `got` (a call from each start: the
    program's, or the control's) against the reference's from that start."""
    return {"step_loss": max(harness.rel_gap(a, b)
                             for g, r in zip(got, ref)
                             for a, b in zip(g["losses"], r["losses"]))}


def answer_readings(cell, st, calls: list) -> dict:
    """Every call's answer: the loss it reports at its last step against the
    reference's float64 loss at the params it returned."""
    prob = harness.reference_problem(cell, st["n_side"])
    ref = harness.reference_of(cell)
    gap = 0.0
    for c in calls:
        got = ref.lm_loss(c["params"], prob, st["gamma"], st["scales"][c["start"]])
        gap = max(gap, harness.rel_gap(float(c["losses"][-1]), got))
    return {"call_loss": gap}


def check(cell, st, record: dict) -> dict:
    """The readings `correct` is decided on (limits/<cell>.json): the
    window's last call from each start, its first `check_steps` steps
    followed by the reference from that start (every call but the first of
    the window comes after another), and every call's answer."""
    last = {c["start"]: c for c in record["calls"]}
    got = [last[i] for i in range(len(st["starts"]))]
    return {**step_readings(got, followed(cell, st, cell.traffic["check_steps"])),
            **answer_readings(cell, st, record["calls"])}


def control_readings(cell, st, record: dict) -> dict:
    """The control in the program's place: the reference in TF32 makes a
    call of the window's length from each start, judged as the program's
    calls are."""
    tr = cell.traffic
    calls = followed(cell, st, tr["call_steps"], tf32=True)
    for i, c in enumerate(calls):
        c["start"] = i
    return {**step_readings(calls, followed(cell, st, tr["check_steps"])),
            **answer_readings(cell, st, calls)}
