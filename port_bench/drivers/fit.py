"""The fit window: rungs of the configuration's γ ramp through the port's
`train/loop.py:fit`, with the fused value-and-grad of
`make_fused_value_and_grad(spec)` (K2 every step, K1 once a rung in its
`init_state`) and `ramp_optimizer()` (clip, Adam, the loss-as-step LR).

Traffic keys: `refine` (points a side = the configuration's × refine),
`rung_steps`, `check_every`, `check_steps` (the set-up's checked steps, at
the ramp's last γ).

Set-up makes the weights from the seed, the perturbation scale and the
batch, then drives the window's own `fit` through `check_steps` steps from
the seed's weights: that warms every shape the window uses and is what the
reference follows. The window then runs rung after rung, γ cycling through
the ramp, each from the last rung's best params, tol 0 and a patience above
the rung (every rung runs all its steps), until `seconds` have passed.
"""
from __future__ import annotations

import time

from port_bench import harness


class _Recorded:
    """The ramp optimizer, passed through, keeping Adam's state after the
    first update (the first gradient as the optimizer got it)."""

    def __init__(self, opt):
        self.opt, self.first = opt, None

    def init(self, params):
        return self.opt.init(params)

    def update(self, grads, state, params=None, **kw):
        upd, state = self.opt.update(grads, state, params, **kw)
        if self.first is None:
            self.first = [t.clone() for t in state["mu"]]
        return upd, state


def _vag(spec, device):
    """The fused value-and-grad of the main path; on the CPU (tests only)
    the same factory's plain form with the mode the port resolves."""
    from gpe_tpu_torch.train.problem import make_fused_value_and_grad

    if device.type == "cuda":
        vag = make_fused_value_and_grad(spec, device=device)
        if vag is None:
            raise RuntimeError("make_fused_value_and_grad gave no fused path")
        return vag
    from gpe_tpu_torch.kernels.fused_grad import make_value_and_grad
    from gpe_tpu_torch.train.problem import _resolve_relaxed

    relaxed, fresh, extrap = _resolve_relaxed(None, None, None)
    return make_value_and_grad(
        spec.layers, spec.activation, spec.p, spec.kinetic, spec.nonlinearity,
        bc_weight=spec.bc_weight, norm_weight=spec.norm_weight, delayed=relaxed,
        extrapolate=extrap, fresh_values=fresh)


def setup(cell) -> dict:
    from gpe_tpu_torch.train.loop import fit
    from gpe_tpu_torch.train.plpinn import ramp_optimizer
    from gpe_tpu_torch.train.problem import _resolve_relaxed, make_loss_fn

    tr, cfg = cell.traffic, cell.config
    n_side = cfg["spec"]["n_points"] * tr["refine"]
    spec, batch = harness.program_problem(cell, n_side)
    params0 = harness.seeded_params(spec.layers, cell.seed, cell.device)
    scale = harness.perturb_scale(params0, cell, n_side)
    st = {"spec": spec, "batch": batch, "params0": params0, "scale": scale,
          "n_side": n_side, "loss_fn": make_loss_fn(spec),
          "vag": _vag(spec, cell.device), "opt": ramp_optimizer(cfg.get("lr", 1e-3)),
          "gammas": [float(g) for g in cfg["gamma_values"]],
          "check_gamma": float(cfg["gamma_values"][-1]),
          "relaxed_mode": dict(zip(("relaxed", "fresh_values", "extrapolate"),
                                   _resolve_relaxed(None, None, None)))}
    rec = _Recorded(st["opt"])
    st["check"] = fit(st["loss_fn"], rec, params0, batch, st["check_gamma"], scale,
                      epochs=tr["check_steps"], tol=0.0, patience=10 ** 9,
                      check_every=tr["check_steps"], value_and_grad_fn=st["vag"])
    st["check_mu1"] = rec.first
    return st


def _rung(st, tr, params, gamma):
    from gpe_tpu_torch.train.loop import fit

    return fit(st["loss_fn"], st["opt"], params, st["batch"], gamma, st["scale"],
               epochs=tr["rung_steps"], tol=0.0, patience=tr["rung_steps"] + 1,
               check_every=tr["check_every"], value_and_grad_fn=st["vag"])


def window(cell, st, seconds: float, trace: bool) -> dict:
    """Rungs until `seconds` have passed (traced: rung 1 under the profiler,
    and at least three rungs). Each rung's wall time ends in fit's own host
    reads of its results."""
    from gpe_tpu_torch.kernels._common import LaunchCounter

    from port_bench import trace as tracing

    tr = cell.traffic
    params = st["check"].params
    rungs, traced = [], None
    counter = LaunchCounter()
    t_start = time.perf_counter()
    k = 0
    while k == 0 or time.perf_counter() - t_start < seconds or (trace and k < 3):
        gamma = st["gammas"][k % len(st["gammas"])]
        counter.mark()
        t0 = time.perf_counter()
        if trace and k == 1:
            res, traced = tracing.profiled(lambda: _rung(st, tr, params, gamma))
        else:
            res = _rung(st, tr, params, gamma)
        wall = time.perf_counter() - t0
        rungs.append({"gamma": gamma, "wall_s": wall, "steps": res.epochs_run,
                      "best_loss": res.best_loss, "mu_best": res.mu_best,
                      "start": params, "params": res.params,
                      "losses": [float(v) for v in res.loss_history[:tr["check_steps"]]],
                      "launches": counter.since(), "traced": trace and k == 1})
        params = res.params
        k += 1
    spec = st["spec"]
    return {"kind": "fit", "rungs": rungs, "trace": traced, "path": st["relaxed_mode"],
            "n_points": st["n_side"] ** 2, "layers": list(spec.layers),
            "n_boundary": int(st["batch"]["bx"].shape[0]),
            "window_s": time.perf_counter() - t_start}


def followed(cell, st, tf32: bool = False, start=None, gamma=None, steps=None) -> dict:
    """The reference's own run of `steps` (default `check_steps`) steps, in
    float32 (TF32 GEMM operands with tf32=True: the control): from the
    seed's weights at the checked γ (the set-up's steps), or from a rung's
    `start` at its `gamma`."""
    import torch

    prob = harness.reference_problem(cell, st["n_side"], torch.float32)
    return harness.reference_of(cell).fit_steps(
        st["params0"] if start is None else start, prob,
        st["check_gamma"] if gamma is None else gamma, st["scale"],
        steps or cell.traffic["check_steps"], cell.config.get("lr", 1e-3), tf32=tf32)


def _followed_rung(cell, st, rung: dict, tf32: bool = False) -> dict:
    return followed(cell, st, tf32, start=rung["start"], gamma=rung["gamma"], steps=1)


def rung_readings(got: dict, ref: dict) -> dict:
    """A window rung's first loss (`got`: the program's, or the control's),
    at the params the rung was handed, against the reference's there. Its
    later steps are not compared: a rung starts Adam afresh from trained
    params, where the first update moves each entry by ±lr with the sign of
    its gradient, rounding sets that sign where an entry is near zero, and
    the loss two steps on parts from the reference by up to 3% on sound
    runs."""
    return {"rung_first_loss": harness.rel_gap(got["losses"][0], ref["losses"][0])}


def control_readings(cell, st, record: dict) -> dict:
    """The control in the program's place: the reference in TF32 follows
    the checked steps and the window's last rung's first step, against the
    float32 reference."""
    rung = record["rungs"][-1]
    return {**step_readings(st, followed(cell, st, tf32=True), followed(cell, st)),
            **rung_readings(_followed_rung(cell, st, rung, tf32=True),
                            _followed_rung(cell, st, rung))}


def program_steps(st) -> dict:
    """The program's checked steps in the reference's terms."""
    chk = st["check"]
    return {"losses": [float(v) for v in chk.loss_history],
            "adam_mu1": st["check_mu1"], "params": chk.final_params}


def step_readings(st, got: dict, ref: dict) -> dict:
    """The checked steps of `got` (the program's, or the control's) against
    the reference's: each step's loss, the first gradient by Adam's first
    moment, the change of the params after the steps; the gaps of norms by
    the worst leaf."""
    import torch

    p0 = harness.leaves(st["params0"])
    loss_gap = max(harness.rel_gap(a, b) for a, b in zip(got["losses"], ref["losses"]))
    grad_gap = harness.worst_leaf_gap(got["adam_mu1"], ref["adam_mu1"])
    # leaves whose reference gradient is nought to rounding move by
    # round-off alone under Adam: out of the change
    gn = [float(torch.linalg.vector_norm(t.double())) for t in ref["adam_mu1"]]
    med = sorted(gn)[len(gn) // 2]
    skip = {i for i, g in enumerate(gn) if g < 1e-3 * med}
    change = [[a.double() - b.double() for a, b in zip(harness.leaves(x["params"]), p0)]
              for x in (got, ref)]
    return {"step_loss": loss_gap, "first_grad": grad_gap,
            "change": harness.worst_leaf_gap(*change, skip)}


def answer_readings(cell, st, record: dict) -> dict:
    """Every rung's answer, its best loss and μ, against the reference's
    float64 evaluation at the params the rung returned: μ relative to μ,
    the loss relative to the mean of (Hu)² (the pde part of the loss is a
    difference of sums of that size, so float32 sums leave it that much
    rounding)."""
    prob = harness.reference_problem(cell, st["n_side"])
    ref = harness.reference_of(cell)
    rung_loss, rung_mu = 0.0, 0.0
    for r in record["rungs"]:
        p = tuple((W.double(), b.double()) for W, b in r["params"])
        loss, mu, size = ref.loss_mu(p, prob, r["gamma"], st["scale"])
        rung_loss = max(rung_loss, harness.rel_gap(r["best_loss"], loss) * abs(loss) / size)
        rung_mu = max(rung_mu, harness.rel_gap(r["mu_best"], mu))
    return {"rung_loss": rung_loss, "rung_mu": rung_mu}


def check(cell, st, record: dict) -> dict:
    """The readings `correct` is decided on (limits/<cell>.json): the
    set-up's checked steps, the window's last rung's first step (it comes
    after the others), and every rung's answer."""
    rung = record["rungs"][-1]
    return {**step_readings(st, program_steps(st), followed(cell, st)),
            **rung_readings(rung, _followed_rung(cell, st, rung)),
            **answer_readings(cell, st, record)}
