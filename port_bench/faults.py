"""Faults planted underneath the timed path, to show that the comparison
that decides `correct` catches them. Each is a context manager that patches
the port's functions for the duration of a run and restores them.

- "unchanged": a step returns its state unchanged (the fit's optimizer
  applies no update; the LM call returns the params it was given);
- "half_batch": half of the collocation points left out, the mean taken
  over the rest (the first half of the rows, the quadrature weight doubled
  so that the normalisation sum keeps its scale);
- "altered": the answer altered where it is produced, by a relative 1e-3
  (the value-and-grad's loss and the loss function's μ; the LM call's loss
  history).
A single card has no exchange between chips to leave out. Beside them,
"stale" (polish cells): the LM solver runs every call from the params of
its first call, as a CUDA graph kept across calls with a stale θ would.
"""
from __future__ import annotations

import contextlib

FAULTS = ("unchanged", "half_batch", "altered")
LM_FAULTS = ("stale",)
from port_bench.harness import COLLOCATION


def half(batch: dict) -> dict:
    n = batch["x"].shape[0] // 2
    out = {k: (v[:n].contiguous() if k in COLLOCATION else v) for k, v in batch.items()}
    out["w"] = out["w"] * 2.0
    return out


def _wrap_vag(vag, fault: str):
    """A fused value-and-grad with the fault planted (relaxed or exact)."""
    stateful = getattr(vag, "stateful", False)

    def call(params, batch, gamma, scale, *state):
        if fault == "half_batch":
            batch = half(batch)
        out = vag(params, batch, gamma, scale, *state)
        if fault == "altered":
            (total, aux), rest = out[0], out[1:]
            out = ((total * (1.0 + 1e-3), aux),) + rest
        return out

    if stateful:
        call.stateful = True
        call.init_state = lambda params, batch, gamma, scale: vag.init_state(
            params, half(batch) if fault == "half_batch" else batch, gamma, scale)
    return call


@contextlib.contextmanager
def planted(fault: str):
    """Patch the port for `fault` (both cells' paths) while inside."""
    if fault not in FAULTS + LM_FAULTS:
        raise ValueError(f"unknown fault {fault!r}; have {FAULTS + LM_FAULTS}")
    import torch
    from torch.utils import _pytree as pytree

    from gpe_tpu_torch.kernels import fused_grad
    from gpe_tpu_torch.train import gauss_newton, optimizers, problem

    saved = [(fused_grad, "make_value_and_grad"), (problem, "make_loss_fn"),
             (optimizers.ClipAdam, "update"), (gauss_newton, "make_lm_solver"),
             (gauss_newton, "make_gpe_residual_fn")]
    saved = [(obj, name, getattr(obj, name)) for obj, name in saved]
    orig = {name: fn for _, name, fn in saved}

    if fault in ("half_batch", "altered"):
        # make_fused_value_and_grad builds its vag through this factory too
        f = orig["make_value_and_grad"]
        fused_grad.make_value_and_grad = lambda *a, **k: _wrap_vag(f(*a, **k), fault)
    if fault == "altered":
        def make_loss_fn(spec):
            loss_fn = orig["make_loss_fn"](spec)

            def altered(*a, **k):
                total, aux = loss_fn(*a, **k)
                return total, {**aux, "mu": aux["mu"] * (1.0 + 1e-3)}
            return altered
        problem.make_loss_fn = make_loss_fn
    if fault == "unchanged":
        def update(self, grads, state, params=None, **kw):
            upd, state = orig["update"](self, grads, state, params, **kw)
            return pytree.tree_map(torch.zeros_like, upd), state
        optimizers.ClipAdam.update = update
    if fault == "half_batch":
        def residual_fn(spec):
            r = orig["make_gpe_residual_fn"](spec)
            return lambda params, batch, gamma, scale: r(params, half(batch), gamma, scale)
        gauss_newton.make_gpe_residual_fn = residual_fn

    def make_lm_solver(*a, **k):
        solver = orig["make_lm_solver"](*a, **k)
        first = []

        def planted_solver(params, batch, gamma, scale):
            if fault == "stale":
                first.append(params)
                params = first[0]
            res = solver(params, batch, gamma, scale)
            if fault == "unchanged":
                return res._replace(params=params)
            if fault == "altered":
                return res._replace(loss=res.loss * (1.0 + 1e-3),
                                    loss_history=res.loss_history * (1.0 + 1e-3))
            return res
        return planted_solver

    gauss_newton.make_lm_solver = make_lm_solver
    try:
        yield
    finally:
        for obj, name, fn in saved:
            setattr(obj, name, fn)
