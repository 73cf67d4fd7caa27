"""L-BFGS with the zoom line search, a port of optax's `lbfgs` (optax
0.2.6: `scale_by_lbfgs`, `scale_by_zoom_linesearch`, `zoom_linesearch`,
`_cubicmin`, `_quadmin`), as links of `optimizers.Chain`:

    scale_by_lbfgs(memory 10, scaled initial preconditioner)
    → × −lr (−1 without a learning rate) → zoom line search (20 trials,
    initial guess 1)

The two-loop recursion runs on the device. The line search evaluates the
objective and its gradient at each trial point and reads the value and
the slope on the host; its scalar arithmetic (the sufficient-decrease and
curvature errors, the cubic and quadratic interpolations) runs in numpy in
the params' dtype, as optax's runs in theirs. Its last value and gradient
stay in the state (`last_value_and_grad`), so a deterministic objective's
next step reuses them as `optax.value_and_grad_from_state` does.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from gpe_tpu_torch.train.optimizers import Chain, ScaleByLearningRate, vdot


def value_and_grad_of(obj: Callable, leaves):
    """(value, grad leaves) of obj at a leaf list, by autograd."""
    xs = [t.detach().requires_grad_(True) for t in leaves]
    with torch.enable_grad():
        v = obj(xs)
        g = torch.autograd.grad(v, xs, allow_unused=True)
    return v.detach(), [torch.zeros_like(x) if gi is None else gi
                        for x, gi in zip(xs, g)]


class ScaleByLBFGS:
    """optax.scale_by_lbfgs: the memory of past differences of params and
    updates, refreshed with this step's, then the two-loop product P_k·u_k
    with P's initial scale γ_k = ⟨δu, δw⟩/‖δu‖² (min(1, 1/‖u‖) at the first
    step)."""

    def __init__(self, memory_size: int = 10):
        if memory_size < 1:
            raise ValueError("memory_size must be >= 1")
        self.m = memory_size

    def init(self, leaves):
        t = leaves[0]
        return {"count": 0,
                "params": [torch.zeros_like(x) for x in leaves],
                "updates": [torch.zeros_like(x) for x in leaves],
                "dw": [torch.zeros((self.m,) + x.shape, dtype=x.dtype, device=x.device)
                       for x in leaves],
                "du": [torch.zeros((self.m,) + x.shape, dtype=x.dtype, device=x.device)
                       for x in leaves],
                "rho": torch.zeros(self.m, dtype=t.dtype, device=t.device)}

    def update(self, u, s, ctx):
        m, count = self.m, s["count"]
        idx, prev = count % m, (count - 1) % m
        dw, du, rho = [x.clone() for x in s["dw"]], [x.clone() for x in s["du"]], s["rho"].clone()
        if count > 0:
            d_params = [p - q for p, q in zip(ctx.params, s["params"])]
            d_updates = [a - b for a, b in zip(u, s["updates"])]
            vd = vdot(d_updates, d_params)
            weight = torch.where(vd == 0.0, torch.zeros_like(vd), 1.0 / vd)
        else:
            d_params = [torch.zeros_like(p) for p in ctx.params]
            d_updates = [torch.zeros_like(a) for a in u]
            weight = torch.zeros_like(rho[0])
        for mem, d in zip(dw, d_params):
            mem[prev] = d
        for mem, d in zip(du, d_updates):
            mem[prev] = d
        rho[prev] = weight
        if count > 0:
            num = vdot(d_updates, d_params)
            den = sum(torch.sum(d * d) for d in d_updates)
            gamma = torch.where(den > 0.0, num / den, torch.ones_like(den))
        else:
            norm = torch.sqrt(sum(torch.sum(a * a) for a in u))
            gamma = torch.clamp_max(1.0 / norm, 1.0)
        order = [(idx + j) % m for j in range(m)]
        vec, alphas = list(u), {}
        for j in reversed(order):
            alphas[j] = rho[j] * vdot([w[j] for w in dw], vec)
            vec = [v - alphas[j] * d[j] for v, d in zip(vec, du)]
        vec = [gamma * v for v in vec]
        for j in order:
            beta = rho[j] * vdot([d[j] for d in du], vec)
            vec = [v + (alphas[j] - beta) * w[j] for v, w in zip(vec, dw)]
        return vec, {"count": count + 1, "params": list(ctx.params), "updates": list(u),
                     "dw": dw, "du": du, "rho": rho}


def _cubicmin(a, fa, fpa, b, fb, c, fc):
    """The critical point of the cubic through (a, fa), (b, fb), (c, fc)
    with slope fpa at a (NaN when there is none)."""
    C = fpa
    db, dc = b - a, c - a
    denom = (db * dc) ** 2 * (db - dc)
    d1 = np.array([[dc ** 2, -(db ** 2)], [-(dc ** 3), db ** 3]])
    A, B = d1 @ np.array([fb - fa - C * db, fc - fa - C * dc]) / denom
    radical = B * B - 3.0 * A * C
    return a + (-B + np.sqrt(radical)) / (3.0 * A)


def _quadmin(a, fa, fpa, b, fb):
    """The critical point of the quadratic through (a, fa), (b, fb) with
    slope fpa at a."""
    db = b - a
    B = (fb - fa - fpa * db) / (db ** 2)
    return a - fpa / (2.0 * B)


class ZoomLinesearch:
    """optax.scale_by_zoom_linesearch: a step size along the incoming
    direction meeting the sufficient-decrease (or Hager–Zhang's approximate
    decrease) and curvature conditions, by the interval search and zoom of
    Nocedal & Wright's Algorithms 3.5–3.6 in at most `max_steps` trials;
    when they run out, the safe step (decrease alone) if there is one."""

    # optax's defaults: sufficient decrease, curvature, approximate decrease
    # (Hager–Zhang), the interval's growth and its smallest width
    SLOPE_RTOL, CURV_RTOL, APPROX_DEC_RTOL = 1e-4, 0.9, 1e-6
    INCREASE, PRECISION = 2.0, 1e-5

    def __init__(self, max_steps: int = 20):
        self.max_steps = max_steps

    def init(self, leaves):
        return {"value": float("inf"), "grad": [torch.zeros_like(x) for x in leaves],
                "trials": 0}

    def update(self, u, s, ctx):
        if ctx.obj is None or ctx.value is None:
            raise ValueError("the zoom line search needs value= and obj_fn= "
                             "(gpe_tpu_torch.train.fit passes them)")
        f = np.dtype(str(u[0].dtype).replace("torch.", "")).type

        def on_line(t):
            """(value, gradient, slope) at params + t·direction."""
            v, g = value_and_grad_of(ctx.obj, [p + float(t) * d
                                               for p, d in zip(ctx.params, u)])
            return f(v.item()), g, f(vdot(g, u).item())

        v0 = f(ctx.value.item() if torch.is_tensor(ctx.value) else ctx.value)
        g0 = list(ctx.grad)
        s0 = f(vdot(u, g0).item())
        st = dict(f=f, on_line=on_line, count=0, stepsize=f(0.0), value=v0, grad=g0,
                  slope=s0, v0=v0, s0=s0, dec=f(np.inf), interval=False, done=False,
                  failed=False,
                  low=f(0.0), v_low=v0, s_low=s0, high=f(0.0), v_high=v0, s_high=s0,
                  cubic=f(0.0), v_cubic=v0, safe=f(0.0), v_safe=v0, g_safe=g0)
        with np.errstate(all="ignore"):
            while not (st["done"] or st["failed"]):
                (self._zoom if st["interval"] else self._search)(st)
                if st["failed"] and (st["safe"] > 0.0 or np.isinf(st["dec"])):
                    st.update(stepsize=st["safe"], value=st["v_safe"], grad=st["g_safe"])
        t = float(st["stepsize"])
        return [t * d for d in u], {"value": float(st["value"]), "grad": st["grad"],
                                    "trials": st["count"], "stepsize": t}

    def _errors(self, t, v, slope, st):
        """(decrease error, curvature error), each ≥ 0 and inf for NaN."""
        f, v0, s0 = st["f"], st["v0"], st["s0"]
        dec = v - v0 - f(self.SLOPE_RTOL) * t * s0
        approx = slope - f(2 * self.SLOPE_RTOL - 1.0) * s0
        approx = np.maximum(approx, v - v0 - f(self.APPROX_DEC_RTOL) * np.abs(v0))
        dec = np.minimum(approx, dec)
        curv = np.abs(slope) - f(self.CURV_RTOL) * np.abs(s0)
        fix = lambda e: f(np.inf) if np.isnan(e) else np.maximum(e, f(0.0))
        return fix(dec), fix(curv)

    def _search(self, st):
        """One trial of the interval search (Algorithm 3.5)."""
        f, i = st["f"], st["count"]
        t = f(1.0) if i == 0 else f(self.INCREASE) * st["stepsize"]
        v, g, slope = st["on_line"](t)
        dec, curv = self._errors(t, v, slope, st)
        err = np.maximum(dec, curv)
        if dec <= 0.0:
            st.update(safe=t, v_safe=v, g_safe=g)
        set_high = bool(dec > 0.0) or (bool(v >= st["value"]) and i > 0)
        set_low = bool(slope >= 0.0) and not set_high
        new, prev = (t, v, slope), (st["stepsize"], st["value"], st["slope"])
        lo, hi = (new, prev) if set_low else (prev, new)
        done = bool(err <= 0.0)
        interval = set_high or set_low or done
        st.update(count=i + 1, stepsize=t, value=v, grad=g, slope=slope, dec=dec,
                  interval=interval, done=done,
                  failed=(i + 1 >= self.max_steps) and not done,
                  low=lo[0], v_low=lo[1], s_low=lo[2], high=hi[0], v_high=hi[1],
                  s_high=hi[2], cubic=lo[0], v_cubic=lo[1])

    def _zoom(self, st):
        """One trial of the zoom (Algorithm 3.6): cubic, else quadratic,
        else bisection inside the interval."""
        f, i = st["f"], st["count"]
        low, high = st["low"], st["high"]
        delta = np.abs(high - low)
        left, right = np.minimum(high, low), np.maximum(high, low)
        mc = _cubicmin(low, st["v_low"], st["s_low"], high, st["v_high"],
                       st["cubic"], st["v_cubic"])
        mq = _quadmin(low, st["v_low"], st["s_low"], high, st["v_high"])
        if (mc > left + f(0.2) * delta) and (mc < right - f(0.2) * delta):
            t = mc
        elif (mq > left + f(0.1) * delta) and (mq < right - f(0.1) * delta):
            t = mq
        else:
            t = (low + high) / f(2.0)
        v, g, slope = st["on_line"](t)
        dec, curv = self._errors(t, v, slope, st)
        done = bool(np.maximum(dec, curv) <= 0.0)
        if dec <= 0.0 and v < st["v_safe"]:
            st.update(safe=t, v_safe=v, g_safe=g)
        high_to_mid = bool(dec > 0.0) or bool(v >= st["v_low"])
        high_to_low = bool(slope * (high - low) >= 0.0) and not high_to_mid
        mid, lo, hi = (t, v, slope), (low, st["v_low"], st["s_low"]), \
            (high, st["v_high"], st["s_high"])
        new_hi = lo if high_to_low else (mid if high_to_mid else hi)
        new_lo = lo if high_to_mid else mid
        cub = hi if (high_to_mid or high_to_low) else lo
        failed = ((i + 1 >= self.max_steps)
                  or (bool(delta <= f(self.PRECISION)) and st["safe"] > 0.0)) and not done
        st.update(count=i + 1, stepsize=t, value=v, grad=g, slope=slope, dec=dec,
                  done=done, failed=failed, low=new_lo[0], v_low=new_lo[1],
                  s_low=new_lo[2], high=new_hi[0], v_high=new_hi[1], s_high=new_hi[2],
                  cubic=cub[0], v_cubic=cub[1])


def lbfgs(learning_rate=None, memory_size: int = 10) -> Chain:
    """optax.lbfgs: L-BFGS direction, × −lr (× −1 without one), then the
    zoom line search (20 trials, initial guess 1)."""
    return Chain(ScaleByLBFGS(memory_size),
                 ScaleByLearningRate(1.0 if learning_rate is None else learning_rate),
                 ZoomLinesearch(max_steps=20))


def last_value_and_grad(chain: Chain, state):
    """The line search's last (value, gradient leaves) in `state`, or None
    before the first step (or after a non-finite value):
    optax.value_and_grad_from_state's reuse."""
    for link, st in zip(chain.links, state):
        if isinstance(link, ZoomLinesearch) and np.isfinite(st["value"]):
            return st["value"], st["grad"]
    return None
