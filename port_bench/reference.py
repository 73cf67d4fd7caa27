"""The plain reference the benchmark judges the port by.

Plain PyTorch written from the problem's equations; it imports nothing of
the port and takes nothing the port made: it builds its own collocation
grid, potential, base state and boundary probes from a configuration file,
and is handed only the inputs the benchmark made (the initial weights, the
perturbation scale, γ). It runs in float64 to judge, and in float32 with
every GEMM operand rounded to TF32 (`tf32=True`) as the control, the
nearest precision below the float32-without-TF32 that the configurations
state.

The problem (PL-PINN, a fixed perturbation base):

    u = base + scale·N(x),   Hu = −c·Δu + V·u + γ|u|^(p−1)u,
    S = (Σ(Hu)², Σu·Hu, Σu², Σu²w),  μ = S₁/S₂,
    loss = (S₀ − 2μS₁ + μ²S₂)/n + bc·mean(u_b²) + nw·(S₃ − 1)²,

N a shifted-tanh MLP whose value and Laplacian travel forward together
(the forward Laplacian). `fit_steps` follows the port's training step: the
relaxed value-and-grad (the gradient of Σ c·S with the cotangents c of the
extrapolated sums 2S_{t−1} − S_{t−2}, its Σu² and Σu²w taken fresh), the
global-norm clip, Adam and the loss-as-step learning rate. `lm_steps` follows Levenberg–Marquardt on the residual vector
whose sum of squares is the loss, with CG on JᵀJ + λ·curv·I.
"""
from __future__ import annotations

import math

import numpy as np
import torch
from torch.func import jvp, vjp

F64 = torch.float64
EPS_ACT = 1e-6          # the shifted tanh: tanh(y) + 1 + ε


def tf32_round(t: torch.Tensor) -> torch.Tensor:
    """float32 t rounded to TF32 (10 mantissa bits), nearest even."""
    bits = t.contiguous().view(torch.int32)
    bits = bits + 0x0FFF + ((bits >> 13) & 1)
    return (bits & -0x2000).view(torch.float32)


class _TF32MatMul(torch.autograd.Function):
    """a @ b with every operand rounded to TF32, in the forward, the
    backward and the forward-mode product alike, as a TF32 GEMM does."""

    @staticmethod
    def forward(a, b):
        return torch.matmul(tf32_round(a), tf32_round(b))

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs)
        ctx.save_for_forward(*inputs)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        ra, rb, rg = tf32_round(a), tf32_round(b), tf32_round(g)
        ga = torch.matmul(rg, rb.transpose(0, 1))
        gb = torch.matmul(ra.reshape(-1, a.shape[-1]).transpose(0, 1),
                          rg.reshape(-1, g.shape[-1]))
        return ga, gb

    @staticmethod
    def jvp(ctx, ta, tb):
        a, b = ctx.saved_tensors
        out = 0.0
        if ta is not None:
            out = out + torch.matmul(tf32_round(ta), tf32_round(b))
        if tb is not None:
            out = out + torch.matmul(tf32_round(a), tf32_round(tb))
        return out


def _mm(a, b, tf32: bool):
    return _TF32MatMul.apply(a, b) if tf32 else torch.matmul(a, b)


# --------------------------------------------------------------------------
# the problem's arrays


def points(spec: dict, n_side: int, device) -> torch.Tensor:
    """The n_side² collocation points of the square, in float64."""
    ax = torch.linspace(spec["lb"], spec["ub"], n_side, dtype=F64, device=device)
    X, Y = torch.meshgrid(ax, ax, indexing="ij")
    return torch.stack([X.reshape(-1), Y.reshape(-1)], dim=-1)


def _probes(lb: float, ub: float, device) -> torch.Tensor:
    """64 Dirichlet probes on each edge of the square."""
    e = torch.linspace(lb, ub, 64, dtype=F64, device=device)
    lo, hi = torch.full_like(e, lb), torch.full_like(e, ub)
    return torch.cat([torch.stack([e, lo], -1), torch.stack([e, hi], -1),
                      torch.stack([lo, e], -1), torch.stack([hi, e], -1)])


def _potential(name: str, kw: dict, x: torch.Tensor) -> torch.Tensor:
    if name == "harmonic":
        return kw.get("a", 1.0) * torch.sum(x * x, dim=-1)
    if name == "optical_lattice":
        return kw["V0"] * torch.sum(torch.sin(kw["k"] * x) ** 2, dim=-1)
    raise ValueError(f"the reference has no potential {name!r}")


def _hermite0(x: torch.Tensor):
    """(value, Laplacian) of the 2D harmonic-oscillator ground state
    π^(−1/2)·exp(−|x|²/2)."""
    r2 = torch.sum(x * x, dim=-1)
    val = torch.exp(-0.5 * r2) / math.sqrt(math.pi)
    return val, (r2 - 2.0) * val


class SineBase:
    """The Dirichlet sine series of a grid state on the interior nodes xi of
    [lb, ub]²: ψ(x, y) = Σ a_jk sin(k_j(x−lb)) sin(k_k(y−lb)), k_j = jπ/L,
    with a = M ψ M · 2/(n+1), M the orthonormal DST-I matrix."""

    def __init__(self, psi: np.ndarray, xi: np.ndarray, dx: float, device):
        n = xi.shape[0]
        self.lb, self.ub = float(xi[0] - dx), float(xi[-1] + dx)
        j = np.arange(1, n + 1)
        M = math.sqrt(2.0 / (n + 1)) * np.sin(np.pi * np.outer(j, j) / (n + 1))
        a = M @ np.asarray(psi, np.float64) @ M * (2.0 / (n + 1))
        k = np.pi * j / (self.ub - self.lb)
        self.k = torch.tensor(k, dtype=F64, device=device)
        self.a = torch.tensor(a, dtype=F64, device=device)
        self.alap = -self.a * (self.k[:, None] ** 2 + self.k[None, :] ** 2)

    def __call__(self, x: torch.Tensor):
        Sx = torch.sin((x[:, 0:1] - self.lb) * self.k)
        Sy = torch.sin((x[:, 1:2] - self.lb) * self.k)
        return (torch.sum((Sx @ self.a) * Sy, dim=1),
                torch.sum((Sx @ self.alap) * Sy, dim=1))


class Problem:
    """The arrays of one configuration at n_side² points, in float64 on
    `device`: points x, weights w, V, the base's value and Laplacian, the
    boundary probes and the base there, built in float64 and kept in
    `dtype`. `base_data` is the numeric base's (psi, xi, dx) for basis
    "numeric"."""

    def __init__(self, spec: dict, n_side: int, device, base_data=None,
                 dtype=F64):
        lb, ub = spec["lb"], spec["ub"]
        self.spec = spec
        self.x = points(spec, n_side, device)
        self.w = ((ub - lb) / (n_side - 1)) ** 2
        self.V = _potential(spec["potential"], spec.get("potential_kwargs", {}), self.x)
        self.bx = _probes(lb, ub, device)
        if spec["basis"] == "hermite":
            base = _hermite0
        elif spec["basis"] == "numeric":
            base = SineBase(*base_data, device=device)
        else:
            raise ValueError(f"the reference has no basis {spec['basis']!r}")
        self.base_val, self.base_lap = base(self.x)
        self.base_bval = base(self.bx)[0]
        for k in ("x", "V", "bx", "base_val", "base_lap", "base_bval"):
            setattr(self, k, getattr(self, k).to(dtype))

    @property
    def n(self) -> int:
        return self.x.shape[0]


# --------------------------------------------------------------------------
# the net


def _act(y):
    t = torch.tanh(y)
    d1 = 1.0 - t * t
    return t + 1.0 + EPS_ACT, d1, -2.0 * t * d1


def net_value(params, x, tf32: bool = False):
    h = x
    for i, (W, b) in enumerate(params):
        h = _mm(h, W, tf32) + b
        if i < len(params) - 1:
            h = _act(h)[0]
    return h[:, 0]


def net_value_lap(params, x, tf32: bool = False):
    """(N(x), ΔN(x)) by the forward Laplacian: value, d Jacobian rows and
    the Laplacian as one (n, d+2, width) state through every GEMM."""
    n, d = x.shape
    s = torch.cat([x[:, None, :], torch.eye(d, dtype=x.dtype, device=x.device)
                   .expand(n, d, d), x.new_zeros(n, 1, d)], dim=1)
    for i, (W, b) in enumerate(params):
        s = _mm(s, W, tf32)
        s = torch.cat([s[:, :1] + b, s[:, 1:]], dim=1)
        if i < len(params) - 1:
            v, d1, d2 = _act(s[:, 0])
            jac = s[:, 1:1 + d]
            lap = d1 * s[:, 1 + d] + d2 * torch.sum(jac * jac, dim=1)
            s = torch.cat([v[:, None], d1[:, None] * jac, lap[:, None]], dim=1)
    return s[:, 0, 0], s[:, 1 + d, 0]


def _hu(prob: Problem, sl, u, lap, gamma):
    sp = prob.spec
    return (-sp["kinetic"] * lap + prob.V[sl] * u
            + gamma * torch.abs(u) ** (sp["p"] - 1.0) * u)


def sums(params, prob: Problem, gamma, scale, tf32=False, rows=slice(None)):
    """S on the points `rows`."""
    v, lap = net_value_lap(params, prob.x[rows], tf32)
    u = prob.base_val[rows] + scale * v
    lap = prob.base_lap[rows] + scale * lap
    hu = _hu(prob, rows, u, lap, gamma)
    return torch.stack([torch.sum(hu * hu), torch.sum(u * hu), torch.sum(u * u),
                        torch.sum(u * u) * prob.w])


def value_sums(params, prob: Problem, scale, tf32=False):
    """(Σu², Σu²w) from a value-only forward."""
    u = prob.base_val + scale * net_value(params, prob.x, tf32)
    s = torch.sum(u * u)
    return torch.stack([s, s * prob.w])


def boundary_mean(params, prob: Problem, scale, tf32=False):
    bv = prob.base_bval + scale * net_value(params, prob.bx, tf32)
    return torch.mean(bv * bv)


def sums_to_loss(S, n: int, nw: float):
    """(μ, pde, norm, cotangents ∂loss/∂S at fixed μ)."""
    mu = S[1] / (S[2] + 1e-12)
    pde = (S[0] - 2.0 * mu * S[1] + mu * mu * S[2]) / n
    norm = (S[3] - 1.0) ** 2
    cots = torch.stack([torch.ones_like(mu) / n, -2.0 * mu / n, mu * mu / n,
                        2.0 * nw * (S[3] - 1.0)])
    return mu, pde, norm, cots


def loss_mu(params, prob: Problem, gamma, scale, block: int = 65536):
    """(loss, μ, S₀/n) at params, the collocation sums taken in blocks of
    rows. S₀/n, the mean of (Hu)², is the size of the terms whose
    difference the loss's pde part is."""
    with torch.no_grad():
        S = sum(sums(params, prob, gamma, scale, rows=slice(i, i + block))
                for i in range(0, prob.n, block))
        mu, pde, norm, _ = sums_to_loss(S, prob.n, prob.spec["norm_weight"])
        total = (pde + prob.spec["bc_weight"] * boundary_mean(params, prob, scale)
                 + prob.spec["norm_weight"] * norm)
    return float(total), float(mu), float(S[0]) / prob.n


# --------------------------------------------------------------------------
# the training step


def _leaves(params):
    return [t for W, b in params for t in (W, b)]


def _pairs(leaves):
    return tuple((leaves[i], leaves[i + 1]) for i in range(0, len(leaves), 2))


def _grad(fn, params):
    """(fn's outputs, ∇ of its first output) by autograd."""
    leaves = [t.detach().requires_grad_(True) for t in _leaves(params)]
    with torch.enable_grad():
        out = fn(_pairs(leaves))
        g = torch.autograd.grad(out[0], leaves)
    return [o.detach() for o in out], list(g)


def relaxed_value_and_grad(params, prob, gamma, scale, state, tf32=False,
                           block: int = 65536):
    """One relaxed step's (loss, gradient leaves, new state); state is
    (S_{t−1}, S_{t−2}), both S(θ₀) at the start."""
    sp, n = prob.spec, prob.n
    prev, prev2 = state
    cot_sums = torch.cat([(2.0 * prev - prev2)[:2],
                          value_sums(params, prob, scale, tf32)])
    _, _, _, cots = sums_to_loss(cot_sums, n, sp["norm_weight"])

    def colloc(p, rows):
        Sb = sums(p, prob, gamma, scale, tf32, rows)
        return torch.sum(cots * Sb), Sb

    S, grads = 0.0, None
    for i in range(0, n, block):
        (_, Sb), g = _grad(lambda p: colloc(p, slice(i, i + block)), params)
        S = S + Sb
        grads = g if grads is None else [a + b for a, b in zip(grads, g)]
    (bmean,), gb = _grad(lambda p: (boundary_mean(p, prob, scale, tf32),), params)
    _, pde, norm, _ = sums_to_loss(S, n, sp["norm_weight"])
    total = pde + sp["bc_weight"] * bmean + sp["norm_weight"] * norm
    grads = [a + sp["bc_weight"] * b for a, b in zip(grads, gb)]
    return total, grads, (S, prev)


def warm_restarts_lr(loss, base_lr=1e-3, T0=200, T_mult=2, eta_min=1e-6):
    """The warm-restart cosine schedule (T₀ 200, T_mult 2) read at the loss,
    the reference trainer's effective learning rate."""
    n = loss / T0 * (T_mult - 1) + 1.0
    k = torch.floor(torch.log(n) / math.log(T_mult))
    pk = torch.pow(torch.full_like(k, float(T_mult)), k)
    start = T0 * (pk - 1.0) / (T_mult - 1)
    t = torch.clamp((loss - start) / (T0 * pk), 0.0, 1.0)
    return eta_min + 0.5 * (base_lr - eta_min) * (1.0 + torch.cos(math.pi * t))


def fit_steps(params, prob, gamma, scale, steps: int, lr: float = 1e-3,
              tf32: bool = False):
    """`steps` training steps from params: {"losses": each step's loss,
    "adam_mu1": Adam's first moment after step 1 (leaves), "params": the
    params after the last step}."""
    b1, b2, eps = 0.9, 0.999, 1e-8
    dt = prob.x.dtype
    params = tuple((W.to(dt), b.to(dt)) for W, b in params)
    gamma = torch.tensor(gamma, dtype=dt, device=prob.x.device)
    with torch.no_grad():
        S0 = sum(sums(params, prob, gamma, scale, tf32, slice(i, i + 65536))
                 for i in range(0, prob.n, 65536))
    state = (S0, S0)
    leaves = _leaves(params)
    m = [torch.zeros_like(t) for t in leaves]
    v = [torch.zeros_like(t) for t in leaves]
    losses, mu1 = [], None
    for step in range(1, steps + 1):
        loss, g, state = relaxed_value_and_grad(params, prob, gamma, scale, state,
                                                tf32)
        gnorm = torch.sqrt(sum(torch.sum(x * x) for x in g))
        f = torch.where(gnorm < 1.0, torch.ones_like(gnorm), 1.0 / gnorm)
        g = [x * f for x in g]
        m = [b1 * a + (1 - b1) * x for a, x in zip(m, g)]
        v = [b2 * a + (1 - b2) * x * x for a, x in zip(v, g)]
        if step == 1:
            mu1 = [a.clone() for a in m]
        lr_t = -warm_restarts_lr(loss, lr)
        upd = [lr_t * (a / (1 - b1 ** step)) / (torch.sqrt(c / (1 - b2 ** step)) + eps)
               for a, c in zip(m, v)]
        losses.append(float(loss))
        leaves = [a + u for a, u in zip(_leaves(params), upd)]
        params = _pairs(leaves)
    return {"losses": losses, "adam_mu1": mu1, "params": params}


# --------------------------------------------------------------------------
# Levenberg–Marquardt


def residuals(params, prob: Problem, gamma, scale, tf32=False):
    """The residual vector whose sum of squares is the loss."""
    sp = prob.spec
    v, lap = net_value_lap(params, prob.x, tf32)
    u = prob.base_val + scale * v
    lap = prob.base_lap + scale * lap
    bv = prob.base_bval + scale * net_value(params, prob.bx, tf32)
    hu = _hu(prob, slice(None), u, lap, gamma)
    mu = torch.sum(u * hu) / (torch.sum(u * u) + 1e-12)
    r_pde = (hu - mu * u) / math.sqrt(float(prob.n))
    r_bc = math.sqrt(sp["bc_weight"] / float(bv.shape[0])) * bv
    r_norm = math.sqrt(sp["norm_weight"]) * (torch.sum(u * u) * prob.w - 1.0)
    return torch.cat([r_pde, r_bc, r_norm[None]])


def _cg(matvec, b, maxiter: int, tol: float = 1e-5):
    x = torch.zeros_like(b)
    r = b.clone()
    p = r.clone()
    g = torch.dot(r, r)
    stop = float(tol * tol * g)
    k = 0
    while k < maxiter and float(g) > stop:
        Ap = matvec(p)
        a = g / torch.dot(p, Ap)
        x = x + a * p
        r = r - a * Ap
        g_new = torch.dot(r, r)
        p = r + (g_new / g) * p
        g = g_new
        k += 1
    return x


def lm_steps(params, prob, gamma, scale, steps: int, cg_iters: int,
             lam0: float = 1e-2, tf32: bool = False):
    """`steps` LM steps from params: {"losses": min(loss, trial loss) a step,
    "lams": λ after each step, "params": the params after the last}."""
    dt = prob.x.dtype
    leaves = [t.detach().to(dt).reshape(-1) for t in _leaves(params)]
    shapes = [t.shape for t in _leaves(params)]
    sizes = [t.numel() for t in leaves]
    theta = torch.cat(leaves)

    def unravel(th):
        return _pairs([c.view(s) for c, s in zip(torch.split(th, sizes), shapes)])

    def rflat(th):
        return residuals(unravel(th), prob, gamma, scale, tf32)

    lam, losses, lams = lam0, [], []
    for _ in range(steps):
        r, vjp_fn = vjp(rflat, theta)
        loss = torch.sum(r * r)
        g = vjp_fn(r)[0]
        ghat = g / (torch.linalg.vector_norm(g) + 1e-30)
        _, jg = jvp(rflat, (theta,), (ghat,))
        c = lam * (torch.sum(jg * jg) + 1e-30)

        def matvec(v):
            _, jv = jvp(rflat, (theta,), (v,))
            return vjp_fn(jv)[0] + c * v

        theta_new = theta - _cg(matvec, g, cg_iters)
        r_new = rflat(theta_new)
        loss_new = torch.sum(r_new * r_new)
        accept = bool((loss_new < loss) & torch.isfinite(loss_new))
        if accept:
            theta = theta_new
        lam = min(max(lam * 0.5 if accept else lam * 4.0, 1e-9), 1e6)
        losses.append(float(torch.minimum(loss, loss_new)))
        lams.append(lam)
    return {"losses": losses, "lams": lams, "params": unravel(theta.detach())}


def lm_loss(params, prob, gamma, scale) -> float:
    """The LM residual's sum of squares at params."""
    with torch.no_grad():
        r = residuals(tuple((W.to(prob.x.dtype), b.to(prob.x.dtype)) for W, b in params),
                      prob, gamma, scale)
        return float(torch.sum(r * r))
