"""Physics-informed DeepONet, port of `gpe_tpu/deeponet/model.py`: learns
the operator V(·) ↦ ψ(·) for the 1D GPE (branch net on potential samples,
trunk net on coordinates, dot-product merge with a bias).

u(V)(x) = Σ_k b_k(V)·t_k(x) + c. The x-Laplacian of the PDE residual
touches only the trunk, Δu = Σ_k b_k·Δt_k, so one forward-Laplacian pass
through the trunk serves every potential of the batch, and the merge is
one (B, K) × (K, N) product. Params are the dict {"branch", "trunk",
"bias"}: two MLPs in the JAX layout and a 0-d bias.

Training pretrains the operator on the analytic γ = 0 family (Adam steps
with optax.adam's arithmetic, replayed from a CUDA graph on the card, as
`train/pretrain.py` runs them), then refines it physics-informed through
`fit` (Adam at lr/10, clip 1.0, every epoch kept). The held-out
evaluation scores it against the float64 FDM oracle
(`validate/fdm.py:solve_gpe_excited_1d`).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch
from torch.utils import _pytree as pytree

from gpe_tpu_torch.device import pin_full_f32, resolve_device
from gpe_tpu_torch.models import mlp
from gpe_tpu_torch.ops.rayleigh import hamiltonian_apply


@dataclass(frozen=True)
class DeepONetSpec:
    branch_layers: tuple = (64, 64, 64, 40)    # input = n_sensors
    trunk_layers: tuple = (1, 64, 64, 40)      # input = coordinate dim
    activation: str = "tanh"
    n_sensors: int = 64
    lb: float = -10.0
    ub: float = 10.0
    n_points: int = 512
    p: float = 3.0
    kinetic: float = 1.0
    nonlinearity: str = "abs_power"
    bc_weight: float = 10.0
    norm_weight: float = 20.0


def init_deeponet(spec: DeepONetSpec, generator: torch.Generator | None = None,
                  device=None):
    """Xavier-uniform branch and trunk (`mlp.init_mlp`, drawn in that order
    from `generator`, a CPU torch.Generator) and a zero bias, on `device`
    (None → the CUDA card)."""
    device = resolve_device(device)
    branch = mlp.init_mlp((spec.n_sensors,) + tuple(spec.branch_layers),
                          generator=generator, device=device)
    trunk = mlp.init_mlp(spec.trunk_layers, generator=generator, device=device)
    # the keys in sorted order, the leaf order of JAX's dict pytree
    return {"bias": torch.zeros((), dtype=torch.float32, device=device),
            "branch": branch, "trunk": trunk}


def deeponet_params_from_numpy(params, device=None, dtype=torch.float32):
    """JAX's {"branch", "trunk", "bias"} given as numpy leaves → the port's
    params on `device` (the bias stays a 0-d tensor)."""
    if set(params) != {"branch", "trunk", "bias"}:
        raise ValueError(f"DeepONet params have the keys branch, trunk, bias; "
                         f"got {sorted(params)}")
    return mlp.params_from_numpy({k: params[k] for k in sorted(params)}, device=device,
                                 dtype=dtype)


def deeponet_apply(params, v_samples, x, activation: str = "tanh"):
    """u[b, n] = Σ_k branch(v_b)_k · trunk(x_n)_k + bias.

    v_samples: (B, n_sensors); x: (N, d) → (B, N)."""
    b = mlp.mlp_apply(params["branch"], v_samples, activation)   # (B, K)
    t = mlp.mlp_apply(params["trunk"], x, activation)            # (N, K)
    return b @ t.T + params["bias"]


def deeponet_vgl(params, v_samples, x, activation: str = "tanh"):
    """(u, Δ_x u) for the whole potential batch from one trunk
    forward-Laplacian pass."""
    b = mlp.mlp_apply(params["branch"], v_samples, activation)   # (B, K)
    t = mlp.mlp_vgl(params["trunk"], x, activation)              # value, lap (N, K)
    return b @ t.value.T + params["bias"], b @ t.lap.T


def make_potential_family_batch(spec: DeepONetSpec, n_functions: int = 64,
                                family: str = "scaled_harmonic", seed: int = 0,
                                beta_range=(0.5, 2.0), betas=None,
                                device=None) -> dict:
    """A family of potentials on `device` (None → the CUDA card): sensor
    values (for the branch) and collocation values (for the residual),
    drawn by numpy's default_rng(seed) as the JAX package draws them.
    `betas` (scaled_harmonic only) pins the family parameters — the
    held-out evaluation grids."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    xs = np.linspace(spec.lb, spec.ub, spec.n_sensors)
    xc = np.linspace(spec.lb, spec.ub, spec.n_points)
    if family == "scaled_harmonic":
        betas = (np.asarray(betas, np.float64) if betas is not None
                 else rng.uniform(*beta_range, size=(n_functions,)))
        Vs = betas[:, None] * xs[None, :] ** 2
        Vc = betas[:, None] * xc[None, :] ** 2
        meta = betas
    elif family == "shifted_gaussian":
        centers = rng.uniform(spec.lb / 2, spec.ub / 2, size=(n_functions,))
        Vs = -np.exp(-((xs[None, :] - centers[:, None]) ** 2)) + xs[None, :] ** 2 * 0.05
        Vc = -np.exp(-((xc[None, :] - centers[:, None]) ** 2)) + xc[None, :] ** 2 * 0.05
        meta = centers
    else:
        raise ValueError(f"unknown family {family!r}")
    dx = xc[1] - xc[0]
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    return {
        "v_sensors": f32(Vs),
        "V": f32(Vc),
        "x": f32(xc[:, None]),
        "w": f32(np.full((spec.n_points,), dx)),
        "bx": f32([[spec.lb], [spec.ub]]),
        "meta": f32(meta),
    }


def make_deeponet_loss(spec: DeepONetSpec):
    """Physics-informed operator loss: per-potential GPE residual with
    per-potential Rayleigh μ, plus boundary and normalisation terms;
    aux["mu"] is the family mean."""
    def loss_fn(params, batch, gamma, scale):
        u, lap = deeponet_vgl(params, batch["v_sensors"], batch["x"], spec.activation)
        hu = hamiltonian_apply(u, lap, batch["V"], gamma, spec.p, spec.kinetic,
                               spec.nonlinearity)
        den = torch.sum(u * u, dim=1)
        mu = torch.sum(u * hu, dim=1) / (den + 1e-12)           # (B,)
        r = hu - mu[:, None] * u
        pde = torch.mean(r * r)
        ub = deeponet_apply(params, batch["v_sensors"], batch["bx"], spec.activation)
        boundary = torch.mean(ub * ub)
        norm = torch.mean((torch.sum(u * u * batch["w"][None, :], dim=1) - 1.0) ** 2)
        total = pde + spec.bc_weight * boundary + spec.norm_weight * norm
        aux = {"pde": pde, "boundary": boundary, "norm": norm,
               "mu": torch.mean(mu), "mu_per_fn": mu, "total": total}
        return total, aux

    return loss_fn


class DeepONetResult(NamedTuple):
    params: any
    mu_per_fn: np.ndarray
    loss_history: np.ndarray


def _analytic_family_targets(batch) -> torch.Tensor:
    """Exact γ = 0 ground states of the scaled-harmonic family V = βx²:
    φ_β(x) = β^(1/8)·π^(−1/4)·exp(−√β·x²/2) (kinetic 1)."""
    sb = torch.sqrt(batch["meta"])[:, None]                   # (B, 1)
    x = batch["x"][:, 0]                                      # (N,)
    return (sb ** 0.25) * (math.pi ** -0.25) * torch.exp(-0.5 * sb * x[None, :] ** 2)


def train_deeponet(spec: DeepONetSpec, gamma: float = 0.0, epochs: int = 5000,
                   lr: float = 1e-3, n_functions: int = 64, seed: int = 0,
                   family: str = "scaled_harmonic", check_every: int = 1000,
                   beta_range=(0.5, 2.0), pretrain_epochs: int = 3000,
                   device=None) -> DeepONetResult:
    """Pretrain the operator on the analytic γ = 0 family (scaled_harmonic
    only), then physics-informed refinement by `fit` for `epochs` epochs,
    on `device` (None → the CUDA card)."""
    from gpe_tpu_torch.train.loop import fit
    from gpe_tpu_torch.train.optimizers import make_optimizer
    from gpe_tpu_torch.train.pretrain import AdamSteps

    pin_full_f32()
    device = resolve_device(device)
    batch = make_potential_family_batch(spec, n_functions, family, seed, beta_range,
                                        device=device)
    loss_fn = make_deeponet_loss(spec)
    params = init_deeponet(spec, torch.Generator().manual_seed(seed), device)

    if pretrain_epochs > 0 and family == "scaled_harmonic":
        targets = _analytic_family_targets(batch)
        leaves, tree = pytree.tree_flatten(params)
        leaves = [t.detach().clone().requires_grad_(True) for t in leaves]

        def mse():
            u = deeponet_apply(pytree.tree_unflatten(leaves, tree), batch["v_sensors"],
                               batch["x"], spec.activation)
            return torch.mean((u - targets) ** 2)

        AdamSteps(mse, leaves, lr, leaves[0].is_cuda).run(pretrain_epochs)
        params = pytree.tree_unflatten([t.detach() for t in leaves], tree)

    opt = make_optimizer("adam", lr * 0.1, clip_norm=1.0)
    res = fit(loss_fn, opt, params, batch, gamma, 1.0, epochs=epochs, tol=0.0,
              patience=10**9, check_every=check_every)
    f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=device)
    with torch.no_grad():
        _, aux = loss_fn(res.params, batch, f32(gamma), f32(1.0))
    return DeepONetResult(res.params, aux["mu_per_fn"].cpu().numpy(), res.loss_history)


def evaluate_deeponet(spec: DeepONetSpec, params, betas, gamma: float = 0.0):
    """Held-out evaluation on unseen potentials V = βx²: one forward pass
    per β (no training), μ and the wavefunction's L2 error against the
    float64 Newton-continuation FDM oracle. Runs on the params' device.

    Returns (per-β dicts {beta, mu_pred, mu_ref, mu_abs_err, psi_l2_err},
    the (B, N) predicted wavefunctions and the x grid, both numpy)."""
    from gpe_tpu_torch.validate.fdm import solve_gpe_excited_1d

    device = params["bias"].device
    betas = [float(b) for b in betas]
    batch = make_potential_family_batch(spec, len(betas), "scaled_harmonic",
                                        betas=betas, device=device)
    with torch.no_grad():
        u, lap = deeponet_vgl(params, batch["v_sensors"], batch["x"], spec.activation)
        hu = hamiltonian_apply(u, lap, batch["V"],
                               torch.tensor(gamma, dtype=torch.float32, device=device),
                               spec.p, spec.kinetic, spec.nonlinearity)
        den = torch.sum(u * u, dim=1)
        mu = (torch.sum(u * hu, dim=1) / (den + 1e-12)).cpu().numpy()

    x = batch["x"][:, 0].cpu().numpy().astype(np.float64)
    dx = x[1] - x[0]
    u_np = u.cpu().numpy().astype(np.float64)
    rows = []
    for i, b in enumerate(betas):
        mu_ref, psi_ref = solve_gpe_excited_1d(b * x ** 2, dx, float(gamma), 0,
                                               kinetic=spec.kinetic, p=spec.p,
                                               nonlinearity=spec.nonlinearity,
                                               device=device)
        psi_ref = psi_ref.cpu().numpy()
        psi = u_np[i] / np.sqrt(np.sum(u_np[i] ** 2) * dx)
        psi_ref_n = psi_ref / np.sqrt(np.sum(psi_ref ** 2) * dx)
        if np.sum(psi * psi_ref_n) < 0:
            psi = -psi
        rows.append({"beta": b, "mu_pred": float(mu[i]), "mu_ref": float(mu_ref),
                     "mu_abs_err": float(abs(mu[i] - mu_ref)),
                     "psi_l2_err": float(np.sqrt(np.sum((psi - psi_ref_n) ** 2) * dx))})
    return rows, u_np, x
