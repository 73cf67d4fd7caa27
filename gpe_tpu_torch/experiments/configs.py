"""Experiment registry, port of `gpe_tpu/experiments/configs.py` for the
configurations the port runs so far: BASELINE configs #1 and #3 and the
paper's 1D harmonic sweep (`harmonic_paper`, the packed ensemble path)."""
from __future__ import annotations

from dataclasses import dataclass, replace

from gpe_tpu_torch.train.problem import GPESpec


@dataclass(frozen=True)
class ExperimentConfig:
    name: str
    spec: GPESpec
    gamma_values: tuple = (0.0,)
    modes: tuple = (0,)
    epochs: int = 5001
    tol: float = 1e-5
    patience: int = 2000
    perturb_const: float = 0.01
    lr: float = 1e-3
    pretrain_epochs: int = 2000
    seed: int = 0
    rebase: bool = False
    lm_polish: bool = False              # LM residual polish at the final γ


def _gammas(n: int, step: float = 0.5, start: float = 0.0):
    return tuple(start + k * step for k in range(n))


_PAPER_1D = GPESpec(lb=-10.0, ub=10.0, n_points=4000, layers=(1, 64, 64, 64, 1),
                    activation="shifted_tanh", potential="harmonic",
                    basis="hermite", p=3.0, kinetic=1.0, nonlinearity="power",
                    bc_weight=10.0, norm_weight=20.0)

EXPERIMENTS: dict[str, ExperimentConfig] = {}


def _register(cfg: ExperimentConfig):
    EXPERIMENTS[cfg.name] = cfg
    return cfg


_register(ExperimentConfig(
    name="harmonic_paper",                       # harmonic_pinn_simulation.py main
    spec=_PAPER_1D, gamma_values=_gammas(201), modes=(0, 1, 2, 3, 4, 5)))

_register(ExperimentConfig(
    name="linear_1d_sanity",                     # config #1: γ=0, μ=0.5 (−½Δ+½x²)
    spec=replace(_PAPER_1D, n_points=2000, potential_kwargs=(("a", 0.5),),
                 kinetic=0.5),
    gamma_values=(0.0,), epochs=3000))

_register(ExperimentConfig(
    name="gpe2d_ground_state",                   # config #3: 2D, β=100, 50k pts
    spec=GPESpec(dim=2, lb=-8.0, ub=8.0, n_points=224,
                 layers=(2, 128, 128, 128, 1), activation="shifted_tanh",
                 potential="harmonic", potential_kwargs=(("a", 0.5),),
                 basis="hermite", kinetic=0.5, nonlinearity="abs_power",
                 bc_weight=10.0, norm_weight=20.0),
    gamma_values=(0.0, 5.0, 10.0, 20.0, 35.0, 50.0, 70.0, 100.0),
    epochs=8000, rebase=True, lm_polish=True))
