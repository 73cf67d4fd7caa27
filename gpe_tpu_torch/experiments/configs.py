"""Experiment registry, port of `gpe_tpu/experiments/configs.py`.

`EXPERIMENTS` holds every `plpinn` configuration of the JAX registry whose
parts the port has (bases, potentials, ansatz, trainer); `WAITING` names
each other JAX configuration and what it waits for, and
`experiments/run.py` raises NotImplementedError with that text.
"""
from __future__ import annotations

from dataclasses import dataclass, replace

from gpe_tpu_torch.train.problem import GPESpec


@dataclass(frozen=True)
class ExperimentConfig:
    name: str
    spec: GPESpec
    gamma_values: tuple = (0.0,)
    beta_values: tuple = ()              # two-stage runs
    modes: tuple = (0,)
    epochs: int = 5001
    tol: float = 1e-5
    patience: int = 2000
    perturb_const: float = 0.01
    lr: float = 1e-3
    pretrain_epochs: int = 2000
    p_values: tuple = (2.0, 3.0, 4.0, 5.0)   # p-ramp runs
    optimizers: tuple = ()               # optimizer-sweep runs
    n_runs: int = 1                      # >1 → multi-seed statistical protocol
    seed: int = 0
    rebase: bool = False
    algorithm: str = "plpinn"
    mu_exact_fn: str | None = None       # oracle for error tables
    use_mesh: bool = False               # collocation-sharded data parallelism
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


# --- the reference paper experiments (final/refine drivers) -----------------

_register(ExperimentConfig(
    name="harmonic_paper",                       # harmonic_pinn_simulation.py main
    spec=_PAPER_1D, gamma_values=_gammas(201), modes=(0, 1, 2, 3, 4, 5)))

_register(ExperimentConfig(
    name="harmonic_quick",                       # reduced ramp for smoke runs
    spec=_PAPER_1D, gamma_values=_gammas(21), modes=(0,), epochs=2001))

_register(ExperimentConfig(
    name="gaussian_paper",
    spec=replace(_PAPER_1D, potential="gaussian"),
    gamma_values=_gammas(201), modes=(0,)))

_register(ExperimentConfig(
    name="harmonic_negative_gamma",              # ..._negative_interaction_strength.py
    spec=_PAPER_1D, gamma_values=tuple(-0.5 * k for k in range(41)), modes=(0,)))

for _p in (4, 8, 16):
    _register(ExperimentConfig(
        name=f"harmonic_p{_p}",
        spec=replace(_PAPER_1D, p=float(_p)), gamma_values=_gammas(201), modes=(0,)))

# --- BASELINE.json configs ---------------------------------------------------

_register(ExperimentConfig(
    name="linear_1d_sanity",                     # config #1: γ=0, μ=0.5 (−½Δ+½x²)
    spec=replace(_PAPER_1D, n_points=2000, potential_kwargs=(("a", 0.5),),
                 kinetic=0.5),
    gamma_values=(0.0,), epochs=3000))

_register(ExperimentConfig(
    name="gpe1d_tf",                             # config #2: β∈{10,100} vs TF
    spec=replace(_PAPER_1D, n_points=2000, lb=-14.0, ub=14.0,
                 nonlinearity="abs_power"),
    gamma_values=(0.0, 2.0, 5.0, 10.0, 20.0, 40.0, 70.0, 100.0),
    epochs=8000, rebase=True))

_register(ExperimentConfig(
    name="gpe2d_ground_state",                   # config #3: 2D, β=100, 50k pts
    spec=GPESpec(dim=2, lb=-8.0, ub=8.0, n_points=224,
                 layers=(2, 128, 128, 128, 1), activation="shifted_tanh",
                 potential="harmonic", potential_kwargs=(("a", 0.5),),
                 basis="hermite", kinetic=0.5, nonlinearity="abs_power",
                 bc_weight=10.0, norm_weight=20.0),
    gamma_values=(0.0, 5.0, 10.0, 20.0, 35.0, 50.0, 70.0, 100.0),
    epochs=8000, rebase=True, lm_polish=True))

_register(ExperimentConfig(
    name="gpe2d_lattice",                        # config #4: optical lattice
    spec=GPESpec(dim=2, lb=-8.0, ub=8.0, n_points=128,
                 layers=(2, 128, 128, 128, 1), activation="shifted_tanh",
                 potential="optical_lattice",
                 potential_kwargs=(("V0", 4.0), ("k", 0.7853981633974483)),
                 basis="hermite", kinetic=0.5, nonlinearity="abs_power"),
    gamma_values=(0.0, 5.0, 10.0, 20.0), epochs=8000, rebase=True))

_BOX = "the box basis and the hard-BC ansatz (gpe_tpu.physics.bases.box_basis, " \
       "gpe_tpu.models.ansatz.hard_bc_ansatz)"
_AIRY = "the Airy basis (gpe_tpu.physics.bases.airy_basis)"

# the JAX registry's other configurations and what each waits for
WAITING = {
    "box_paper": _BOX,
    "gravity_well_paper": _AIRY,
    "deeponet_harmonic": "the DeepONet trainer (gpe_tpu.deeponet.model.train_deeponet)",
    "plpinn_sharded_dp": "collocation-sharded training (gpe_tpu.parallel.make_mesh, "
                         "train_plpinn(mesh=))",
    "two_stage_beta_gamma": "the two-stage trainer (gpe_tpu.train.two_stage.train_two_stage)",
    "compare_harmonic_mode0": "the method comparison (gpe_tpu.train.compare.compare_methods)",
    "multirun_harmonic_mode0": "the multi-run protocol "
                               "(gpe_tpu.train.compare.train_multiple_runs)",
    "multirun_box_mode0": "the multi-run protocol "
                          "(gpe_tpu.train.compare.train_multiple_runs) and " + _BOX,
    "gpe2d_circle": "the disk geometry (gpe_tpu.ops.geometry) and run.py's fit branch",
    "vary_beta_harmonic": "the β-sweep trainer (gpe_tpu.train.beta_sweep.train_beta_sweep)"
                          " and " + _BOX,
    "vary_beta_gravity_well": "the β-sweep trainer "
                              "(gpe_tpu.train.beta_sweep.train_beta_sweep) and " + _AIRY,
    "vary_beta_box_gaussian": "the β-sweep trainer "
                              "(gpe_tpu.train.beta_sweep.train_beta_sweep) and " + _BOX,
    "p_ramp_harmonic": "the p-ramp trainer (gpe_tpu.train.p_ramp.train_p_ramp)",
    "deflation_harmonic": "the deflation trainer (gpe_tpu.train.deflation.train_deflation)"
                          " and the Riesz objective",
    "helmholtz_square": "the Helmholtz trainer (gpe_tpu.helmholtz.problem.train_helmholtz)",
    "helmholtz_circle": "the Helmholtz trainer (gpe_tpu.helmholtz.problem.train_helmholtz)",
    "helmholtz_inverse_k": "the Helmholtz trainer "
                           "(gpe_tpu.helmholtz.problem.train_helmholtz)",
    "gpe2d_relobralo": "the ReLoBRaLo trainer (gpe_tpu.train.balanced.fit_relobralo)",
    "harmonic_self_adaptive": "self-adaptive weighting "
                              "(gpe_tpu.losses.balancing.self_adaptive_total) and "
                              "run.py's fit branch",
    "gpe2d_anti_trivial": "the anti-trivial loss terms (gpe_tpu.losses.gpe.gpe_terms) "
                          "and run.py's fit branch",
    "riesz_mode0": "the Riesz objective (gpe_tpu.losses.gpe.gpe_terms) and run.py's "
                   "fit branch",
    "different_optimizers_harmonic": "the curriculum trainer and the optimizer zoo "
                                     "(gpe_tpu.train.curriculum.train_curriculum)",
    "mode0_all_potentials": "the cross-potential branch of run.py and " + _BOX
                            + " and " + _AIRY,
    "deflation_2d": "the deflation trainer (gpe_tpu.train.deflation.train_deflation) "
                    "and the Riesz objective",
}
