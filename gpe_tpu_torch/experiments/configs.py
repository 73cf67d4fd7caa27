"""Experiment registry, port of `gpe_tpu/experiments/configs.py`.

`EXPERIMENTS` holds every configuration of the JAX registry whose parts the
port has (bases, potentials, ansatz, loss terms, trainer, runner branch):
the `plpinn`, `fit`, `cross_potential`, `compare`, `two_stage`,
`beta_sweep`, `p_ramp`, `deflation`, `relobralo`, `optimizer_sweep`,
`helmholtz` and `deeponet` ones (the Helmholtz configs' specs come from
`helmholtz_specs()`): every configuration of the JAX registry. `WAITING`
would name a JAX configuration the port cannot build and what it waits
for (it is empty), and `experiments/run.py` raises NotImplementedError
with that text.
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
    name="box_paper",                            # box_pinn_simulation.py
    spec=replace(_PAPER_1D, lb=0.0, ub=1.0, potential="box", basis="box",
                 hard_bc=True),
    gamma_values=_gammas(201), modes=(0, 1)))

_register(ExperimentConfig(
    name="gravity_well_paper",                   # gravity_well_pinn_simulation.py
    spec=replace(_PAPER_1D, lb=0.0, ub=35.0, potential="linear", basis="airy"),
    gamma_values=_gammas(401, 0.25), modes=(0, 1)))

_register(ExperimentConfig(
    name="gaussian_paper",
    spec=replace(_PAPER_1D, potential="gaussian"),
    gamma_values=_gammas(201), modes=(0,)))

_register(ExperimentConfig(
    name="harmonic_negative_gamma",              # ..._negative_interaction_strength.py
    spec=_PAPER_1D, gamma_values=tuple(-0.5 * k for k in range(41)), modes=(0,)))

_register(ExperimentConfig(
    name="plpinn_sharded_dp",                    # collocation-sharded training:
    # the paper 1D spec with its 4,000 points sharded over the ranks of the
    # process group (torchrun), the quadrature sums all-reduced
    spec=_PAPER_1D, gamma_values=_gammas(11, 1.0), modes=(0,), epochs=3001,
    use_mesh=True))

for _p in (4, 8, 16):
    _register(ExperimentConfig(
        name=f"harmonic_p{_p}",
        spec=replace(_PAPER_1D, p=float(_p)), gamma_values=_gammas(201), modes=(0,)))

# --- the method comparison (the `compare` branch) ---------------------------

_register(ExperimentConfig(
    name="compare_harmonic_mode0",               # plot_harmonic_potential_at_ground_state.py
    spec=_PAPER_1D, algorithm="compare", gamma_values=(100.0,), modes=(0,)))

_register(ExperimentConfig(
    name="multirun_harmonic_mode0",              # the multi-seed protocol, 5 seeds, γ=20
    spec=_PAPER_1D, algorithm="compare", gamma_values=(20.0,), modes=(0,),
    n_runs=5))

_register(ExperimentConfig(
    name="multirun_box_mode0",                   # ..._multiple_runs.py (5 seeds)
    # PL against vanilla at γ=0, where the 1e-11 / 1e-5 success thresholds
    # of the reference's multirun protocol apply
    spec=replace(_PAPER_1D, lb=0.0, ub=1.0, potential="box", basis="box",
                 hard_bc=True),
    algorithm="compare", gamma_values=(0.0,), modes=(0,), n_runs=5))

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
    name="gpe2d_circle",                         # gross_pitaevskii_2D.py:277-295
    # circular training domain r=π/2 around (π/2,π/2), N_f=10000, N_u=500
    spec=GPESpec(dim=2, lb=0.0, ub=3.141592653589793, n_points=100,
                 geometry="disk", n_boundary=500,
                 layers=(2, 100, 100, 100, 1), activation="tanh",
                 potential="gaussian",
                 potential_kwargs=(("V0", 1.0),
                                   ("center", (1.5707963267948966, 1.5707963267948966)),
                                   ("sigma", 0.5)),
                 kinetic=0.5, nonlinearity="abs_power", use_perturbation=False,
                 bc_weight=10.0, norm_weight=20.0),
    algorithm="fit", gamma_values=(10.0,), epochs=3000))

# --- loss-strategy experiments (the `fit` branch) ----------------------------

_register(ExperimentConfig(
    name="harmonic_self_adaptive",               # src/..._Self_Adaptive.py
    spec=replace(_PAPER_1D, n_points=2000, weighting="self_adaptive",
                 use_perturbation=False, nonlinearity="abs_power"),
    algorithm="fit", gamma_values=(0.0, 10.0), epochs=4000))

_register(ExperimentConfig(
    name="gpe2d_anti_trivial",                   # gross_pitaevskii_2D.py:197-211
    spec=GPESpec(dim=2, lb=-6.0, ub=6.0, n_points=100,
                 layers=(2, 100, 100, 100, 1), activation="tanh",
                 potential="harmonic", potential_kwargs=(("a", 0.5),),
                 kinetic=0.5, nonlinearity="abs_power", use_perturbation=False,
                 anti_trivial=True, anti_trivial_weight=0.1),
    algorithm="fit", gamma_values=(10.0,), epochs=12000))

_register(ExperimentConfig(
    name="riesz_mode0",                          # 1D_GPE_Riesz_Method notebook
    spec=replace(_PAPER_1D, n_points=2000, objective="riesz",
                 nonlinearity="abs_power"),
    algorithm="fit", gamma_values=(0.0, 1.0, 10.0, 100.0), epochs=4000))

_register(ExperimentConfig(
    name="gpe2d_lattice",                        # config #4: optical lattice
    spec=GPESpec(dim=2, lb=-8.0, ub=8.0, n_points=128,
                 layers=(2, 128, 128, 128, 1), activation="shifted_tanh",
                 potential="optical_lattice",
                 potential_kwargs=(("V0", 4.0), ("k", 0.7853981633974483)),
                 basis="hermite", kinetic=0.5, nonlinearity="abs_power"),
    gamma_values=(0.0, 5.0, 10.0, 20.0), epochs=8000, rebase=True))

_register(ExperimentConfig(
    name="mode0_all_potentials",                 # F6: mode_0_loss_for_all_potentials.py
    spec=_PAPER_1D,                              # per-family specs: run.py
    algorithm="cross_potential", gamma_values=_gammas(11, 1.0),
    modes=(0,), epochs=2001))

# --- continuation and excited-state trainers ---------------------------------

_register(ExperimentConfig(
    name="two_stage_beta_gamma",                 # test_perturbing_gamma_and_beta.py
    spec=_PAPER_1D, algorithm="two_stage",
    beta_values=tuple(1.0 + 0.1 * k for k in range(11)),
    gamma_values=_gammas(21)))

_register(ExperimentConfig(
    name="vary_beta_harmonic",                   # vary_potential_parameter_harmonic.py main
    spec=replace(_PAPER_1D, lb=0.0, ub=5.0, hard_bc=True, basis="box",
                 potential="harmonic"),
    algorithm="beta_sweep",
    beta_values=tuple(0.01 * k for k in range(101)),
    gamma_values=(0.0,), modes=(0,), epochs=2001))

_register(ExperimentConfig(
    name="vary_beta_gravity_well",               # vary_potential_parameter_gravity_well.py
    spec=replace(_PAPER_1D, lb=0.0, ub=35.0, potential="linear", basis="airy"),
    algorithm="beta_sweep",
    beta_values=(1.0, 20.0, 40.0, 60.0, 80.0, 100.0),
    gamma_values=(0.0,), modes=(0,), epochs=2001))

_register(ExperimentConfig(
    name="vary_beta_box_gaussian",               # vary_potential_parameter_box_and_gaussian.py
    # a hard-walled box whose base stays the box sine while a Gaussian bump
    # V = β·exp(−x²/2) ramps in: the box→Gaussian interpolation
    spec=replace(_PAPER_1D, lb=0.0, ub=1.0, potential="gaussian",
                 potential_kwargs=(("sigma", 1.0),), basis="box", hard_bc=True),
    algorithm="beta_sweep",
    beta_values=tuple(0.05 * k for k in range(21)),
    gamma_values=(0.0,), modes=(0,), epochs=2001))

_register(ExperimentConfig(
    name="p_ramp_harmonic",                      # ..._and_Nonlinearity_Powers.py
    spec=replace(_PAPER_1D, nonlinearity="abs_power"),
    algorithm="p_ramp", gamma_values=(10.0,), modes=(0,), epochs=2001))

_register(ExperimentConfig(
    name="deflation_harmonic",                   # BASELINE config #5 (part 1)
    spec=GPESpec(lb=-8.0, ub=8.0, n_points=2000, layers=(1, 64, 64, 1),
                 potential="harmonic", kinetic=1.0, nonlinearity="abs_power",
                 activation="tanh", bc_weight=10.0, norm_weight=20.0,
                 objective="riesz"),
    algorithm="deflation", gamma_values=(10.0,), modes=(0, 1, 2, 3),
    epochs=6000, lr=1e-3))

_register(ExperimentConfig(
    name="deflation_2d",                         # 2D excited states, no analytic bases
    # sequential deflation resolves the degenerate first excited doublet of
    # the 2D trap at γ = 5; the Riesz (energy) objective makes mode 0 land
    # on the GROUND state (the pure residual objective accepts any
    # eigenstate)
    spec=GPESpec(dim=2, lb=-6.0, ub=6.0, n_points=80,
                 layers=(2, 64, 64, 64, 1), activation="tanh",
                 potential="harmonic", potential_kwargs=(("a", 0.5),),
                 kinetic=0.5, nonlinearity="abs_power", use_perturbation=False,
                 objective="riesz", bc_weight=10.0, norm_weight=20.0),
    algorithm="deflation", gamma_values=(5.0,), modes=(0, 1, 2), epochs=6000))

_register(ExperimentConfig(
    name="gpe2d_relobralo",                      # src/gross_pitaevskii_2D_ReLoBRaLo.py
    spec=GPESpec(dim=2, lb=-6.0, ub=6.0, n_points=100,
                 layers=(2, 100, 100, 100, 1), activation="tanh",
                 potential="harmonic", potential_kwargs=(("a", 0.5),),
                 kinetic=0.5, nonlinearity="abs_power", use_perturbation=False,
                 symmetry="y_even", sym_weight=500.0, riesz_weight=1.0,
                 bc_weight=500.0, norm_weight=100.0, pde_weight=2.0),
    algorithm="relobralo", gamma_values=(10.0,), epochs=3000))

# --- Helmholtz family (reference src/helmholtz_2D*.py, learnable-k notebook) --

def helmholtz_specs():
    """The Helmholtz configs' specs (their ExperimentConfig has spec None)."""
    from gpe_tpu_torch.helmholtz.problem import HelmholtzSpec
    return {
        "helmholtz_square": HelmholtzSpec(domain="square", k=2.0),
        "helmholtz_circle": HelmholtzSpec(domain="circle", k=3.0, mode_n=1),
        "helmholtz_inverse_k": HelmholtzSpec(domain="square", k=3.0,
                                             learnable_k=True,
                                             learnable_bc_scale=True),
    }


for _name in ("helmholtz_square", "helmholtz_circle", "helmholtz_inverse_k"):
    _register(ExperimentConfig(name=_name, spec=None, algorithm="helmholtz",
                               epochs=4000))

_register(ExperimentConfig(
    name="different_optimizers_harmonic",        # src/gross_pitaevskii_1D_Different_Optimizers.py
    # main (:953-998): etas=[0,10,20,30,40], [1,100,100,100,1] net, curriculum
    # trainer run once per optimizer of the dict-dispatch zoo
    spec=GPESpec(lb=-10.0, ub=10.0, n_points=4000,
                 layers=(1, 100, 100, 100, 1), activation="tanh",
                 potential="harmonic", basis="hermite", p=3.0, kinetic=1.0,
                 nonlinearity="power", use_perturbation=True),
    algorithm="optimizer_sweep", gamma_values=(0.0, 10.0, 20.0, 30.0, 40.0),
    epochs=3000,
    optimizers=("adam", "adamw", "qhadam", "adabelief", "sophia",
                "adahessian", "shampoo")))

_register(ExperimentConfig(
    name="deeponet_harmonic",                    # operator learning: the V=βx²
    # family → ψ; held-out-β generalization vs the FDM oracle
    # (Gross_Pitaevskii_1D_Physics_Informed_DeepONet.ipynb cells 3,9,11)
    spec=_PAPER_1D, gamma_values=(1.0,), epochs=20000, algorithm="deeponet"))

# the JAX registry's configurations the port cannot build yet, each with what
# it waits for (none at present); experiments/run.py raises NotImplementedError
# with that text
WAITING: dict[str, str] = {}
