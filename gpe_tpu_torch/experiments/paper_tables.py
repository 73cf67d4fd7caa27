"""The paper's comparison families, port of `gpe_tpu/experiments/paper_tables.py`
(`CHECKPOINTS` and `_families()`; `run_family` waits for the vmapped
ensemble trainer, `gpe_tpu.train.loop.fit_ensemble`).

Each family is one spec at the paper's widths (4,000 points, [1,64,64,64,1]
shifted_tanh, p-power nonlinearity), its modes and the checkpoint γ values
its parity cells are scored at. The box and Gaussian families are hard-BC
(ψ = base + s·sin(πx)·N), which the fused kernels do not model: they train
on the plain autograd path, as in the JAX package.
"""
from __future__ import annotations

CHECKPOINTS = (0.0, 20.0, 40.0, 60.0, 80.0, 100.0)


def _families():
    from gpe_tpu_torch.train.problem import GPESpec

    paper = dict(n_points=4000, layers=(1, 64, 64, 64, 1),
                 activation="shifted_tanh", kinetic=1.0, nonlinearity="power",
                 bc_weight=10.0, norm_weight=20.0)
    harmonic = dict(lb=-10.0, ub=10.0, potential="harmonic", basis="hermite")
    return {
        "p3_harmonic": dict(spec=GPESpec(p=3.0, **harmonic, **paper),
                            modes=(0, 1, 2, 3, 4, 5), checkpoints=CHECKPOINTS),
        # the direct-net baselines of the box family (μ up to ~500) run with
        # warmup_cosine at lr 1e-3 (the JAX package's A/B,
        # runs/ab_box_baselines/summary.json)
        "p3_box": dict(spec=GPESpec(lb=0.0, ub=1.0, potential="box", basis="box",
                                    hard_bc=True, p=3.0, **paper),
                       modes=(0, 1, 2, 3, 4, 5), checkpoints=CHECKPOINTS,
                       baseline=dict(lr=1e-3, lr_mode="warmup_cosine")),
        # the Δγ = 0.5 ramp of every family (the reference's gravity ramp is
        # Δγ = 0.25)
        "p3_gravity_well": dict(spec=GPESpec(lb=0.0, ub=35.0, potential="linear",
                                             basis="airy", p=3.0, **paper),
                                modes=(0, 1, 2, 3, 4, 5), checkpoints=CHECKPOINTS),
        # γ grid of the reference artifact (0 … −20 step −4, modes 0–5)
        "neg_p3_harmonic": dict(spec=GPESpec(p=3.0, **harmonic, **paper),
                                modes=(0, 1, 2, 3, 4, 5),
                                checkpoints=(0.0, -4.0, -8.0, -12.0, -16.0, -20.0),
                                gamma_step=-0.5),
        "p4_harmonic": dict(spec=GPESpec(p=4.0, **harmonic, **paper),
                            modes=(0, 1, 2, 3, 4, 5), checkpoints=CHECKPOINTS),
        "p8_harmonic": dict(spec=GPESpec(p=8.0, **harmonic, **paper),
                            modes=(0,), checkpoints=CHECKPOINTS),
        "p16_harmonic": dict(spec=GPESpec(p=16.0, **harmonic, **paper),
                             modes=(0,), checkpoints=CHECKPOINTS),
        # a Gaussian bump V = exp(−x²/2) in the unit box on the box base,
        # hard BC (the reference's hardest family)
        "p3_gaussian": dict(spec=GPESpec(lb=0.0, ub=1.0, potential="gaussian",
                                         potential_kwargs=(("sigma", 1.0),),
                                         basis="box", hard_bc=True, p=3.0, **paper),
                            modes=(0,), checkpoints=CHECKPOINTS),
    }


def family(name: str) -> dict:
    """The family `name`: {"spec", "modes", "checkpoints"[, "gamma_step",
    "baseline"]}."""
    fams = _families()
    if name not in fams:
        raise KeyError(f"unknown family {name!r}; have {sorted(fams)}")
    return fams[name]
