"""The paper's comparison families, port of `gpe_tpu/experiments/paper_tables.py`
(`CHECKPOINTS` and `_families()` only, for the families the port can build).

Each family is one spec at the paper's widths (4,000 points, [1,64,64,64,1]
shifted_tanh, p-power nonlinearity), its modes and the checkpoint γ values
its parity cells are scored at. `family(name)` raises NotImplementedError
for the families whose bases or ansatz the port does not have yet.
"""
from __future__ import annotations

CHECKPOINTS = (0.0, 20.0, 40.0, 60.0, 80.0, 100.0)

# families of the JAX package that wait for parts the port lacks
_WAITING = {
    "p3_box": "the box basis and the hard-BC ansatz "
              "(gpe_tpu.physics.bases.box_basis, gpe_tpu.models.ansatz.hard_bc_ansatz)",
    "p3_gravity_well": "the Airy basis (gpe_tpu.physics.bases.airy_basis)",
    "p3_gaussian": "the box basis and the hard-BC ansatz "
                   "(gpe_tpu.physics.bases.box_basis, gpe_tpu.models.ansatz.hard_bc_ansatz)",
}


def _families():
    from gpe_tpu_torch.train.problem import GPESpec

    paper = dict(n_points=4000, layers=(1, 64, 64, 64, 1),
                 activation="shifted_tanh", kinetic=1.0, nonlinearity="power",
                 bc_weight=10.0, norm_weight=20.0)
    harmonic = dict(lb=-10.0, ub=10.0, potential="harmonic", basis="hermite")
    return {
        "p3_harmonic": dict(spec=GPESpec(p=3.0, **harmonic, **paper),
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
    }


def family(name: str) -> dict:
    """The family `name`: {"spec", "modes", "checkpoints"[, "gamma_step"]}."""
    if name in _WAITING:
        raise NotImplementedError(
            f"family {name!r} waits for {_WAITING[name]}, not ported yet")
    fams = _families()
    if name not in fams:
        raise KeyError(f"unknown family {name!r}; have {sorted(fams)}")
    return fams[name]
