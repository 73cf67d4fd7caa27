"""The port stands alone: no module of gpe_tpu_torch (nor chip_smoke.py)
imports JAX or the gpe_tpu package, every module imports with JAX blocked,
and entry points never fall back to the CPU on their own."""
import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "gpe_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_modules(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _forbidden(name: str) -> bool:
    return (name == "jax" or name.startswith("jax.") or name == "jaxlib"
            or name.startswith("jaxlib.") or name == "gpe_tpu"
            or name.startswith("gpe_tpu."))


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_gpe_tpu_import(path):
    bad = [m for m in _imported_modules(path) if _forbidden(m)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_every_module_imports_with_jax_blocked():
    mods = sorted(".".join(p.relative_to(ROOT).with_suffix("").parts)
                  for p in (ROOT / "gpe_tpu_torch").rglob("*.py"))
    mods = [m[: -len(".__init__")] if m.endswith(".__init__") else m for m in mods]
    code = ("import sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['gpe_tpu'] = None\n"
            "import importlib\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "import chip_smoke\n"
            "print('ok', len(sys.modules))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def test_entry_points_without_device_raise_when_there_is_no_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    from gpe_tpu_torch.device import resolve_device
    from gpe_tpu_torch.models.mlp import init_mlp, params_from_numpy
    from gpe_tpu_torch.train import GPESpec, make_batch, train_plpinn
    from gpe_tpu_torch.train.problem import init_params

    spec = GPESpec(n_points=64, layers=(1, 8, 1))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_batch(spec, 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_params(spec)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_mlp((1, 8, 1))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        params_from_numpy([(np.zeros((1, 8)), np.zeros(8))])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_plpinn(spec, [0.0], epochs=2, pretrain_epochs=2)

    from gpe_tpu_torch.experiments import paper_tables, run
    from gpe_tpu_torch.ops import geometry
    from gpe_tpu_torch.train import beta_sweep, compare, deflation, p_ramp, two_stage
    from gpe_tpu_torch.physics.bases import airy_table
    from gpe_tpu_torch.validate import fdm, rotating
    from gpe_tpu_torch.validate.imaginary_time import imaginary_time_gpe

    x = np.linspace(-4.0, 4.0, 16)
    V2 = 0.5 * (x[:, None] ** 2 + x[None, :] ** 2)
    for call in (lambda: imaginary_time_gpe(x * x, 0.5, 1.0, steps=2),
                 lambda: fdm.linear_eigensolve_1d(x * x, 0.5, k=2),
                 lambda: fdm.solve_gpe_scf_1d(x * x, 0.5, 1.0, max_iter=1),
                 lambda: fdm.solve_gpe_scf_2d(V2, 0.5, 1.0, max_iter=1),
                 lambda: fdm.solve_gpe_excited_1d(x * x, 0.5, 0.0),
                 lambda: rotating.rotating_imaginary_time(V2, x, 1.0, 0.5, steps=2),
                 lambda: rotating.regrid_psi(V2.astype(complex), x, x),
                 lambda: run.main(["linear_1d_sanity", "--epochs", "1",
                                   "--out", str(tmp_path)]),
                 lambda: run.main(["gpe2d_circle", "--epochs", "1",
                                   "--out", str(tmp_path)]),
                 lambda: run.main(["mode0_all_potentials", "--epochs", "1",
                                   "--out", str(tmp_path)]),
                 lambda: run.main(["multirun_box_mode0", "--epochs", "1",
                                   "--out", str(tmp_path)]),
                 lambda: paper_tables.main(["--epochs", "1", "--out", str(tmp_path)]),
                 lambda: run.main(["vary_beta_gravity_well", "--epochs", "1",
                                   "--out", str(tmp_path)]),
                 lambda: compare.train_single_model(spec, 0.0, epochs=1),
                 lambda: beta_sweep.train_beta_sweep(spec, [1.0], epochs=1),
                 lambda: two_stage.train_two_stage(spec, [1.0], [0.0], epochs=1),
                 lambda: p_ramp.train_p_ramp(spec, [3.0], 0.0, epochs=1),
                 lambda: deflation.train_deflation(spec, 0.0, n_modes=1, epochs=1),
                 lambda: airy_table(),
                 lambda: geometry.disk_points((0.0, 0.0), 1.0, 8)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert resolve_device("cpu").type == "cpu"


def test_chip_smoke_refuses_without_a_card_or_the_package(tmp_path):
    """Without a CUDA device (or outside the repo) it exits non-zero and
    prints no result line."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    lone = tmp_path / "chip_smoke.py"
    lone.write_text((ROOT / "chip_smoke.py").read_text())
    for cwd, script in ((ROOT, ROOT / "chip_smoke.py"), (tmp_path, lone)):
        out = subprocess.run([sys.executable, str(script)], cwd=cwd,
                             capture_output=True, text=True, timeout=120)
        assert out.returncode != 0
        assert '"ok"' not in out.stdout
