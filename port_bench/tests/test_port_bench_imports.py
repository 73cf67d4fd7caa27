"""Nothing a cell's run loads has the top-level name jax, jaxlib, flax or
gpe_tpu; the check compares whole top-level names."""
import json
import subprocess
import sys

import pytest

from port_bench import harness
from port_bench.run import ROOT

SCRIPT = """
import json, sys
sys.path.insert(0, sys.argv[1])
from port_bench.run import run_cell
from port_bench.tests._tiny import tiny
from port_bench import harness
run_cell(sys.argv[2], 3, 0.0, False, device="cpu", overrides=tiny)
print(json.dumps({"found": harness.forbidden_modules(),
                  "top": sorted({m.split(".")[0] for m in sys.modules})}))
"""


@pytest.mark.parametrize("name", ["gs2d.ramp", "lattice.polish"])
def test_a_run_loads_no_jax(name):
    r = subprocess.run([sys.executable, "-c", SCRIPT, str(ROOT), name], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["found"] == []
    assert "gpe_tpu_torch" in out["top"] and "torch" in out["top"]
    assert not set(out["top"]) & set(harness.FORBIDDEN)


def test_the_check_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "gpe_tpu_torch_extra", object())
    assert harness.forbidden_modules() == [] or "gpe_tpu_torch_extra" not in \
        harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "gpe_tpu.train", object())
    monkeypatch.setitem(sys.modules, "jaxlib", object())
    assert {"gpe_tpu.train", "jaxlib"} <= set(harness.forbidden_modules())


def test_no_card_no_result(capsys):
    import torch

    from port_bench import run

    if torch.cuda.is_available():
        pytest.skip("a card is present: this test is of a machine without one")
    rc = run.main(["--workload", "gs2d.ramp", "--seed", "1", "--seconds", "1"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == ""
