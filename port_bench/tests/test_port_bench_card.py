"""Each cell once on the card, a short window, as the command runs it:
`correct` true, the cell's metrics present, no JAX loaded. Skips without a
CUDA card (decided inside the test)."""
import json
import subprocess
import sys

import pytest

from port_bench import harness
from port_bench.run import ROOT


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("name", ["gs2d.ramp", "gs2d.polish", "lattice.polish"])
def test_cell_on_the_card(name, trace):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    r = subprocess.run([sys.executable, "port_bench/run.py", "--workload", name,
                        "--seed", "2147483659", "--seconds", "2", "--trace", str(trace)],
                       cwd=ROOT, capture_output=True, text=True, timeout=360)
    assert r.returncode == 0, r.stderr[-3000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["correct"] is True, out["checks"]
    want = {m["name"] for m in harness.metrics_of(ROOT, name, bool(trace))}
    assert set(out["metrics"]) == want
    assert out["device"]["platform"] == "gpu" and out["device"]["count"] == 1
