"""A cell, a traffic mix, a configuration with its own reference module and
a metric added as files only, without editing a file the benchmark has,
are found and run."""
import json
import shutil
import subprocess
import sys

from port_bench.run import ROOT

SCRIPT = """
import json, sys
sys.path.insert(0, sys.argv[1])
from port_bench.run import run_cell
from port_bench.tests._tiny import tiny
from pathlib import Path
out = run_cell("gs2d.polish2", 5, 0.0, False, root=Path(sys.argv[1]), device="cpu",
               overrides=tiny)
out["loaded"] = sorted(m for m in sys.modules if m.startswith("port_bench.reference"))
print(json.dumps(out))
"""


def test_a_cell_added_as_files_runs(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "port_bench", tmp_path / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    pb = tmp_path / "port_bench"
    cfg = json.loads((pb / "configs" / "gpe2d_ground_state.json").read_text())
    cfg["name"] = "gpe2d_ground_state_b"
    cfg["reference"] = "reference_b"
    shutil.copy(pb / "reference.py", pb / "reference_b.py")
    (pb / "configs" / "gpe2d_ground_state_b.json").write_text(json.dumps(cfg))
    traffic = json.loads((pb / "traffic" / "polish.json").read_text())
    traffic["check_steps"] = 1
    (pb / "traffic" / "polish_short.json").write_text(json.dumps(traffic))
    (pb / "metrics" / "calls_in_window.py").write_text(
        "def read(rec):\n    return float(len(rec['calls'])) if rec['kind'] == 'lm' else None\n")
    (pb / "limits" / "gs2d.polish2.json").write_text(
        (pb / "limits" / "gs2d.polish.json").read_text())
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append({**bench["configs"][0], "name": "gpe2d_ground_state_b",
                             "file": "port_bench/configs/gpe2d_ground_state_b.json"})
    bench["workloads"].append({"name": "gs2d.polish2", "config": "gpe2d_ground_state_b",
                               "traffic": "polish_short", "chips": 1, "why": "a test"})
    bench["end_to_end"].append({"name": "calls_in_window", "unit": "calls",
                                "better": "higher", "bound": 0.25, "source": "host_clock",
                                "workloads": ["gs2d.polish2"]})
    for m in bench["end_to_end"]:
        if m["name"] == "lm_step_ms":
            m["workloads"].append("gs2d.polish2")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    r = subprocess.run([sys.executable, "-c", SCRIPT, str(tmp_path)], cwd=tmp_path,
                       capture_output=True, text=True, timeout=300,
                       env={"PYTHONPATH": str(ROOT), "PATH": "/usr/bin:/bin"})
    assert r.returncode == 0, r.stderr[-3000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["metrics"]["calls_in_window"]["value"] >= 1
    assert set(out["metrics"]) == {"calls_in_window", "lm_step_ms", "setup_s"}
    assert out["correct"] is True, out["checks"]
    assert "port_bench.reference_b" in out["loaded"]
