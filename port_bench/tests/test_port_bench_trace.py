"""The per-layer arithmetic on a synthetic trace: no profiler, no card."""
import pytest

from port_bench import harness
from port_bench.trace import Trace, breakdown

K2 = "void gpe::grads_kernel<2, false>"
PAD = "gpe::pad_weights"
RED = "gpe::reduce_partials"
K1 = "void gpe::sums_kernel<2, false, false>"
ADD = "void at::native::vectorized_elementwise_kernel<4, add>"


def _fit_record():
    # two steps: each a K2 launch (pad 1, grads 10, reduce 1 µs) and a torch
    # add (2 µs); one K1 launch (3 µs + its reduce 1 µs) before them
    dev = [(K1, 0, 3), (RED, 3, 4),
           (PAD, 10, 11), (K2, 11, 21), (RED, 21, 22), (ADD, 30, 32),
           (PAD, 40, 41), (K2, 41, 51), (RED, 51, 52), (ADD, 60, 62)]
    rt = [("cudaLaunchKernel", -2, -1), ("cudaLaunchKernel", 8, 9),
          ("cudaLaunchKernel", 9, 10), ("cudaLaunchKernel", 20, 21),
          ("cudaMemcpyAsync", 52, 58), ("cudaLaunchKernel", 38, 39),
          ("cudaStreamSynchronize", 62, 64)]
    tr = Trace(device=dev, runtime=rt)
    rung = {"traced": True, "steps": 2, "wall_s": 1.0,
            "launches": {"fused_residual": 1, "fused_grad": 2}}
    return {"kind": "fit", "trace": tr, "rungs": [rung, {**rung, "traced": False}],
            "n_points": 100, "layers": [2, 8, 8, 1], "n_boundary": 4, "setup_s": 1.0}


def test_union_span_idle():
    tr = _fit_record()["trace"]
    assert tr.busy_us() == pytest.approx(3 + 1 + 12 + 2 + 12 + 2)
    assert tr.span_us() == pytest.approx(64 - (-2))
    assert tr.idle_share() == pytest.approx(1 - 32 / 66)
    # overlapping activities count once
    assert Trace(device=[("a", 0, 10), ("b", 5, 12), ("c", 20, 21)]).busy_us() == 13


def test_launch_counts_and_gaps():
    tr = Trace(runtime=[("cudaLaunchKernel", 0, 1), ("cudaGraphLaunch", 1, 2),
                        ("cuLaunchKernel", 2, 3), ("cudaMemcpyAsync", 3, 4)])
    assert tr.launch_calls() == 3 and tr.graph_launches() == 1
    gaps = _fit_record()["trace"].idle_gaps()
    # 4→10: mostly in a launch; 22→30 nothing; 32→40 a launch for 1 µs;
    # 52→60: the copy (a gap goes whole to the call that covers most of it)
    assert gaps["cudaMemcpyAsync"] == pytest.approx(8e-6)
    assert gaps["cudaLaunchKernel"] == pytest.approx(6e-6 + 8e-6)
    assert gaps["host"] == pytest.approx(8e-6)
    b = breakdown(_fit_record()["trace"])
    assert b["device_ops"][0] == [K2, pytest.approx(20e-6)]
    assert len(b["device_ops"]) <= 10 and len(b["idle_gaps"]) <= 10


def test_fit_readers():
    rec = _fit_record()
    read = lambda m: harness.read_metric(m, rec)
    assert read("fit.launch_calls_per_step") == pytest.approx(5 / 2)
    assert read("fit.torch_ops_device_ms") == pytest.approx(4e-3 / 2)
    assert read("device_idle.fit") == pytest.approx(100 * (1 - 32 / 66))
    # K2: pad + grads + the reduce after grads, not K1's reduce: 12 µs a launch
    from port_bench.counts import k2_bytes, matmul_flops
    bound = max(matmul_flops([2, 8, 8, 1], 100, True) / (495e12 / 3),
                k2_bytes([2, 8, 8, 1], 100) / 3.35e12)
    assert read("k2.roofline") == pytest.approx(100 * bound / 12e-6)
    # the mfu and the rate read the unprofiled rung only
    flops = matmul_flops([2, 8, 8, 1], 100, True)
    assert read("fit.mfu") == pytest.approx(100 * flops * 2 / 1.0 / (495e12 / 3))
    assert read("fit_pts_per_s") == pytest.approx(100 * 2 / 1.0)
    assert read("lm_step_ms") is None and read("lm.mfu") is None


def test_lm_readers():
    tr = Trace(device=[("k", 0, 50)], runtime=[("cudaGraphLaunch", 0, 1)] * 8
               + [("cudaLaunchKernel", 0, 1)] * 12)
    call = {"traced": True, "steps": 2, "wall_s": 5.0}
    rec = {"kind": "lm", "trace": tr, "n_points": 100, "layers": [2, 8, 8, 1],
           "n_boundary": 4, "setup_s": 2.0,
           "calls": [call, {**call, "traced": False, "wall_s": 0.5}]}
    read = lambda m: harness.read_metric(m, rec)
    assert read("lm.cg_iters_per_step") == 4
    assert read("lm.launch_calls_per_step") == 6
    assert read("lm_step_ms") == pytest.approx(250.0)
    from port_bench.counts import lm_step_flops
    assert read("lm.mfu") == pytest.approx(
        100 * lm_step_flops([2, 8, 8, 1], 100, 4, 4) / 0.25 / (495e12 / 3))
    assert read("setup_s") == 2.0
    assert read("fit_pts_per_s") is None and read("k2.roofline") is None


def test_readers_without_a_trace_read_nothing():
    rec = _fit_record()
    rec["trace"] = None
    for m in ("fit.launch_calls_per_step", "k2.roofline", "fit.torch_ops_device_ms",
              "device_idle.fit"):
        assert harness.read_metric(m, rec) is None
