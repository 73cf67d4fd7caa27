"""TDGPE propagators, port of `gpe_tpu/dynamics/`: the split-step spectral
engine on torch.fft and the GEMM engine (dense per-axis propagators).
`rotating_step.py` and `sharded.py` are not ported yet."""
from gpe_tpu_torch.dynamics.gemm_step import (evolve_gemm,  # noqa: F401
                                              ground_state_gemm)
from gpe_tpu_torch.dynamics.split_step import (axis_coords, evolve,  # noqa: F401
                                               ground_state)
