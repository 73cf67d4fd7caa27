"""TDGPE propagators, port of `gpe_tpu/dynamics/`: the split-step spectral
engine on torch.fft, the GEMM engine (dense per-axis propagators), the
rotating frame's Bao–Wang ADI split step, and the split-step engine with
the grid sharded over the ranks of a process group (`sharded.py`)."""
from gpe_tpu_torch.dynamics.gemm_step import (evolve_gemm,  # noqa: F401
                                              ground_state_gemm)
from gpe_tpu_torch.dynamics.rotating_step import (evolve_rotating,  # noqa: F401
                                                  rotating_ground_state)
from gpe_tpu_torch.dynamics.sharded import evolve_sharded  # noqa: F401
from gpe_tpu_torch.dynamics.split_step import (axis_coords, evolve,  # noqa: F401
                                               ground_state)
