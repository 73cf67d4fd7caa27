"""Ground-truth oracles (imaginary time, FDM/SCF, rotating frame), port of
`gpe_tpu/validate/`."""
from gpe_tpu_torch.validate.fdm import (  # noqa: F401
    linear_eigensolve_1d, solve_gpe_scf_1d, solve_gpe_scf_2d,
)
from gpe_tpu_torch.validate.imaginary_time import imaginary_time_gpe  # noqa: F401
