"""The rotating-frame GPE with complex ψ (vortex states, BASELINE config
#5): `problem.py`."""
from gpe_tpu_torch.rotating.problem import (  # noqa: F401
    RotatingResult, RotatingSpec, make_rotating_batch, make_rotating_loss_fn,
    make_rotating_residual_fn, train_rotating_vortex,
)
