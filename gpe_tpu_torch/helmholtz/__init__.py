"""The Helmholtz family: the 2D square and disk problems and the inverse
problem that learns k (`problem.py`)."""
from gpe_tpu_torch.helmholtz.problem import (  # noqa: F401
    HelmholtzResult, HelmholtzSpec, circle_exact, init_helmholtz_params,
    make_helmholtz_batch, make_helmholtz_loss, make_helmholtz_residual_fn,
    square_exact, train_helmholtz,
)
