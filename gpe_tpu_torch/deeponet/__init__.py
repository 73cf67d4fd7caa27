"""The physics-informed DeepONet: the operator V(·) ↦ ψ(·) of the 1D GPE
over a family of potentials (`model.py`)."""
from gpe_tpu_torch.deeponet.model import (  # noqa: F401
    DeepONetResult, DeepONetSpec, deeponet_apply, deeponet_params_from_numpy,
    deeponet_vgl, evaluate_deeponet, init_deeponet, make_deeponet_loss,
    make_potential_family_batch, train_deeponet,
)
