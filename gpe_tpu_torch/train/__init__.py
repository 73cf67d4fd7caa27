"""Training: problem assembly, the fit loop, pretraining, PL-PINN, LM."""
from gpe_tpu_torch.train.loop import FitResult, fit  # noqa: F401
from gpe_tpu_torch.train.plpinn import PLPINNResult, train_plpinn  # noqa: F401
from gpe_tpu_torch.train.pretrain import pretrain_to_base  # noqa: F401
from gpe_tpu_torch.train.problem import (GPESpec, init_params,  # noqa: F401
                                         make_batch, make_loss_fn)
from gpe_tpu_torch.train.schedules import cosine_warm_restarts  # noqa: F401
