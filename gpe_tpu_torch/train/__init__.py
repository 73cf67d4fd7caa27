"""Training: problem assembly, the fit loops, the optimizer zoo,
pretraining, PL-PINN, LM, the continuation and excited-state trainers,
the curriculum and the hybrid Adam → L-BFGS trainer."""
from gpe_tpu_torch.train.balanced import BalancedFitResult, fit_relobralo  # noqa: F401
from gpe_tpu_torch.train.beta_sweep import BetaSweepResult, train_beta_sweep  # noqa: F401
from gpe_tpu_torch.train.curriculum import CurriculumResult, train_curriculum  # noqa: F401
from gpe_tpu_torch.train.deflation import (DeflationResult,  # noqa: F401
                                        make_deflated_loss_fn, train_deflation)
from gpe_tpu_torch.train.hybrid import HybridResult, fit_hybrid  # noqa: F401
from gpe_tpu_torch.train.loop import (EnsembleFitResult, FitResult, fit,  # noqa: F401
                                      fit_ensemble)
from gpe_tpu_torch.train.optimizers import make_optimizer  # noqa: F401
from gpe_tpu_torch.train.p_ramp import PRampResult, train_p_ramp  # noqa: F401
from gpe_tpu_torch.train.plpinn import PLPINNResult, train_plpinn  # noqa: F401
from gpe_tpu_torch.train.pretrain import pretrain_to_base  # noqa: F401
from gpe_tpu_torch.train.problem import (GPESpec, init_params,  # noqa: F401
                                         make_batch, make_loss_fn)
from gpe_tpu_torch.train.schedules import cosine_warm_restarts  # noqa: F401
from gpe_tpu_torch.train.two_stage import TwoStageResult, train_two_stage  # noqa: F401
