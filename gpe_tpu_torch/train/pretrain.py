"""Analytic-solution pretraining, port of `gpe_tpu/train/pretrain.py`
(`pretrain_to_base`): fit the raw net output to the base eigenfunction by
Adam, then L-BFGS with a strong-Wolfe line search (torch.optim.LBFGS; it
does not follow optax's zoom line search step for step)."""
from __future__ import annotations

import torch

from gpe_tpu_torch.device import pin_full_f32
from gpe_tpu_torch.models import mlp


def pretrain_to_base(params, x, target, activation: str = "shifted_tanh",
                     epochs: int = 2000, lr: float = 1e-3,
                     lbfgs_steps: int = 50, tol: float = 1e-12):
    """Returns (params, final_mse). `lbfgs_steps` L-BFGS iterations follow
    the Adam phase unless the MSE is already ≤ tol."""
    pin_full_f32()
    leaves = [t.detach().clone().requires_grad_(True)
              for pair in params for t in pair]
    pairs = lambda: tuple((leaves[i], leaves[i + 1])
                          for i in range(0, len(leaves), 2))

    def mse():
        return torch.mean((mlp.mlp_apply(pairs(), x, activation) - target) ** 2)

    opt = torch.optim.Adam(leaves, lr=lr)
    for _ in range(epochs):
        opt.zero_grad(set_to_none=True)
        mse().backward()
        opt.step()
    with torch.no_grad():
        final = float(mse())
    if final > tol and lbfgs_steps > 0:
        lbfgs = torch.optim.LBFGS(leaves, lr=1.0, max_iter=lbfgs_steps,
                                  history_size=10,
                                  line_search_fn="strong_wolfe")

        def closure():
            lbfgs.zero_grad(set_to_none=True)
            loss = mse()
            loss.backward()
            return loss

        lbfgs.step(closure)
        with torch.no_grad():
            final = float(mse())
    out = tuple((leaves[i].detach(), leaves[i + 1].detach())
                for i in range(0, len(leaves), 2))
    return out, final
