"""Analytic-solution pretraining, port of `gpe_tpu/train/pretrain.py`
(`pretrain_to_base`): fit the raw net output to the base eigenfunction by
Adam (optax.adam's arithmetic, `optimizers.scale_by_adam`), then L-BFGS
with a strong-Wolfe line search (torch.optim.LBFGS; it does not follow
optax's zoom line search step for step). On a CUDA device the Adam steps
replay a CUDA graph of one step: the same kernels, without the host's cost
of launching each."""
from __future__ import annotations

import torch

from gpe_tpu_torch.device import pin_full_f32
from gpe_tpu_torch.models import mlp
from gpe_tpu_torch.train.optimizers import adam_init, scale_by_adam


def pretrain_to_base(params, x, target, activation: str = "shifted_tanh",
                     epochs: int = 2000, lr: float = 1e-3,
                     lbfgs_steps: int = 50, tol: float = 1e-12, apply_fn=None):
    """Returns (params, final_mse). `lbfgs_steps` L-BFGS iterations follow
    the Adam phase unless the MSE is already ≤ tol. `apply_fn(params, x,
    activation)` replaces the raw net's output: a hard-BC spec pretrains
    the complete solution, net × sine factor, to the base."""
    pin_full_f32()
    leaves = [t.detach().clone().requires_grad_(True)
              for pair in params for t in pair]
    pairs = lambda: tuple((leaves[i], leaves[i + 1])
                          for i in range(0, len(leaves), 2))

    apply = apply_fn or mlp.mlp_apply

    def mse():
        return torch.mean((apply(pairs(), x, activation) - target) ** 2)

    _adam_steps(mse, leaves, lr, epochs, graph=leaves[0].is_cuda)
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


def _adam_steps(loss, leaves, lr: float, steps: int, graph: bool) -> None:
    """`steps` Adam steps on `leaves`, in place. graph=True: two steps
    launched op by op (on a side stream, outside the capture), then a
    CUDA graph of one step replayed for the rest."""
    state = adam_init(leaves)

    def step():
        with torch.enable_grad():
            g = torch.autograd.grad(loss(), leaves)
        u, new = scale_by_adam(list(g), state)
        with torch.no_grad():
            torch._foreach_add_(leaves, torch._foreach_mul(u, -lr))
            for k in ("mu", "nu"):
                torch._foreach_copy_(state[k], new[k])
            state["count"].copy_(new["count"])

    if not graph or steps <= 2:
        for _ in range(steps):
            step()
        return
    main = torch.cuda.current_stream(leaves[0].device)
    side = torch.cuda.Stream(device=leaves[0].device)
    side.wait_stream(main)
    with torch.cuda.stream(side):
        step()
        step()
    main.wait_stream(side)
    cuda_graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(cuda_graph):
        step()
    for _ in range(steps - 2):
        cuda_graph.replay()
