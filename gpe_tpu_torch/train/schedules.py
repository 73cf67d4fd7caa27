"""Learning-rate schedules, port of `gpe_tpu/train/schedules.py`.

`cosine_warm_restarts` is torch's CosineAnnealingWarmRestarts (T₀, T_mult)
as a closed-form step → lr function on tensors, so it runs on the device
(the loss-as-step LR of the ramp optimizer evaluates it at the loss);
`cosine_annealing` is CosineAnnealingLR the same way.
"""
from __future__ import annotations

import math

import torch


def _as_f32(step) -> torch.Tensor:
    if isinstance(step, torch.Tensor):
        return step.to(torch.float32)
    return torch.tensor(float(step), dtype=torch.float32)


def cosine_warm_restarts(base_lr: float, T_0: int = 200, T_mult: int = 2,
                         eta_min: float = 1e-6):
    """CosineAnnealingWarmRestarts in closed form: with T_mult > 1, cycle k
    spans T₀·T_multᵏ steps starting at T₀·(T_multᵏ − 1)/(T_mult − 1)."""
    if T_mult == 1:
        def schedule(step):
            t = torch.remainder(_as_f32(step), T_0) / T_0
            return eta_min + 0.5 * (base_lr - eta_min) * (1.0 + torch.cos(math.pi * t))
        return schedule

    log_mult = math.log(float(T_mult))

    def schedule(step):
        s = _as_f32(step)
        n = s / T_0 * (T_mult - 1) + 1.0
        k = torch.floor(torch.log(n) / log_mult)
        pk = torch.pow(torch.full_like(k, float(T_mult)), k)
        start = T_0 * (pk - 1.0) / (T_mult - 1)
        T_cur = T_0 * pk
        t = torch.clamp((s - start) / T_cur, 0.0, 1.0)
        return eta_min + 0.5 * (base_lr - eta_min) * (1.0 + torch.cos(math.pi * t))

    return schedule


def cosine_annealing(base_lr: float, T_max: int, eta_min: float = 1e-5):
    """torch's CosineAnnealingLR as a step → lr function, the arithmetic of
    optax's cosine_decay_schedule(base_lr, T_max, alpha=eta_min/base_lr)
    (the reference's T_max = epochs/10, η_min = 1e−5): past T_max the lr
    stays at η_min."""
    if not T_max > 0:
        raise ValueError(f"cosine_annealing requires positive T_max, got {T_max=}")
    alpha = eta_min / base_lr

    def schedule(step):
        s = torch.clamp(_as_f32(step), max=float(T_max))
        decay = 0.5 * (1.0 + torch.cos(math.pi * s / float(T_max)))
        return base_lr * ((1.0 - alpha) * decay + alpha)

    return schedule


def scale_by_loss_as_step(schedule):
    """The reference's `scheduler.step(total_loss)` behaviour: the step is
    −schedule(loss)·update, the warm-restart schedule evaluated at the
    current LOSS value (≈ base LR once the loss is below ~1). Returns
    apply(updates, value) for a list of update tensors and the loss."""
    def apply(updates, value):
        return torch._foreach_mul(updates, -schedule(value.detach()))
    return apply
