"""Debug and reproducibility utilities, port of `gpe_tpu/utils/debug.py`:
global seeding and a NaN guard."""
from __future__ import annotations

import random

import numpy as np
import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode


def seed_everything(seed: int) -> torch.Generator:
    """Seed python's `random`, numpy's global generator and torch's (every
    CUDA device's too); returns a CPU `torch.Generator` seeded with `seed`
    for explicit draws (the twin of JAX's PRNGKey(seed))."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    return torch.Generator().manual_seed(seed)


class nan_guard(TorchDispatchMode):
    """A scope in which every torch op's floating output is checked: the
    first op that produces a NaN raises FloatingPointError naming it
    (autograd's backward ops included). The CUDA kernels' wrappers write
    their outputs outside torch's dispatcher and are not checked."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in pytree.tree_leaves(out):
            if (isinstance(t, torch.Tensor) and (t.is_floating_point() or t.is_complex())
                    and bool(torch.isnan(t).any())):
                raise FloatingPointError(f"NaN produced by {func}")
        return out
