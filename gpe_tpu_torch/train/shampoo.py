"""Shampoo with Adam grafting, port of `gpe_tpu/train/shampoo.py`.

Kronecker-factored statistics L += GGᵀ, R += GᵀG per matrix leaf, the
update L^(−1/4)·G·R^(−1/4) with the roots recomputed every
`precondition_frequency` steps by `torch.linalg.eigh`, rescaled to the norm
of the Adam update (grafting); other leaves take the Adam update. Then
× −lr (or −lr(count) for a schedule).
"""
from __future__ import annotations

import torch

from gpe_tpu_torch.train.optimizers import Chain, ScaleByAdam, ScaleByLearningRate


def inv_quarter_root(m: torch.Tensor, eps: float) -> torch.Tensor:
    """M^(−1/4) by the symmetric eigendecomposition of M + eps·I, the
    eigenvalues floored at eps."""
    w, v = torch.linalg.eigh(m + eps * torch.eye(m.shape[0], dtype=m.dtype,
                                                   device=m.device))
    w = torch.clamp_min(w, eps)
    return (v * torch.pow(w, -0.25)) @ v.T


class ScaleByShampoo:
    """The Shampoo direction grafted onto Adam's norm (JAX `shampoo`'s base
    transform)."""

    def __init__(self, precondition_frequency: int = 100,
                 start_preconditioning_step: int = 1, eps: float = 1e-6,
                 graft_b1: float = 0.9, graft_b2: float = 0.999):
        self.freq, self.start, self.eps = (precondition_frequency,
                                           start_preconditioning_step, eps)
        self.graft = ScaleByAdam(graft_b1, graft_b2)

    def init(self, leaves):
        def square(n, t, fill):
            return fill(n, dtype=t.dtype, device=t.device)
        mats = [t.ndim == 2 for t in leaves]
        zeros = lambda n, **kw: torch.zeros((n, n), **kw)
        return {"count": 0,
                "l_stats": [square(t.shape[0], t, zeros) if m else None
                            for t, m in zip(leaves, mats)],
                "r_stats": [square(t.shape[1], t, zeros) if m else None
                            for t, m in zip(leaves, mats)],
                "l_inv": [square(t.shape[0], t, torch.eye) if m else None
                          for t, m in zip(leaves, mats)],
                "r_inv": [square(t.shape[1], t, torch.eye) if m else None
                          for t, m in zip(leaves, mats)],
                "graft": self.graft.init(leaves)}

    def update(self, u, s, ctx):
        c = s["count"] + 1
        refresh = c >= self.start and c % self.freq == 0
        warm = c >= self.start
        l_stats, r_stats, l_inv, r_inv = [], [], [], []
        for g, ls, rs, li, ri in zip(u, s["l_stats"], s["r_stats"], s["l_inv"],
                                     s["r_inv"]):
            if g.ndim == 2:
                ls, rs = ls + g @ g.T, rs + g.T @ g
                if refresh:
                    li, ri = inv_quarter_root(ls, self.eps), inv_quarter_root(rs, self.eps)
            l_stats.append(ls)
            r_stats.append(rs)
            l_inv.append(li)
            r_inv.append(ri)
        gu, graft = self.graft.update(u, s["graft"], ctx)
        out = []
        for g, li, ri, a in zip(u, l_inv, r_inv, gu):
            if g.ndim != 2 or not warm:
                out.append(a)
                continue
            d = li @ g @ ri
            out.append(d * (torch.linalg.vector_norm(a)
                            / (torch.linalg.vector_norm(d) + 1e-16)))
        return out, {"count": c, "l_stats": l_stats, "r_stats": r_stats,
                     "l_inv": l_inv, "r_inv": r_inv, "graft": graft}


def shampoo(learning_rate=1e-3, precondition_frequency: int = 100,
            start_preconditioning_step: int = 1, eps: float = 1e-6,
            graft_b1: float = 0.9, graft_b2: float = 0.999) -> Chain:
    return Chain(ScaleByShampoo(precondition_frequency, start_preconditioning_step,
                                eps, graft_b1, graft_b2),
                 ScaleByLearningRate(learning_rate))
