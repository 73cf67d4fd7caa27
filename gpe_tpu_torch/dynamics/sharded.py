"""The split-step propagator sharded over the ranks of a process group, port
of `gpe_tpu/dynamics/sharded.py` on `torch.distributed`.

Each rank holds a slab of the grid: rows [r·n0/P, (r+1)·n0/P) of ψ and V
(the position layout, axis 0 sharded). The transform along axis 0 is not
local, so each kinetic half-step does the distributed-FFT transpose:

    position layout   (n0/P, n1, …)   axis 0 sharded
      1. FFT/DST along axes 1..d−1, local
      2. all-to-all: axis 1 split, axis 0 gathered (ops/collectives.py)
    transposed layout (n0, n1/P, …)   axis 1 sharded
      3. FFT/DST along axis 0, local
      4. the kinetic factor exp(−i·dt·c·k²), held in the same layout
      5–7. the inverse of 3–2–1

The position-space factors, the imaginary-time renormalisation and the
observables are local, with one all-reduce a global sum (`psum`). So a
Strang step makes two all-to-alls (and an all-reduce in imaginary time),
and the loop is `split_step.evolve_core`, the single-device loop, on these
transforms: a sharded run follows the single-device trajectory to FFT
round-off. The transforms are `torch.fft` along whole axes and
`split_step._dst1_ortho` for Dirichlet.

The ranks are processes (parallel/mesh.py): each calls `evolve_sharded`
with the whole initial state and potential and keeps its own block.
"""
from __future__ import annotations

import math

import torch

from gpe_tpu_torch.dynamics.split_step import (_dst1_ortho, _full_k2, axis_coords,
                                               complex_dtype, evolve_core,
                                               kinetic_factor)
from gpe_tpu_torch.ops.collectives import all_to_all, psum


def _rows(n: int, mesh) -> slice:
    per = n // mesh.size
    return slice(mesh.rank * per, (mesh.rank + 1) * per)


def evolve_sharded(psi0, V, dx: float, dt: float, steps: int, gamma: float, mesh,
                   kinetic: float = 0.5, p: float = 3.0, bc: str = "periodic",
                   lb: float = 0.0, imaginary: bool = False, record_every: int = 1,
                   device=None):
    """`split_step.evolve` with the grid sharded over `mesh`
    (parallel/mesh.Mesh): called on every rank with the whole ψ₀ and V
    (≥ 2-D; float64 V selects complex128); axes 0 and 1 must both divide
    by the mesh size (the transpose tiles both). Runs on `device` (None:
    the mesh's device).

    Returns (ψ, obs): this rank's rows of the final ψ (the position layout,
    `gather` puts them together) and the observables, the same on every
    rank, with the conventions of `evolve` (the record_every ∤ steps final
    record, "t")."""
    V = torch.as_tensor(V)
    if V.ndim < 2:
        raise ValueError("sharded propagation needs a ≥2-D grid")
    shape, dim = tuple(V.shape), V.ndim
    if shape[0] % mesh.size or shape[1] % mesh.size:
        raise ValueError(f"grid axes 0/1 {shape[:2]} must divide mesh size "
                         f"{mesh.size} (all-to-all transpose)")
    dev = torch.device(device) if device is not None else mesh.device
    if V.dtype not in (torch.float32, torch.float64):
        V = V.float()
    cd = complex_dtype(V.dtype)
    rows, cols = _rows(shape[0], mesh), _rows(shape[1], mesh)
    psi = torch.as_tensor(psi0)[rows].to(device=dev, dtype=cd)
    V_b = V[rows].to(dev)
    xs = [torch.as_tensor(x, dtype=V.dtype, device=dev)
          for x in axis_coords(shape, dx, lb, bc)]
    xs[0] = xs[0][rows]
    k2_b = _full_k2(shape, dx, bc, V.dtype, dev)[:, cols]    # the transposed layout
    group = mesh.group
    periodic = bc == "periodic"

    def tr1(a, ax):
        return torch.fft.fft(a, dim=ax) if periodic else _dst1_ortho(a, ax)

    def itr1(a, ax):
        return torch.fft.ifft(a, dim=ax) if periodic else _dst1_ortho(a, ax)

    def to_spec(a):
        for ax in range(1, dim):
            a = tr1(a, ax)
        return tr1(all_to_all(a, 1, 0, group), 0)

    def from_spec(c):
        c = all_to_all(itr1(c, 0), 0, 1, group)
        for ax in range(1, dim):
            c = itr1(c, ax)
        return c

    def gsum(a):
        return psum(torch.sum(a), group)

    # Parseval: Σ_j|ψ_j|² = (1/N)·Σ_k|F_k|² for the FFT; the ortho DST-I keeps it
    pw = dx ** dim / math.prod(shape) if periodic else dx ** dim

    def grad_sq_int(coef):
        return gsum(k2_b * (coef.real ** 2 + coef.imag ** 2)) * pw

    return evolve_core(psi, V_b, xs, dx ** dim, dt, steps, gamma, kinetic, p,
                       imaginary, record_every, to_spec=to_spec, from_spec=from_spec,
                       kin_prop=kinetic_factor(k2_b, dt, kinetic, imaginary),
                       grad_sq_int=grad_sq_int, gsum=gsum)


def gather(psi_b: torch.Tensor, mesh) -> torch.Tensor:
    """The whole grid from each rank's rows (`evolve_sharded`'s ψ), on every
    rank, rank 0 among them: `parallel.mesh.gather_ensemble` of the row
    blocks."""
    from gpe_tpu_torch.parallel.mesh import gather_ensemble
    return gather_ensemble(psi_b, mesh)
