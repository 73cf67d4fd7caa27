"""Lane packing of narrow-MLP ensembles, port of `gpe_tpu/pallas/packing.py`.

The JAX package packs M = 128 // w width-w runs block-diagonally into one
128-lane net so that one TPU kernel advances M runs at the cost of one:

    layer 0:  W_packed = [W⁽⁰⁾ | W⁽¹⁾ | …]              (d, M·w)   — shared x
    hidden:   W_packed = blockdiag(W⁽⁰⁾, …, W⁽ᴹ⁻¹⁾)     (M·w, M·w)
    output:   W_packed[m·w:(m+1)·w, m] = W⁽ᵐ⁾           (M·w, M)
    biases:   concatenated                               (M·w,) / (M,)

Gradients of the off-diagonal blocks are masked (`block_masks`) so packed
training is exactly M independent runs.

The port does not pack: its kernels take a run axis (csrc/common.cuh), and
its ensemble state is run-stacked (a leading run axis R on every leaf), the
layout `pack_params` takes and `unpack_params` returns. This module is the
contract between the two layouts: `LANES` and `packable_runs` decide M, and
with it which ensembles take the packed path, exactly as in JAX, and the
tests hold the port's run-stacked results against JAX's packed ones through
`pack_params` / `unpack_params`. Host code on tensors.
"""
from __future__ import annotations

from typing import Sequence

import torch

from gpe_tpu_torch.device import resolve_device

LANES = 128


def packable_runs(layers: Sequence[int], lanes: int = LANES) -> int:
    """How many runs of this per-run architecture fit in the lane budget.

    Requires uniform hidden width and scalar output; returns 1 (no packing)
    otherwise."""
    hidden = tuple(layers[1:-1])
    if not hidden or layers[-1] != 1:
        return 1
    w = hidden[0]
    if any(h != w for h in hidden):
        return 1
    return max(1, lanes // w)


def packed_layers(layers: Sequence[int], n_runs: int) -> tuple:
    """Per-run architecture → packed architecture."""
    return (layers[0],) + tuple(n_runs * h for h in layers[1:-1]) + (n_runs,)


def pack_params(params_batch, n_runs: int):
    """Run-stacked params (leading axis R on every leaf, R % n_runs == 0)
    → packed params with leading axis U = R // n_runs (the packed units).

    Layout per layer (w = per-run hidden width, M = n_runs):
      first:  (d, M·w)  column blocks
      hidden: (M·w, M·w) block diagonal
      last:   (M·w, M)  run m in column m, rows m·w:(m+1)·w
    """
    R = params_batch[0][0].shape[0]
    if R % n_runs:
        raise ValueError(f"R={R} not divisible by n_runs={n_runs}")
    U = R // n_runs
    out = []
    for li, (W, b) in enumerate(params_batch):
        fi, fo = W.shape[1], W.shape[2]
        Wm = W.reshape(U, n_runs, fi, fo)
        bm = b.reshape(U, n_runs, fo)
        if li == 0:                       # shared input: run blocks side by side
            Wp = torch.cat([Wm[:, m] for m in range(n_runs)], dim=-1)
        else:                             # block diagonal (last layer: (M·w, M))
            Wp = W.new_zeros((U, n_runs * fi, n_runs * fo))
            for m in range(n_runs):
                Wp[:, m * fi:(m + 1) * fi, m * fo:(m + 1) * fo] = Wm[:, m]
        bp = torch.cat([bm[:, m] for m in range(n_runs)], dim=-1)
        out.append((Wp, bp))
    return tuple(out)


def unpack_params(packed, layers: Sequence[int], n_runs: int):
    """Inverse of pack_params: packed (leading axis U) → run-stacked
    (leading axis R = U·n_runs, run-major within each unit)."""
    out = []
    for li, (Wp, bp) in enumerate(packed):
        fi, fo = layers[li], layers[li + 1]
        Ws, bs = [], []
        for m in range(n_runs):
            if li == 0:
                Ws.append(Wp[:, :, m * fo:(m + 1) * fo])
            else:
                Ws.append(Wp[:, m * fi:(m + 1) * fi, m * fo:(m + 1) * fo])
            bs.append(bp[:, m * fo:(m + 1) * fo])
        W = torch.stack(Ws, dim=1).reshape(-1, *Ws[0].shape[1:])
        b = torch.stack(bs, dim=1).reshape(-1, *bs[0].shape[1:])
        out.append((W, b))
    return tuple(out)


def block_masks(layers: Sequence[int], n_runs: int, dtype=torch.float32,
                device=None):
    """Per-layer {0,1} weight masks keeping only the per-run blocks (the
    first layer needs none — every column is a legitimate per-run weight),
    shaped like one packed unit's (weights, biases), on `device` (None →
    the CUDA card)."""
    dev = resolve_device(device)
    masks = []
    for li in range(len(layers) - 1):
        fi, fo = layers[li], layers[li + 1]
        if li == 0:
            Wm = torch.ones((fi, n_runs * fo), dtype=dtype, device=dev)
        else:
            r = torch.arange(n_runs * fi, device=dev)[:, None] // fi
            c = torch.arange(n_runs * fo, device=dev)[None, :] // fo
            Wm = (r == c).to(dtype)
        masks.append((Wm, torch.ones((n_runs * fo,), dtype=dtype, device=dev)))
    return tuple(masks)


def mask_grads(grads, masks):
    """Zero the off-diagonal (cross-run) blocks of packed gradients. Works
    with or without a leading unit axis (masks broadcast from the right)."""
    return tuple((gw * mw, gb * mb) for (gw, gb), (mw, mb) in zip(grads, masks))


def run_where(masks, cond_vec, new, old):
    """Per-run select on a packed pytree: for each run m, take `new`'s block
    where cond_vec[m] else `old`'s. cond_vec: (M,) bool (or (U, M) with a
    leading unit axis matching the leaves).

    Selection derives from the column block layout (run m owns column block
    m); the rows a column select drags along agree between `new` and `old`
    because both keep the off-diagonal blocks at zero. `masks` is accepted
    for signature symmetry with the other packed helpers and not consulted."""
    del masks
    n_runs = cond_vec.shape[-1]

    def sel(n, o, is_bias):
        cols = n.shape[-1]
        runs = torch.arange(cols, device=cond_vec.device) // (cols // n_runs)
        c = cond_vec[..., runs]
        if not is_bias:
            c = c[..., None, :]
        return torch.where(c, n, o)

    return tuple((sel(Wn, Wo, False), sel(bn, bo, True))
                 for (Wn, bn), (Wo, bo) in zip(new, old))
