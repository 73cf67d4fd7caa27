"""gpe_tpu_torch — the PyTorch/CUDA port of gpe_tpu for NVIDIA Hopper.

Mirrors the layout of `gpe_tpu/` (physics, ops, models, losses, train,
experiments) so each module has an obvious counterpart; the Pallas kernels
become hand-written CUDA kernels (`kernels/`, sources in `csrc/`).

Importing the package imports torch only: no JAX, nothing of `gpe_tpu`,
no CUDA work. Kernels are compiled with nvcc at their first launch.
"""
from gpe_tpu_torch.device import resolve_device  # noqa: F401
