"""Bundles, parameter files and mid-sweep checkpoints, port of `gpe_tpu/io/`."""
from gpe_tpu_torch.io.checkpoint import (  # noqa: F401
    SweepCheckpointer, load_bundle, load_params, save_bundle, save_params,
    train_or_load,
)
