"""Experiment persistence, port of `gpe_tpu/io/checkpoint.py`: a single
bundle file holding {params_by_mode (with spec metadata), mu_table,
training_history, constant_history, epochs_history, polished}, per-model
parameter files, the mid-sweep `SweepCheckpointer` and the train-or-load
switch.

The format is the JAX package's: a pickle of numpy leaves under the same
payload keys with `format_version: 1`, so a bundle written by either
package loads in the other. Tensors are written as `.cpu().numpy()`; the
spec's dtype as its name ("float32"), so no torch class enters the file.
Reading maps the classes a JAX-written file names from packages this
machine may lack (the spec's `jax.numpy` dtype, numpy 2's `numpy._core`)
to what it has. Only bundles this project wrote are meant to be loaded:
unpickling runs the constructors the file names.
"""
from __future__ import annotations

import importlib
import os
import pickle
from dataclasses import asdict, is_dataclass
from typing import Any

import numpy as np
import torch


def _to_numpy(tree):
    """Tensors → numpy, recursively through dicts, tuples and lists."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_to_numpy(v) for v in tree)
    return tree


def _spec_dict(spec):
    if spec is None or isinstance(spec, dict):
        return spec
    d = asdict(spec) if is_dataclass(spec) else dict(spec)
    if isinstance(d.get("dtype"), torch.dtype):
        d["dtype"] = str(d["dtype"]).removeprefix("torch.")
    return d


class ForeignClass:
    """Stand-in for a class a bundle names from a package that is not
    importable here (the JAX package writes `jax.numpy.float32` as the
    spec's dtype); `name` keeps its dotted path."""

    def __init__(self, name: str):
        self.name = name

    def __repr__(self):
        return f"ForeignClass({self.name!r})"


class _Unpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if module == "jax" or module.startswith(("jax.", "jaxlib")):
            return ForeignClass(f"{module}.{name}")
        try:
            importlib.import_module(module)
        except ModuleNotFoundError:
            if module.startswith("numpy._core"):          # numpy 2 file, numpy 1 here
                module = "numpy.core" + module[len("numpy._core"):]
            else:
                raise
        return super().find_class(module, name)


def _load(path: str):
    with open(path, "rb") as f:
        return _Unpickler(f).load()


def save_bundle(path: str, result, spec=None, extra: dict | None = None) -> str:
    """Save a PLPINNResult-like bundle (reference save_models,
    harmonic_pinn_simulation.py:901-933)."""
    payload = {
        "params_by_mode": _to_numpy(result.params_by_mode),
        "mu_table": result.mu_table,
        "training_history": _to_numpy(result.training_history),
        "constant_history": result.constant_history,
        "epochs_history": result.epochs_history,
        "polished": _to_numpy(getattr(result, "polished", None)),
        "spec": _spec_dict(spec),
        "extra": extra or {},
        "format_version": 1,
    }
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(payload, f)
    return path


def load_bundle(path: str) -> dict:
    """Load a bundle saved by either package's save_bundle (reference
    load_models, :936-960)."""
    return _load(path)


def _reject_directory(path: str):
    if path.endswith(os.sep) or os.path.splitext(path)[1] == "" or os.path.isdir(path):
        raise ValueError(
            f"{path!r} names a directory: the JAX package writes an orbax "
            "PyTree checkpoint there, a format the port does not read or "
            "write; give a file path")


def save_params(path: str, params: Any) -> str:
    """Per-model checkpoint (reference torch.save(state_dict), E2): a pickle
    of the numpy pytree at a file path."""
    _reject_directory(path)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(_to_numpy(params), f)
    return path


def load_params(path: str) -> Any:
    """The numpy pytree that save_params wrote (either package's)."""
    _reject_directory(path)
    return _load(path)


class SweepCheckpointer:
    """Periodic mid-sweep checkpoint/resume for continuation ramps.

    Keeps a {key: payload} store on disk, atomically rewritten after every
    continuation step, so `train_plpinn(..., checkpoint_path=...)` resumes
    exactly where it stopped (per-(mode, γ) best params, μ, histories,
    epochs, normalization const, the folded base).
    """

    def __init__(self, path: str):
        self.path = path
        self._store: dict = {}
        if path and os.path.exists(path):
            self._store = _load(path)

    def get(self, key: str):
        return self._store.get(key)

    def put(self, key: str, payload) -> None:
        self._store[key] = _to_numpy(payload)
        tmp = self.path + ".tmp"
        os.makedirs(os.path.dirname(os.path.abspath(self.path)), exist_ok=True)
        with open(tmp, "wb") as f:
            pickle.dump(self._store, f)
        os.replace(tmp, self.path)      # atomic on POSIX

    def keys(self):
        return sorted(self._store)


def train_or_load(path: str, train_fn, force_train: bool = False):
    """The reference's `train_new` switch (harmonic_pinn_simulation.py:997):
    load the bundle if present, otherwise run train_fn() and save it.
    train_fn returns the result, or a plain (result, spec) pair."""
    if not force_train and os.path.exists(path):
        return load_bundle(path)
    result_and_spec = train_fn()
    if isinstance(result_and_spec, tuple) and not hasattr(result_and_spec, "_fields"):
        result, spec = result_and_spec
    else:
        result, spec = result_and_spec, None
    save_bundle(path, result, spec)
    return load_bundle(path)
