"""Build the CUDA kernels from `gpe_tpu_torch/csrc/` at first use.

Each `*.cu` source becomes its own shared library with a plain C interface
(nvcc for sm_90a, loaded with ctypes). All sources are compiled together,
one nvcc process each, started at once. Outputs go to `build/gpe_tpu_torch/
<hash>/` under the repository root, keyed by a hash of every source, header
and flag, so an edited source rebuilds and an unchanged one loads at once.
ptxas's register/spill report of each build is kept beside the library.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "gpe_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_libs: dict = {}


def _nvcc() -> str:
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return found


def _sources():
    return sorted(CSRC.glob("*.cu"))


def _build_dir() -> Path:
    h = hashlib.sha256()
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_ROOT / h.hexdigest()[:16]


def build_all() -> Path:
    """Compile every source that has no library yet (in parallel) and return
    the build directory. Raises with nvcc's output if any build fails."""
    out = _build_dir()
    todo = [s for s in _sources() if not (out / f"lib{s.stem}.so").exists()]
    if not todo:
        return out
    out.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for src in todo:
        tmp = out / f"lib{src.stem}.so.tmp{os.getpid()}"
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(src)]
        procs.append((src, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    errors = []
    for src, tmp, proc in procs:
        log, _ = proc.communicate()
        (out / f"{src.stem}.ptxas.log").write_text(log)
        if proc.returncode != 0:
            errors.append(f"nvcc failed on {src.name}:\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out / f"lib{src.stem}.so")
    if errors:
        raise RuntimeError("\n".join(errors))
    return out


def library(name: str, bind) -> ctypes.CDLL:
    """The loaded library built from `csrc/<name>.cu` (built at first use);
    `bind(lib)` declares its entry points' argtypes/restype once, at load."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build_all() / f"lib{name}.so"))
            lib.gpe_error_string.restype = ctypes.c_char_p
            lib.gpe_error_string.argtypes = [ctypes.c_int]
            bind(lib)
            _libs[name] = lib
        return lib


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} "
                           f"({lib.gpe_error_string(rc).decode()})")
