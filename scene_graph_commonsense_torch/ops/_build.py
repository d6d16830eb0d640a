"""Builds and loads the port's CUDA kernels.

Each `csrc/<name>.cu` has a plain C interface and is compiled by `nvcc` for
Hopper (sm_90a) into its own shared library, loaded with ctypes.  Builds
happen at first use, never at import (the package imports where there is no
nvcc), into `scene_graph_commonsense_torch/_build/`, keyed by a hash of the
source, the shared headers (`csrc/*.cuh`) and the flags, so an edited source
is rebuilt and an unchanged one is not.  `build_all` starts one nvcc per
source at once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Dict, List

_PKG = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: Dict[str, ctypes.CDLL] = {}


def sources() -> List[str]:
    """Kernel names, one per `csrc/*.cu`."""
    return sorted(p.stem for p in SRC_DIR.glob("*.cu"))


def _nvcc() -> str:
    # PyTorch's toolkit discovery: $CUDA_HOME, $CUDA_PATH, nvcc on PATH,
    # then the toolkit's default install root
    from torch.utils.cpp_extension import CUDA_HOME
    nvcc = Path(CUDA_HOME or "") / "bin" / "nvcc"
    if not CUDA_HOME or not nvcc.exists():
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on "
                           "PATH to build the port's CUDA kernels")
    return str(nvcc)


def library_path(name: str) -> Path:
    # the headers a source may include (csrc/*.cuh) are part of its key
    src = (SRC_DIR / f"{name}.cu").read_bytes() + b"".join(
        p.read_bytes() for p in sorted(SRC_DIR.glob("*.cuh")))
    key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}_{key[:16]}.so"


def log_path(name: str) -> Path:
    return library_path(name).with_suffix(".log")


def _start(name: str):
    """Starts nvcc for one source unless its library is already built;
    returns (process, temporary output, final output) or None."""
    out = library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SRC_DIR / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, started) -> None:
    proc, tmp, out = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{log}")
    out.with_suffix(".log").write_text(log)
    os.replace(tmp, out)     # atomic: a concurrent builder sees all or none


def build_all() -> None:
    """Compiles every csrc/*.cu that is not built yet, one nvcc each, all
    started together."""
    started = {name: _start(name) for name in sources()}
    errors = []
    for name, st in started.items():
        if st is None:
            continue
        try:
            _finish(name, st)
        except RuntimeError as e:
            errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))


def check_launch(name: str, err: int) -> None:
    """Raises if a kernel's C entry point returned a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")


def need_cuda(name: str, t) -> None:
    """Raises unless tensor `t` lies on a CUDA device."""
    if t.device.type != "cuda":
        raise ValueError(f"{name} needs CUDA tensors, got {t.device}")


def route(name: str, t, kernel, plain):
    """The kernel for a CUDA tensor, the plain version for a CPU tensor, an
    error for any other device.  Never a fallback: a kernel that fails to
    build or launch raises."""
    if t.device.type == "cuda":
        return kernel
    if t.device.type == "cpu":
        return plain
    raise ValueError(f"{name} has no path for device {t.device}")


def load(name: str) -> ctypes.CDLL:
    """The ctypes handle of csrc/<name>.cu, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        started = _start(name)
        if started is not None:
            _finish(name, started)
        lib = ctypes.CDLL(str(library_path(name)))
        _loaded[name] = lib
    return lib
