"""Build and load the hand-written CUDA kernels of ``csrc/``.

All ``csrc/*.cu`` files are compiled by ``nvcc`` for Hopper
(``sm_90a``) into one shared library with a plain C interface, loaded with
``ctypes``. The library goes to ``build/kernels/`` at the repository root on
first use, named by a hash of the sources and flags, so an edit rebuilds and
an unchanged tree reuses it. Every C entry point launches on the stream it is
given and returns ``cudaGetLastError()``; :func:`check` raises on non-zero.

Launch counts live in :data:`launches` (kernel name -> launches), bumped by
each wrapper where it launches its kernel and nowhere else.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"
NVCC_DEFAULT = "/usr/local/cuda/bin/nvcc"  # the CUDA toolkit's usual place, if not on PATH
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-lineinfo"]

_P = ctypes.c_void_p
_I = ctypes.c_int
# C entry points: name -> argtypes (every one returns the int cudaError_t)
_SIGNATURES = {
    # worklist, M, n_active, T_cw, depth, color, H, W, tsdf, weight, color_pool, R, trash,
    # params, stream
    "akr_tsdf_integrate": [_P, _I, _P, _P, _P, _P, _I, _I, _P, _P, _P, _I, _I, _P, _P],
    # R, grid (out)
    "akr_tsdf_integrate_grid": [_I, ctypes.POINTER(_I)],
    # grid (out), band (out)
    "akr_odometry_pyramid_grid": [ctypes.POINTER(_I), ctypes.POINTER(_I)],
    # planes, dims, intr, n_levels, routes, params, state, partials, grid, stream
    "akr_odometry_pyramid": [_P, _P, _P, _I, _P, _P, _P, _P, _I, _P],
}

launches: collections.Counter = collections.Counter()
_lib = None
build_seconds = 0.0  # wall time of the nvcc build in this process (0 if reused)


def _nvcc() -> str:
    path = shutil.which("nvcc") or NVCC_DEFAULT
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return path


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libakr_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile ``csrc/*.cu`` unless the hashed library already exists."""
    global build_seconds
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        tmp_out = Path(tmp) / out.name
        cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp_out),
               *map(str, sorted(CSRC.glob("*.cu")))]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp_out, out)  # atomic: a concurrent loader never sees half a file
    build_seconds = time.perf_counter() - t0
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def check(err: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError_t {err}")


def check_tensor(t, dtype, shape, device, what: str) -> None:
    """Raise ``ValueError`` unless ``t`` is a contiguous ``dtype`` tensor of
    ``shape`` on ``device`` — what a kernel's raw pointer assumes."""
    if t.device != device or t.dtype != dtype or tuple(t.shape) != tuple(shape) \
            or not t.is_contiguous():
        raise ValueError(f"{what}: expected contiguous {dtype} {tuple(shape)} on {device}, "
                         f"got {t.dtype} {tuple(t.shape)} on {t.device}"
                         f"{'' if t.is_contiguous() else ' (non-contiguous)'}")


def stream_handle(device) -> int:
    """The raw ``cudaStream_t`` of PyTorch's current stream on ``device``."""
    import torch

    return torch.cuda.current_stream(device).cuda_stream


def float_params(*values) -> ctypes.Array:
    """A host float32 array for a C entry's ``params`` pointer."""
    return (ctypes.c_float * len(values))(*values)
