"""ctypes bindings for the native host runtime (``native/kinrt.cpp``): the
C++ framelog (compressed RGB-D record and replay), the lock-free SPSC frame
ring and the binary PLY writers. The counterpart of the JAX package's
``io/native.py`` with its own build.

The library is compiled on first use with ``g++`` and ``native/Makefile``'s
flags into ``build/native/libkinrt_<hash>.so`` at the repository root, the
hash over the source bytes and the flags, so an edit rebuilds and an
unchanged tree reuses it. Concurrent loaders take an ``fcntl.flock`` on
``build/native/lock`` while building, and the compiler writes a temporary
file in that directory that is renamed into place, so a process never loads
half a library and one compile serves them all. ``native/libkinrt.so``,
which the JAX package builds in place, is never written or loaded here.

:func:`load` raises with the compiler's output when the build fails;
:func:`is_available` says whether the library loads (trying once per
process) and logs why not. Every consumer has a pure-Python fallback
(``viz.savers``), so the port never requires the library.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, Iterator, Optional, Tuple

import numpy as np

from azurekinect3dreconstruction_tpu_torch.utils.telemetry import log_info, log_warning

_REPO = Path(__file__).resolve().parents[2]
SOURCE = _REPO / "native" / "kinrt.cpp"
BUILD_DIR = _REPO / "build" / "native"
CXX_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-Wall"]  # native/Makefile's CXXFLAGS
LD_FLAGS = ["-shared", "-lz"]  # and its LDFLAGS

_P, _U32, _U64 = ctypes.c_void_p, ctypes.c_uint32, ctypes.c_uint64
# C entry points: name -> (restype, argtypes)
_SIGNATURES = {
    "framelog_open_write": (_P, [ctypes.c_char_p]),
    "framelog_write": (ctypes.c_int, [_P, _P, _U32, _U32, _P, _U32, _U32, _U32]),
    "framelog_close_write": (ctypes.c_int, [_P]),
    "framelog_open_read": (_P, [ctypes.c_char_p]),
    "framelog_next_header": (ctypes.c_int, [_P, _P]),
    "framelog_read": (ctypes.c_int, [_P, _P, _P]),
    "framelog_close_read": (ctypes.c_int, [_P]),
    "ring_create": (_P, [_U32, _U64]),
    "ring_push": (ctypes.c_int, [_P, _P]),
    "ring_pop_latest": (ctypes.c_int, [_P, _P]),
    "ring_dropped": (_U64, [_P]),
    "ring_destroy": (None, [_P]),
    "ply_write_points": (ctypes.c_int, [ctypes.c_char_p, _P, _P, _P, _U64]),
    "ply_write_mesh": (ctypes.c_int, [ctypes.c_char_p, _P, _P, _U64, _P, _U64]),
}

_libs: Dict[Path, ctypes.CDLL] = {}
_available: Optional[bool] = None


def library_path(build_dir=None) -> Path:
    """Where the library for the current source and flags lives."""
    h = hashlib.sha256(" ".join(CXX_FLAGS + LD_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return Path(build_dir or BUILD_DIR) / f"libkinrt_{h.hexdigest()[:16]}.so"


def build(build_dir=None) -> Path:
    """Compile ``native/kinrt.cpp`` unless the hashed library exists; its
    path. Raises ``RuntimeError`` without ``g++`` or when the compiler
    fails, with its output."""
    out = library_path(build_dir)
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    with open(out.parent / "lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # released when the file closes
        if out.exists():  # built by another process while this one waited
            return out
        cxx = shutil.which("g++")
        if cxx is None:
            raise RuntimeError("g++ not found: the native runtime is built with g++")
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
        os.close(fd)
        try:
            cmd = [cxx, *CXX_FLAGS, str(SOURCE), "-o", tmp, *LD_FLAGS]
            t0 = time.perf_counter()
            proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
            if proc.returncode != 0:
                raise RuntimeError(f"g++ failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                                   f"{proc.stdout}{proc.stderr}")
            os.replace(tmp, out)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    log_info(f"native runtime built: {out} ({time.perf_counter() - t0:.1f} s)")
    return out


def load(build_dir=None) -> ctypes.CDLL:
    """The loaded library, built on first use (see :func:`build`)."""
    path = build(build_dir)
    lib = _libs.get(path)
    if lib is None:
        lib = ctypes.CDLL(str(path))
        for name, (restype, argtypes) in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.restype = restype
            fn.argtypes = argtypes
        _libs[path] = lib
    return lib


def is_available() -> bool:
    """Whether the library loads; tried once per process, and a failure is
    logged once."""
    global _available
    if _available is None:
        try:
            load()
            _available = True
        except (RuntimeError, OSError, subprocess.SubprocessError) as e:
            log_warning(f"native runtime unavailable ({e}); using pure-Python fallbacks")
            _available = False
    return _available


class NativeFrameLogWriter:
    """Compressed binary frame log (.kinlog)."""

    def __init__(self, path: str):
        self._lib = load()
        self._h = self._lib.framelog_open_write(path.encode())
        if not self._h:
            raise IOError(f"cannot open {path}")
        self.count = 0

    def write(self, depth: np.ndarray, color: np.ndarray) -> None:
        d = np.ascontiguousarray(depth, np.uint16)
        c = np.ascontiguousarray(color, np.uint8)
        cc = 1 if c.ndim == 2 else c.shape[2]
        rc = self._lib.framelog_write(self._h, d.ctypes.data, d.shape[1], d.shape[0],
                                      c.ctypes.data, c.shape[1], c.shape[0], cc)
        if rc != 0:
            raise IOError(f"framelog_write failed ({rc})")
        self.count += 1

    def close(self) -> None:
        if self._h:
            self._lib.framelog_close_write(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class NativeFrameLogReader:
    """Reads a .kinlog back as (depth u16, color u8) frames."""

    def __init__(self, path: str):
        self._lib = load()
        self._h = self._lib.framelog_open_read(path.encode())
        if not self._h:
            raise IOError(f"cannot open {path} (missing or bad magic)")

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        dims = np.zeros(5, np.uint32)
        while True:
            rc = self._lib.framelog_next_header(self._h, dims.ctypes.data)
            if rc == 1:
                return
            if rc != 0:
                raise IOError(f"framelog_next_header failed ({rc})")
            dw, dh, cw, ch, cc = (int(x) for x in dims)
            depth = np.empty((dh, dw), np.uint16)
            color = np.empty((ch, cw, cc) if cc > 1 else (ch, cw), np.uint8)
            rc = self._lib.framelog_read(self._h, depth.ctypes.data, color.ctypes.data)
            if rc == 1:
                return
            if rc != 0:
                raise IOError(f"framelog_read failed ({rc})")
            yield depth, color

    def close(self) -> None:
        if self._h:
            self._lib.framelog_close_read(self._h)
            self._h = None


class NativeFrameRing:
    """Lock-free SPSC latest-wins channel for fixed-size frame slots."""

    def __init__(self, capacity: int, slot_bytes: int):
        self._lib = load()
        self.slot_bytes = slot_bytes
        self._h = self._lib.ring_create(capacity, slot_bytes)
        if not self._h:
            raise MemoryError("ring_create failed")

    def push(self, arr: np.ndarray) -> None:
        a = np.ascontiguousarray(arr)
        if a.nbytes != self.slot_bytes:
            raise ValueError(f"a slot holds {self.slot_bytes} bytes, got {a.nbytes}")
        self._lib.ring_push(self._h, a.ctypes.data)

    def pop_latest(self, out: np.ndarray) -> bool:
        if out.nbytes != self.slot_bytes or not out.flags["C_CONTIGUOUS"]:
            raise ValueError(f"out must be a contiguous {self.slot_bytes}-byte array")
        return bool(self._lib.ring_pop_latest(self._h, out.ctypes.data))

    @property
    def dropped(self) -> int:
        return int(self._lib.ring_dropped(self._h))

    def destroy(self) -> None:
        if self._h:
            self._lib.ring_destroy(self._h)
            self._h = None


def _colors_u8(colors) -> Optional[np.ndarray]:
    if colors is None:
        return None
    return np.ascontiguousarray(np.clip(np.asarray(colors) * 255.0, 0, 255), np.uint8)


def write_ply_points_native(path: str, points: np.ndarray,
                            colors: Optional[np.ndarray] = None,
                            normals: Optional[np.ndarray] = None) -> bool:
    """Binary PLY point cloud, the bytes of ``viz.savers.write_ply_point_cloud``;
    False when the library does not load or the write fails."""
    if not is_available():
        return False
    xyz = np.ascontiguousarray(points, np.float32)
    rgb = _colors_u8(colors)
    nrm = None if normals is None else np.ascontiguousarray(normals, np.float32)
    rc = load().ply_write_points(path.encode(), xyz.ctypes.data,
                                 rgb.ctypes.data if rgb is not None else None,
                                 nrm.ctypes.data if nrm is not None else None, xyz.shape[0])
    return rc == 0


def write_ply_mesh_native(path: str, vertices: np.ndarray, triangles: np.ndarray,
                          colors: Optional[np.ndarray] = None) -> bool:
    """Binary PLY mesh, the bytes of ``viz.savers.write_ply_mesh`` for a mesh
    without normals; False when the library does not load or the write fails."""
    if not is_available():
        return False
    v = np.ascontiguousarray(vertices, np.float32)
    t = np.ascontiguousarray(triangles, np.int32)
    rgb = _colors_u8(colors)
    rc = load().ply_write_mesh(path.encode(), v.ctypes.data,
                               rgb.ctypes.data if rgb is not None else None,
                               v.shape[0], t.ctypes.data, t.shape[0])
    return rc == 0
