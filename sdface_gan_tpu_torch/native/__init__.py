"""Host-side native code of the port, loaded with ctypes: the record store,
the PNG unfilter loop, marching cubes and the mesh rasterizer.

Port of ``sdface_gan_tpu/native/__init__.py`` (``RecordWriter``,
``RecordReader``, ``marching_cubes``, ``raster_mesh``) over the port's own
copies of ``recordstore.cpp``, ``marching_cubes.cpp`` (with
``mc_tables.h``) and ``rasterizer.cpp``.  The store's on-disk format is the
JAX package's: a store written by either package is read by the other.
``png_unfilter.cpp`` holds the serial part of the port's PNG decoder
(``data/png.py``).

The sources are compiled on first use with one ``g++`` into one shared
library in ``.torch_ext_build/`` at the repository root (listed in
``.gitignore``), named after a hash of the sources and flags, as
``ops/_ext.py`` builds the CUDA kernels.  A failed build raises; nothing
falls back to Python.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

_DIR = Path(__file__).resolve().parent
_SOURCES = ("recordstore.cpp", "png_unfilter.cpp", "marching_cubes.cpp", "rasterizer.cpp")
_HEADERS = ("mc_tables.h",)
BUILD_DIR = _DIR.parents[1] / ".torch_ext_build"
# -march=native as the JAX package builds its copy: the rasterizer's
# barycentric products then contract to the same FMAs
GXX_FLAGS = ("-O3", "-march=native", "-std=c++17", "-shared", "-fPIC")

_lib: Optional[ctypes.CDLL] = None
_lib_lock = threading.Lock()


def _cpu_flags() -> bytes:
    """The host CPU's feature flags (Linux), which ``-march=native`` builds
    for: a build directory copied to another machine is then rebuilt."""
    try:
        with open("/proc/cpuinfo", "rb") as f:
            return next((ln for ln in f if ln.startswith(b"flags")), b"")
    except OSError:
        return b""


def library_path() -> Path:
    """Where the sources are built (the name carries a hash of the sources,
    the flags and the host CPU's features)."""
    digest = hashlib.sha256()
    for src in _SOURCES + _HEADERS:
        digest.update((_DIR / src).read_bytes())
    digest.update(" ".join(GXX_FLAGS).encode())
    digest.update(_cpu_flags())
    return BUILD_DIR / f"native_{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library unless it exists; a temporary file renamed into
    place keeps concurrent builds (threads or processes) from loading half
    a file."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = ["g++", *GXX_FLAGS, *(str(_DIR / s) for s in _SOURCES), "-o", tmp]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"g++ failed to build {', '.join(_SOURCES)} "
                           f"(rc {proc.returncode}):\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


def lib() -> ctypes.CDLL:
    """Build if needed, load once per process, and return the library."""
    global _lib
    with _lib_lock:
        if _lib is None:
            L = ctypes.CDLL(str(build()))
            L.rs_writer_open.restype = ctypes.c_void_p
            L.rs_writer_open.argtypes = [ctypes.c_char_p]
            L.rs_writer_put.restype = ctypes.c_int
            L.rs_writer_put.argtypes = [
                ctypes.c_void_p, ctypes.c_char_p, ctypes.c_void_p, ctypes.c_uint64]
            L.rs_writer_close.restype = ctypes.c_int
            L.rs_writer_close.argtypes = [ctypes.c_void_p]
            L.rs_reader_open.restype = ctypes.c_void_p
            L.rs_reader_open.argtypes = [ctypes.c_char_p]
            L.rs_reader_count.restype = ctypes.c_int64
            L.rs_reader_count.argtypes = [ctypes.c_void_p]
            L.rs_reader_get.restype = ctypes.c_void_p
            L.rs_reader_get.argtypes = [
                ctypes.c_void_p, ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint64)]
            L.rs_reader_key.restype = ctypes.c_char_p
            L.rs_reader_key.argtypes = [ctypes.c_void_p, ctypes.c_int64]
            L.rs_reader_close.restype = None
            L.rs_reader_close.argtypes = [ctypes.c_void_p]
            L.png_unfilter.restype = ctypes.c_int
            L.png_unfilter.argtypes = [
                ctypes.c_char_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
                ctypes.c_int64, ctypes.c_int64]
            L.mc_run.restype = ctypes.c_void_p
            L.mc_run.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                                 ctypes.c_int64, ctypes.c_float]
            L.mc_num_verts.restype = ctypes.c_int64
            L.mc_num_verts.argtypes = [ctypes.c_void_p]
            L.mc_num_faces.restype = ctypes.c_int64
            L.mc_num_faces.argtypes = [ctypes.c_void_p]
            L.mc_copy.restype = None
            L.mc_copy.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
            L.mc_free.restype = None
            L.mc_free.argtypes = [ctypes.c_void_p]
            L.raster_mesh.restype = ctypes.c_int64
            L.raster_mesh.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p,
                ctypes.c_void_p]
            _lib = L
        return _lib


class RecordWriter:
    """Append-only writer for the native record store."""

    def __init__(self, path: str):
        os.makedirs(path, exist_ok=True)
        self._h = lib().rs_writer_open(path.encode())
        if not self._h:
            raise IOError(f"cannot open record store for writing: {path}")

    def put(self, key: str, value: bytes) -> None:
        rc = lib().rs_writer_put(self._h, key.encode(), value, len(value))
        if rc != 0:
            raise IOError(f"write failed for key {key}")

    def close(self) -> None:
        if self._h:
            lib().rs_writer_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class RecordReader:
    """Zero-copy mmap reader for the native record store.

    ``close`` munmaps and frees the handle, so a close racing a ``get`` in
    another thread would be a use-after-free: a per-reader lock serializes
    handle access (the copy out of the mmap happens under it), and every
    call after ``close`` raises ``ValueError``.
    """

    def __init__(self, path: str):
        self._lock = threading.Lock()
        self._h = lib().rs_reader_open(path.encode())
        if not self._h:
            raise IOError(f"cannot open record store: {path}")

    def _handle(self):
        if not self._h:
            raise ValueError("record reader is closed")
        return self._h

    def __len__(self) -> int:
        with self._lock:
            return int(lib().rs_reader_count(self._handle()))

    def keys(self):
        for i in range(len(self)):
            with self._lock:
                key = lib().rs_reader_key(self._handle(), i)
            if key is None:
                return
            yield key.decode()

    def get(self, key: str) -> Optional[bytes]:
        n = ctypes.c_uint64()
        with self._lock:
            ptr = lib().rs_reader_get(self._handle(), key.encode(), ctypes.byref(n))
            if not ptr:
                return None
            return ctypes.string_at(ptr, n.value)

    def close(self) -> None:
        with self._lock:
            if self._h:
                lib().rs_reader_close(self._h)
                self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def png_unfilter(raw: bytes, height: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-row PNG filters of inflated image data: ``raw`` holds
    ``height`` rows of a filter-type byte and ``stride`` bytes.  Returns a
    [height, stride] uint8 array."""
    out = np.empty((height, stride), dtype=np.uint8)
    rc = lib().png_unfilter(raw, len(raw), out.ctypes.data, height, stride, bpp)
    if rc == -1:
        raise ValueError(f"PNG image data too short: {len(raw)} bytes for "
                         f"{height} rows of {stride} + 1")
    if rc != 0:
        raise ValueError(f"PNG row {rc - 1} has filter type "
                         f"{raw[(rc - 1) * (stride + 1)]}, not 0-4")
    return out


def marching_cubes(grid: np.ndarray, level: float = 0.0) -> Tuple[np.ndarray, np.ndarray]:
    """Extract the ``level`` isosurface of a [nx, ny, nz] float volume.

    Returns (verts [V, 3] float32 in voxel coordinates, faces [F, 3] int32),
    the convention of ``skimage.measure.marching_cubes`` (used by the
    reference at ``sdf_utils.py:195``): surface where the field crosses
    ``level``, vertices linearly interpolated along cell edges.  Raises
    ``ValueError`` when the volume has fewer than 2 cells along an axis.
    """
    g = np.ascontiguousarray(grid, dtype=np.float32)
    if g.ndim != 3:
        raise ValueError(f"expected 3D volume, got {g.shape}")
    h = lib().mc_run(g.ctypes.data, g.shape[0], g.shape[1], g.shape[2], float(level))
    if not h:
        raise ValueError("marching cubes failed (volume too small?)")
    try:
        nv = lib().mc_num_verts(h)
        nf = lib().mc_num_faces(h)
        verts = np.empty((nv, 3), dtype=np.float32)
        faces = np.empty((nf, 3), dtype=np.int32)
        if nv:
            lib().mc_copy(h, verts.ctypes.data, faces.ctypes.data)
        return verts, faces
    finally:
        lib().mc_free(h)


def raster_mesh(
    verts_px: np.ndarray,
    faces: np.ndarray,
    vert_attr: np.ndarray,
    h: int,
    w: int,
) -> Tuple[np.ndarray, np.ndarray]:
    """Z-buffer rasterize a mesh carrying one scalar attribute per vertex.

    verts_px: [V, 3] pre-projected (x_pix, y_pix, depth > 0); faces [F, 3];
    vert_attr [V].  Returns (attr [h, w], depth [h, w] with 1e30 = empty).
    """
    v = np.ascontiguousarray(verts_px, dtype=np.float32)
    f = np.ascontiguousarray(faces, dtype=np.int32)
    a = np.ascontiguousarray(vert_attr, dtype=np.float32)
    if v.ndim != 2 or v.shape[1] != 3 or f.ndim != 2 or f.shape[1] != 3 or a.shape != (len(v),):
        raise ValueError(f"expected verts [V, 3], faces [F, 3], attr [V]; got "
                         f"{v.shape}, {f.shape}, {a.shape}")
    attr = np.zeros((h, w), dtype=np.float32)
    depth = np.zeros((h, w), dtype=np.float32)
    lib().raster_mesh(v.ctypes.data, f.ctypes.data, a.ctypes.data, len(v), len(f), h, w,
                      attr.ctypes.data, depth.ctypes.data)
    return attr, depth
