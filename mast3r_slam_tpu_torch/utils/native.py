"""The port's host library: frame resize, undistortion remap and PNG row
filters in C++ (port of ``mast3r_slam_tpu/utils/native.py``).

``csrc/host/preprocess.cpp`` is compiled with the host C++ compiler
(``$CXX``, else ``g++``) at first use, into ``build/host/`` at the
repository root, named by a hash of the source, the flags and the host
(``-march=native`` code runs only on the CPU it was built for), and loaded
with ``ctypes``.  The source compiles with the JAX package's
``native/Makefile`` flags, so that the two libraries resize the same frames
to the same pixels where they are built alike, and links in a second step
without ``-ffast-math``: linked with it, the library would switch the whole
process's floating point to flush denormals to zero when it loads.
Nothing here runs at import; a failed build raises: no caller falls back
to another resizer.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

from .image import resize_geometry

_PKG_DIR = Path(__file__).resolve().parents[1]
SOURCE = _PKG_DIR / "csrc" / "host" / "preprocess.cpp"
BUILD_DIR = _PKG_DIR.parent / "build" / "host"
CXX_FLAGS = ["-O3", "-march=native", "-ffast-math", "-funroll-loops", "-std=c++17",
             "-fPIC", "-Wall"]
LINK_FLAGS = ["-shared", "-lpthread"]

_U8P = ctypes.POINTER(ctypes.c_uint8)
_F32P = ctypes.POINTER(ctypes.c_float)
_I = ctypes.c_int
_ARGTYPES = {
    "preprocess_frame": [_U8P, _I, _I, _I, _I, _I, _I, _F32P, _U8P],
    "remap_bilinear": [_U8P, _I, _I, _F32P, _F32P, _U8P],
    "png_unfilter": [_U8P, _I, _I, _I, _U8P],
}

_lib = None
_lock = threading.Lock()


def compiler() -> str:
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if not cxx:
        raise RuntimeError("no host C++ compiler: set CXX or put g++ on PATH")
    return cxx


def library_path() -> Path:
    key = " ".join(CXX_FLAGS + LINK_FLAGS + [platform.machine(), platform.node()])
    digest = hashlib.sha1(SOURCE.read_bytes() + key.encode()).hexdigest()[:12]
    return BUILD_DIR / f"libpreprocess_{digest}.so"


def build() -> Path:
    """Compile the library unless it is built; raises on failure."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.{threading.get_ident()}.tmp")
    steps = [[compiler(), *CXX_FLAGS, "-c", "-o", f"{tmp}.o", str(SOURCE)],
             [compiler(), "-o", f"{tmp}.so", f"{tmp}.o", *LINK_FLAGS]]
    for cmd in steps:
        proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"building {SOURCE.name} failed (rc {proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{proc.stdout}")
    os.remove(f"{tmp}.o")
    os.replace(f"{tmp}.so", out)
    return out


def load() -> ctypes.CDLL:
    """The host library, built first if needed."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _ARGTYPES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctype)


def resize_img_native(img01: np.ndarray, size: int = 512) -> dict:
    """``utils.pil_image.resize_img`` on the host library (Lanczos-3; the 512
    path).  img01: float (H, W, 3) in [0, 1]; returns the same dict."""
    if size != 512:
        raise ValueError(f"the host library resizes to 512 only, not {size}")
    if img01.ndim != 3 or img01.shape[2] != 3:
        raise ValueError(f"expected an (H, W, 3) image, got {img01.shape}")
    lib = load()
    H, W = img01.shape[:2]
    rgb = np.ascontiguousarray(np.clip(img01 * 255.0, 0, 255).astype(np.uint8))
    (outW, outH), (x0, y0, x1, y1) = resize_geometry(W, H, size)
    cropW, cropH = x1 - x0, y1 - y0
    out_chw = np.empty((3, cropH, cropW), dtype=np.float32)
    out_rgb = np.empty((cropH, cropW, 3), dtype=np.uint8)
    rc = lib.preprocess_frame(_ptr(rgb, _U8P), H, W, outH, outW, cropH, cropW,
                              _ptr(out_chw, _F32P), _ptr(out_rgb, _U8P))
    if rc != 0:
        raise RuntimeError(f"preprocess_frame failed: {rc}")
    return dict(img=out_chw, true_shape=np.int32([[cropH, cropW]]),
                unnormalized_img=out_rgb)


def remap_native(rgb_u8: np.ndarray, mapx: np.ndarray, mapy: np.ndarray) -> np.ndarray:
    """Bilinear remap of an (H, W, 3) uint8 image by per-pixel source
    coordinates (H, W) (``cv2.remap(..., INTER_LINEAR)``; pixels whose
    source falls outside the image are 0)."""
    if rgb_u8.dtype != np.uint8 or rgb_u8.ndim != 3 or rgb_u8.shape[2] != 3:
        raise ValueError(f"expected an (H, W, 3) uint8 image, got {rgb_u8.dtype} "
                         f"{rgb_u8.shape}")
    H, W = rgb_u8.shape[:2]
    if mapx.shape != (H, W) or mapy.shape != (H, W):
        raise ValueError(f"maps {mapx.shape}, {mapy.shape} for a {H}x{W} image")
    lib = load()
    rgb = np.ascontiguousarray(rgb_u8)
    mx = np.ascontiguousarray(mapx, dtype=np.float32)
    my = np.ascontiguousarray(mapy, dtype=np.float32)
    out = np.empty_like(rgb)
    rc = lib.remap_bilinear(_ptr(rgb, _U8P), H, W, _ptr(mx, _F32P), _ptr(my, _F32P),
                            _ptr(out, _U8P))
    if rc != 0:
        raise RuntimeError(f"remap_bilinear failed: {rc}")
    return out


def png_unfilter(raw: bytes, height: int, row_bytes: int, bpp: int) -> np.ndarray:
    """Undo the PNG row filters of inflated image data: ``height`` rows of a
    filter byte and ``row_bytes`` filtered bytes -> (height, row_bytes) uint8."""
    if len(raw) != height * (row_bytes + 1):
        raise ValueError(f"PNG image data holds {len(raw)} bytes, expected "
                         f"{height * (row_bytes + 1)} ({height} rows of 1 + {row_bytes})")
    lib = load()
    src = np.frombuffer(raw, dtype=np.uint8)
    out = np.empty((height, row_bytes), dtype=np.uint8)
    rc = lib.png_unfilter(_ptr(src, _U8P), height, row_bytes, bpp, _ptr(out, _U8P))
    if rc >= 10:
        raise ValueError(f"PNG row {rc - 10}: unknown filter type "
                         f"{src[(rc - 10) * (row_bytes + 1)]}")
    if rc != 0:
        raise RuntimeError(f"png_unfilter failed: {rc}")
    return out
