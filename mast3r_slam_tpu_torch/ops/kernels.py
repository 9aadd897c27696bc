"""Build and load the port's CUDA kernels.

Each source under ``csrc/`` is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, loaded with ``ctypes``.  The build
happens at first use, into ``build/kernels/`` at the repository root, named
by a hash of the source and the flags, so an edited source rebuilds; nvcc's
output (ptxas's registers and spills) is kept beside each library.
``build_all`` starts one ``nvcc`` per source at once and waits for all.
Nothing here runs at import; a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, Optional

_PKG_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = _PKG_DIR / "csrc"
BUILD_DIR = _PKG_DIR.parent / "build" / "kernels"

# one shared library per source
SOURCES = {
    "attention": "attention.cu",
    "refine_window": "refine_window.cu",
    "edge_hg_rays": "edge_hg_rays.cu",
    "gather_rows": "gather_rows.cu",
    "ivf_hamming": "ivf_hamming.cu",
    "take_along_rows": "take_along_rows.cu",
}
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# each kernel's library, C entry point and argument types; every pointer
# and the stream go as c_void_p (64 bits), every int as c_int, every
# stride as c_longlong
ENTRY_POINTS = {
    "attention": ("attention", "attention_bf16_d64",
                  [_P] * 4 + [_I] * 4 + [_L] * 9 + [ctypes.c_float, _P]),
    "refine_window": ("refine_window", "refine_window_i8", [_P] * 4 + [_I] * 7 + [_P] * 2),
    "edge_hg_rays": ("edge_hg_rays", "edge_hg_rays_f32",
                     [_P] * 6 + [_I] * 4 + [ctypes.c_float] * 3 + [_P]),
    "edge_hg_rays_slots": ("edge_hg_rays", "edge_hg_rays_slots", []),
    "gather_rows_sum": ("gather_rows", "gather_rows_sum", [_P] * 3 + [_I] * 9 + [_P]),
    "gather_rows_sum_slots": ("gather_rows", "gather_rows_sum_slots", [_I] * 3),
    "ivf_hamming": ("ivf_hamming", "ivf_hamming", [_P] * 4 + [_I] * 4 + [_P]),
    "take_along_rows": ("take_along_rows", "take_along_rows", [_P] * 3 + [_I] * 9 + [_P]),
    "take_along_rows_slots": ("take_along_rows", "take_along_rows_slots", [_I]),
}
NVCC_FLAGS = [
    "-gencode=arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-shared",
    "-Xcompiler",
    "-fPIC",
    "-Xptxas",
    "-v",
]

_libs: Dict[str, ctypes.CDLL] = {}
_fns: Dict[str, object] = {}
_lock = threading.Lock()


def source_path(name: str) -> Path:
    return CSRC_DIR / SOURCES[name]


def nvcc_path() -> str:
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found:
        cands.append(found)
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def library_path(name: str) -> Path:
    src = source_path(name).read_bytes()
    digest = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}_{digest}.so"


def build_all(names: Optional[Iterable[str]] = None) -> Dict[str, Path]:
    """Compile every named kernel library that is not built yet, one nvcc
    process per source, all started together.  Raises on any failure."""
    names = list(SOURCES if names is None else names)
    todo = {n: library_path(n) for n in names}
    procs = {}
    for name, out in todo.items():
        if out.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(source_path(name))]
        procs[name] = (
            subprocess.Popen(cmd, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True),
            tmp, out,
        )
    errors = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name} (rc {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
        out.with_suffix(".log").write_text(log)
    if errors:
        raise RuntimeError("\n".join(errors))
    return todo


def build_log(name: str) -> str:
    """The nvcc output of a built library, ptxas's report of registers,
    shared memory and spills included ("" if it is not built)."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def entry_point(name: str):
    """The C launch function of one kernel, its library built first if needed."""
    with _lock:
        fn = _fns.get(name)
        if fn is None:
            lib_name, symbol, argtypes = ENTRY_POINTS[name]
            lib = _libs.get(lib_name)
            if lib is None:
                lib = ctypes.CDLL(str(build_all([lib_name])[lib_name]))
                _libs[lib_name] = lib
            fn = getattr(lib, symbol)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            _fns[name] = fn
        return fn


def check(rc: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")


class LaunchCounter:
    """Count of one kernel's launches; a wrapper adds one per launch."""

    def __init__(self, name: str):
        self.name = name
        self.count = 0

    def reset(self) -> None:
        self.count = 0
