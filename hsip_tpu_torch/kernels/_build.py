"""Build the CUDA kernels from ``csrc/`` with ``nvcc`` and load them.

The sources have a plain C interface (no PyTorch headers), so one ``nvcc``
call builds them in seconds into ``hsip_tpu_torch/build/``; the library is
loaded with :mod:`ctypes`. A hash of the sources and flags names the build,
so an edited source or flag rebuilds on the next first use. Nothing here
runs at import time: the CPU tests import every module on machines that
have no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

__all__ = ["NVCC_FLAGS", "build_kernels", "load_kernels", "last_build_log"]

_PKG = Path(__file__).resolve().parents[1]
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
LIB_NAME = "libhsip_tpu_torch_kernels.so"

# -fmad=false: no a*b+c contraction into FMA. The band chain's tap sums,
# the tracker's f32 velocity and the TwoSum differences must round each
# operation as the plain PyTorch versions do.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false",
    "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas=-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    # band, prior, sobel, grad, intensity, n, b, w, k, ntaps, taps, thresh, stream
    "hsip_band_profiles": [_P] * 5 + [_I] * 5 + [_P, _F, _P],
    # frame_indices, prof0, prof1, empty, has_prior, calibration,
    # frame_rate, max_disp, final, recorded, is_post, s0, s1, stop_step,
    # stop_reason, ddt_frame, clear_vc, v, m, w, edge_margin,
    # search_window, exit_margin, method, min_grad, sobel_frac, ddt_jump,
    # method_frac, stream
    "hsip_tracking_scan": [_P] * 17 + [_I] * 7 + [_F] * 4 + [_P],
}

_lock = threading.Lock()
_lib = None
_last_build_log = ""


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found (CUDA toolkit needed to build the kernels)")


def _digest() -> str:
    h = hashlib.sha256()
    for path in sorted(SRC_DIR.glob("*.cu")) + sorted(SRC_DIR.glob("*.cuh")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()


def build_kernels() -> str:
    """Compile ``csrc/*.cu`` into ``build/`` unless an up-to-date build is
    there. Returns the compiler's output ("" when nothing was built)."""
    digest = _digest()
    lib = BUILD_DIR / LIB_NAME
    stamp = BUILD_DIR / (LIB_NAME + ".sha256")
    if lib.exists() and stamp.exists() \
            and stamp.read_text().strip() == digest:
        return ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f"{LIB_NAME}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sorted(SRC_DIR.glob("*.cu")))]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n"
            f"{proc.stdout}\n{proc.stderr}"
        )
    os.replace(tmp, lib)  # atomic: another process never loads half a file
    stamp.write_text(digest + "\n")
    return proc.stdout + proc.stderr


def load_kernels() -> ctypes.CDLL:
    """The kernel library, built on first use; one load per process."""
    global _lib, _last_build_log
    with _lock:
        if _lib is None:
            _last_build_log = build_kernels()
            lib = ctypes.CDLL(str(BUILD_DIR / LIB_NAME))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def last_build_log() -> str:
    """Compiler output of this process's build ("" if it found one ready)."""
    return _last_build_log
