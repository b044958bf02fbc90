"""Build the CUDA kernels from ``csrc/`` with ``nvcc`` and load them.

The sources have a plain C interface (no PyTorch headers). Each
``csrc/<name>.cu`` builds into its own ``build/lib<name>.so``, all ``nvcc``
processes started together, so the build takes as long as the slowest
source; the libraries are loaded with :mod:`ctypes`. A hash of each source,
the shared headers and the flags names its build, so an edited source or
flag rebuilds that library on the next first use. Nothing here runs at
import time: the CPU tests import every module on machines that have no
``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import types
from pathlib import Path

__all__ = ["NVCC_FLAGS", "KernelError", "build_kernels", "load_kernels",
           "last_build_log"]

_PKG = Path(__file__).resolve().parents[1]
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "build"

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
    # the same, then loaded (device u64: bytes of band tiles copied),
    # runtime_counts
    "hsip_band_profiles_probe": [_P] * 5 + [_I] * 5 + [_P, _F, _P, _P, _I],
    # n, b, w, k, ntaps, out[6] -> the launch plan (tile, stride, run, tiles,
    # runs, blocks an SM)
    "hsip_band_profiles_plan": [_I] * 5 + [_P],
    # frame_indices, prof0, prof1, empty, has_prior, calibration,
    # frame_rate, max_disp, final, recorded, is_post, s0, s1, stop_step,
    # stop_reason, ddt_frame, clear_vc, v, m, w, edge_margin,
    # search_window, exit_margin, method, min_grad, sobel_frac, ddt_jump,
    # method_frac, stream
    "hsip_tracking_scan": [_P] * 17 + [_I] * 7 + [_F] * 4 + [_P],
    # method, w -> frames in a ring group (0: too wide)
    "hsip_tracking_scan_ring_depth": [_I, _I],
}


class KernelError(RuntimeError):
    """A CUDA kernel did not build, load or launch. The batch runners warn
    about and skip a recording that fails, but never this: it is raised
    through them."""


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
    raise KernelError("nvcc not found (CUDA toolkit needed to build the kernels)")


def _sources():
    return sorted(SRC_DIR.glob("*.cu"))


def _digest(source: Path) -> str:
    h = hashlib.sha256()
    for path in [source] + sorted(SRC_DIR.glob("*.cuh")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()


def _lib_path(source: Path) -> Path:
    return BUILD_DIR / f"lib{source.stem}.so"


def build_kernels() -> str:
    """Compile each out-of-date ``csrc/*.cu`` into ``build/``, all in
    parallel. Returns the compilers' output ("" when nothing was built)."""
    jobs = []  # (source, lib, stamp, digest, tmp, cmd, process)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    for src in _sources():
        digest = _digest(src)
        lib = _lib_path(src)
        stamp = lib.with_name(lib.name + ".sha256")
        if lib.exists() and stamp.exists() and stamp.read_text().strip() == digest:
            continue
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs.append((src, lib, stamp, digest, tmp, cmd, proc))
    logs, failures = [], []
    for src, lib, stamp, digest, tmp, cmd, proc in jobs:
        out, _ = proc.communicate()
        logs.append(f"== {src.name}\n{out}")
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failures.append(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{out}")
            continue
        os.replace(tmp, lib)  # atomic: another process never loads half a file
        stamp.write_text(digest + "\n")
    if failures:
        raise KernelError("\n".join(failures))
    return "".join(logs)


def load_kernels() -> types.SimpleNamespace:
    """The kernels' C entry points, built on first use; one load per
    process. Attributes are the functions of ``_SIGNATURES``."""
    global _lib, _last_build_log
    with _lock:
        if _lib is None:
            _last_build_log = build_kernels()
            fns = {}
            for src in _sources():
                lib = ctypes.CDLL(str(_lib_path(src)))
                for name, argtypes in _SIGNATURES.items():
                    fn = getattr(lib, name, None)
                    if fn is not None:
                        fn.argtypes = argtypes
                        fn.restype = ctypes.c_int
                        fns[name] = fn
            missing = sorted(set(_SIGNATURES) - set(fns))
            if missing:
                raise KernelError(f"kernel entry points not found: {missing}")
            _lib = types.SimpleNamespace(**fns)
        return _lib


def last_build_log() -> str:
    """Compiler output of this process's build ("" if it found one ready)."""
    return _last_build_log
