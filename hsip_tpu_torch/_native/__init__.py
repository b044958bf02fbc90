"""Native (C++) MRAW codec: ctypes bindings with build-on-first-import.

The port's copy of :mod:`hsip_tpu._native`. The shared library is compiled
from ``mraw_decode.cpp`` and ``fitpack_curfit.cpp`` with g++ on first use
and cached in the package's ``build/`` directory, beside a stamp of its
sources' and command's digest: a library whose stamp does not match is
rebuilt, whatever its mtime. Callers fall back to the numpy decoder
(:mod:`hsip_tpu_torch.io.mraw`) when no toolchain is available.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

__all__ = ["native_decoder", "NativeDecoder", "build_library"]

_SRC = Path(__file__).parent / "mraw_decode.cpp"
_SRC_FITPACK = Path(__file__).parent / "fitpack_curfit.cpp"
_BUILD_DIR = Path(__file__).resolve().parents[1] / "build"


def _host_tag() -> str:
    """CPU fingerprint for the .so cache name: -march=native binaries must
    not be dlopen'd on a different microarchitecture (shared filesystems,
    baked container images) — that dies with SIGILL, not an exception."""
    import hashlib
    import platform

    flags = ""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith(("flags", "Features")):
                    flags = line
                    break
    except OSError:
        pass
    digest = hashlib.sha256(flags.encode()).hexdigest()[:8]
    return f"{platform.machine()}-{digest}"


_LIB = _BUILD_DIR / f"libmraw_decode-{_host_tag()}.so"
_BUILD_LOCK = threading.Lock()
_DECODER: Optional["NativeDecoder"] = None
_FAILED = False

# -ffp-contract=off: the curfit translation unit must match numpy float64
# semantics bit for bit — FMA contraction (gcc's default) would round
# differently and move FITPACK knot choices at ties. The second command
# drops -march=native and OpenMP (portability fallbacks).
_CXX_FLAGS = ["-O3", "-march=native", "-ffp-contract=off", "-shared",
              "-fPIC", "-fopenmp"]
_CXX_FLAGS_PORTABLE = ["-O3", "-ffp-contract=off", "-shared", "-fPIC"]


def _digest() -> str:
    """sha256 of both sources and the g++ commands: the stamp of a library
    built from exactly these."""
    h = hashlib.sha256()
    for path in (_SRC, _SRC_FITPACK):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    for flags in (_CXX_FLAGS, _CXX_FLAGS_PORTABLE):
        h.update(" ".join(["g++", *flags]).encode())
    return h.hexdigest()


def build_library(force: bool = False) -> Path:
    """Compile the shared library unless its stamp holds the digest of the
    current sources (:func:`_digest`); thread- and process-safe.

    Builds into a per-PID temp file then atomically renames, so concurrent
    processes (the multi-process runtime) never dlopen a half-written .so;
    the stamp is written after the library, the same way.
    """
    with _BUILD_LOCK:
        digest = _digest()
        stamp = _LIB.with_name(_LIB.name + ".sha256")
        if (not force and _LIB.exists() and stamp.exists()
                and stamp.read_text().strip() == digest):
            return _LIB
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = _LIB.with_suffix(f".{os.getpid()}.tmp.so")
        sources = [str(_SRC), str(_SRC_FITPACK), "-o", str(tmp)]
        try:
            subprocess.run(["g++", *_CXX_FLAGS, *sources], check=True,
                           capture_output=True, text=True)
        except (subprocess.CalledProcessError, FileNotFoundError):
            subprocess.run(["g++", *_CXX_FLAGS_PORTABLE, *sources],
                           check=True, capture_output=True, text=True)
        os.replace(tmp, _LIB)
        stamp_tmp = stamp.with_name(f"{stamp.name}.{os.getpid()}.tmp")
        stamp_tmp.write_text(digest + "\n")
        os.replace(stamp_tmp, stamp)
        return _LIB


def _band_args(packed, frame_nbytes: int, row_offsets, row_nbytes: int,
               out: Optional[np.ndarray]):
    """The flat payload, the int64 row offsets and the checked (or new)
    ``(n_frames, len(row_offsets), row_nbytes)`` output of a band gather."""
    packed = np.ascontiguousarray(packed, dtype=np.uint8).reshape(-1)
    if packed.size % frame_nbytes:
        raise ValueError("packed size must be whole frames")
    offsets = np.ascontiguousarray(row_offsets, dtype=np.int64)
    if offsets.size and (
        offsets.min() < 0 or offsets.max() + row_nbytes > frame_nbytes
    ):
        raise ValueError("row offsets out of frame bounds")
    shape = (packed.size // frame_nbytes, offsets.size, row_nbytes)
    if out is None:
        out = np.empty(shape, dtype=np.uint8)
    elif (out.shape != shape or out.dtype != np.uint8
          or not out.flags.c_contiguous):
        raise ValueError(f"out must be C-contiguous uint8 of shape {shape}")
    return packed, offsets, out


class NativeDecoder:
    """ctypes wrapper over the native codec."""

    def __init__(self, lib_path: Path):
        lib = ctypes.CDLL(str(lib_path))
        u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
        u16p = np.ctypeslib.ndpointer(np.uint16, flags="C_CONTIGUOUS")
        f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")

        lib.unpack12.argtypes = [u8p, u16p, ctypes.c_int64]
        lib.pack12.argtypes = [u16p, u8p, ctypes.c_int64]
        lib.unpack10.argtypes = [u8p, u16p, ctypes.c_int64]
        lib.pack10.argtypes = [u16p, u8p, ctypes.c_int64]
        lib.unpack12_bgsub_f32.argtypes = [u8p, f32p, ctypes.c_int64, ctypes.c_float]
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        lib.count_above12.argtypes = [
            u8p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_float, ctypes.c_float, i32p,
        ]
        lib.count_above10.argtypes = [
            u8p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_float, ctypes.c_float, i32p,
        ]
        lib.count_above16.argtypes = [
            u8p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_float, ctypes.c_float, i32p,
        ]
        lib.count_above8.argtypes = [
            u8p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_float, ctypes.c_float, i32p,
        ]
        i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
        lib.gather_rows.argtypes = [
            u8p, ctypes.c_int64, ctypes.c_int64,
            i64p, ctypes.c_int64, ctypes.c_int64, u8p,
        ]
        for name in ("gather_count8", "gather_count10",
                     "gather_count12", "gather_count16"):
            fn = getattr(lib, name)
            fn.argtypes = [
                u8p, ctypes.c_int64, ctypes.c_int64,
                i64p, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_float, ctypes.c_float, ctypes.c_int32, u8p, i32p,
            ]
            fn.restype = ctypes.c_int64
        lib.count_above_scalar.argtypes = [
            u8p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int32,
            ctypes.c_float, ctypes.c_float, i32p,
        ]
        lib.native_count_path.restype = ctypes.c_char_p
        self._count_path = lib.native_count_path().decode()
        lib.native_num_threads.restype = ctypes.c_int
        lib.native_set_num_threads.argtypes = [ctypes.c_int]
        f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
        i64sp = ctypes.POINTER(ctypes.c_int64)
        lib.curfit_univariate.argtypes = [
            f64p, f64p, f64p, ctypes.c_int64, ctypes.c_int,
            ctypes.c_double,
            f64p, f64p, i64sp, ctypes.POINTER(ctypes.c_double),
        ]
        lib.curfit_univariate.restype = ctypes.c_int
        self._lib = lib

        # The payload scans (count_above*, gather_rows) are page-fault-bound
        # on cold file caches: threads spend their time blocked in fault I/O,
        # so the useful thread count is an I/O-concurrency knob, not a core
        # count. Low-core hosts (1-core dev VMs) otherwise run them at 1
        # thread and read a 3 GB recording ~5x slower than the disk allows.
        # The floor is a library global consulted by the scan pragmas, so it
        # reaches Python thread-pool workers too (omp_set_num_threads would
        # not: the OpenMP nthreads ICV is per-thread for foreign pthreads).
        # An explicit OMP_NUM_THREADS always wins.
        if "OMP_NUM_THREADS" not in os.environ:
            current = int(lib.native_num_threads())
            if current < 16:
                lib.native_set_num_threads(16)

    @property
    def num_threads(self) -> int:
        return int(self._lib.native_num_threads())

    def unpack_12bit(self, packed: np.ndarray) -> np.ndarray:
        packed = np.ascontiguousarray(packed, dtype=np.uint8).reshape(-1)
        if packed.size % 3:
            raise ValueError("12-bit packed length must be a multiple of 3")
        n_pairs = packed.size // 3
        out = np.empty(n_pairs * 2, dtype=np.uint16)
        self._lib.unpack12(packed, out, n_pairs)
        return out

    def pack_12bit(self, pixels: np.ndarray) -> np.ndarray:
        pixels = np.ascontiguousarray(pixels, dtype=np.uint16).reshape(-1)
        if pixels.size % 2:
            raise ValueError("12-bit packing requires an even pixel count")
        if pixels.size and int(pixels.max()) > 0xFFF:
            # Same contract as the numpy twin (io.mraw.pack_12bit): the C++
            # packer would silently bleed high bits into neighboring pixels.
            raise ValueError("12-bit packing requires pixel values < 4096")
        n_pairs = pixels.size // 2
        out = np.empty(n_pairs * 3, dtype=np.uint8)
        self._lib.pack12(pixels, out, n_pairs)
        return out

    def unpack_10bit(self, packed: np.ndarray) -> np.ndarray:
        packed = np.ascontiguousarray(packed, dtype=np.uint8).reshape(-1)
        if packed.size % 5:
            raise ValueError("10-bit packed length must be a multiple of 5")
        n_quads = packed.size // 5
        out = np.empty(n_quads * 4, dtype=np.uint16)
        self._lib.unpack10(packed, out, n_quads)
        return out

    def pack_10bit(self, pixels: np.ndarray) -> np.ndarray:
        pixels = np.ascontiguousarray(pixels, dtype=np.uint16).reshape(-1)
        if pixels.size % 4:
            raise ValueError("10-bit packing requires a multiple-of-4 pixel count")
        if pixels.size and int(pixels.max()) > 0x3FF:
            raise ValueError("10-bit packing requires pixel values < 1024")
        n_quads = pixels.size // 4
        out = np.empty(n_quads * 5, dtype=np.uint8)
        self._lib.pack10(pixels, out, n_quads)
        return out

    def count_above_12bit(
        self,
        packed: np.ndarray,
        frame_nbytes: int,
        background: float,
        threshold: float,
    ) -> np.ndarray:
        """Per-frame count of pixels with clamp(p - background, 0) > threshold,
        straight from packed 12-bit bytes (no decode buffer)."""
        packed = np.ascontiguousarray(packed, dtype=np.uint8).reshape(-1)
        if frame_nbytes % 3 or packed.size % frame_nbytes:
            raise ValueError("packed size must be whole 12-bit frames")
        n_frames = packed.size // frame_nbytes
        counts = np.empty(n_frames, dtype=np.int32)
        self._lib.count_above12(
            packed, n_frames, frame_nbytes,
            float(background), float(threshold), counts,
        )
        return counts

    def count_above_10bit(
        self,
        packed: np.ndarray,
        frame_nbytes: int,
        background: float,
        threshold: float,
    ) -> np.ndarray:
        """10-bit variant of :meth:`count_above_12bit`."""
        packed = np.ascontiguousarray(packed, dtype=np.uint8).reshape(-1)
        if frame_nbytes % 5 or packed.size % frame_nbytes:
            raise ValueError("packed size must be whole 10-bit frames")
        n_frames = packed.size // frame_nbytes
        counts = np.empty(n_frames, dtype=np.int32)
        self._lib.count_above10(
            packed, n_frames, frame_nbytes,
            float(background), float(threshold), counts,
        )
        return counts

    def count_above_16bit(
        self,
        packed: np.ndarray,
        frame_nbytes: int,
        background: float,
        threshold: float,
    ) -> np.ndarray:
        """16-bit little-endian variant of :meth:`count_above_12bit`."""
        packed = np.ascontiguousarray(packed, dtype=np.uint8).reshape(-1)
        if frame_nbytes % 2 or packed.size % frame_nbytes:
            raise ValueError("packed size must be whole 16-bit frames")
        n_frames = packed.size // frame_nbytes
        counts = np.empty(n_frames, dtype=np.int32)
        self._lib.count_above16(
            packed, n_frames, frame_nbytes,
            float(background), float(threshold), counts,
        )
        return counts

    def count_above_8bit(
        self,
        packed: np.ndarray,
        frame_nbytes: int,
        background: float,
        threshold: float,
    ) -> np.ndarray:
        """8-bit variant of :meth:`count_above_12bit` (bytes are pixels)."""
        packed = np.ascontiguousarray(packed, dtype=np.uint8).reshape(-1)
        if packed.size % frame_nbytes:
            raise ValueError("packed size must be whole 8-bit frames")
        n_frames = packed.size // frame_nbytes
        counts = np.empty(n_frames, dtype=np.int32)
        self._lib.count_above8(
            packed, n_frames, frame_nbytes,
            float(background), float(threshold), counts,
        )
        return counts

    @property
    def count_path(self) -> str:
        """The path that counts 12-bit pixels in this build: ``"avx512"``,
        ``"avx2"`` or ``"scalar"``, from the instruction set the library
        was compiled for. Every other depth takes the scalar integer
        loop."""
        return self._count_path

    def vector_count(self, bit_depth: int) -> bool:
        """True when the count passes of ``bit_depth`` run a vector path."""
        return bit_depth == 12 and self.count_path != "scalar"

    def count_above_scalar(
        self,
        packed: np.ndarray,
        frame_nbytes: int,
        bit_depth: int,
        background: float,
        threshold: float,
    ) -> np.ndarray:
        """:meth:`count_above_12bit` and its 8-, 10- and 16-bit twins by
        the scalar integer loop alone: what the vector path is held
        against."""
        group = {8: 1, 10: 5, 12: 3, 16: 2}[bit_depth]
        packed = np.ascontiguousarray(packed, dtype=np.uint8).reshape(-1)
        if frame_nbytes % group or packed.size % frame_nbytes:
            raise ValueError(
                f"packed size must be whole {bit_depth}-bit frames")
        n_frames = packed.size // frame_nbytes
        counts = np.empty(n_frames, dtype=np.int32)
        self._lib.count_above_scalar(
            packed, n_frames, frame_nbytes, bit_depth,
            float(background), float(threshold), counts,
        )
        return counts

    @property
    def has_count8(self) -> bool:
        """True: the library, built from its sources, exports the 8-bit
        count pass."""
        return True

    def curfit(self, x, y, w, k: int, s: float):
        """Native FITPACK curfit (UnivariateSpline-equivalent two-stage
        fit). Returns (t, c, fp, ier); raises ValueError on invalid input
        (mirroring the Python port's FitpackError rejections)."""
        import ctypes as _ct

        x = np.ascontiguousarray(x, dtype=np.float64)
        y = np.ascontiguousarray(y, dtype=np.float64)
        w = np.ascontiguousarray(w, dtype=np.float64)
        m = x.size
        cap = m + k + 1
        t = np.zeros(cap, dtype=np.float64)
        c = np.zeros(cap, dtype=np.float64)
        n = _ct.c_int64(0)
        fp = _ct.c_double(0.0)
        ier = self._lib.curfit_univariate(
            x, y, w, m, int(k), float(s), t, c, _ct.byref(n), _ct.byref(fp)
        )
        if ier == -10:
            raise ValueError("invalid curfit input")
        nn = int(n.value)
        return t[:nn].copy(), c[:nn].copy(), float(fp.value), int(ier)

    @property
    def has_gather_count(self) -> bool:
        """True: the library, built from its sources, exports the fused
        gather+count."""
        return True

    def gather_rows_count(
        self,
        packed: np.ndarray,
        frame_nbytes: int,
        row_offsets: np.ndarray,
        row_nbytes: int,
        background: float,
        threshold: float,
        bit_depth: int,
        out: Optional[np.ndarray] = None,
    ):
        """ONE pass over the packed payload: gather the band rows AND count
        above-noise pixels per frame.

        Returns ``(band, counts)``: ``band`` byte-identical to
        :meth:`gather_rows`, ``counts`` to ``count_above_*`` — but the
        payload's DRAM traffic is paid once (the host-staging hot path is
        memory-bound; VERDICT r3 #4). Frames must be whole rows of whole
        pixel groups, each offset the start of a row.
        """
        band, counts, _stopped = self._gather_count(
            packed, frame_nbytes, row_offsets, row_nbytes, background,
            threshold, bit_depth, out, np.iinfo(np.int32).max)
        return band, counts

    def gather_rows_capped_count(
        self,
        packed: np.ndarray,
        frame_nbytes: int,
        row_offsets: np.ndarray,
        row_nbytes: int,
        background: float,
        threshold: float,
        bit_depth: int,
        cap: int,
        out: Optional[np.ndarray] = None,
    ):
        """:meth:`gather_rows_count` with each frame's count stopped once it
        reaches ``cap``: returns ``(band, counts, stopped)``, the same
        ``band``, ``counts`` at ``min(count, cap)`` and the number of
        frames whose count stopped before their last row. The band's
        distinct rows are counted first, then the frame's other rows in
        order while the count is below ``cap``, so a caller that only asks
        whether a count reaches ``cap`` (the empty-frame test) reads little
        more than the band of a lit frame.
        """
        if cap < 0:
            raise ValueError("cap must be non-negative")
        return self._gather_count(
            packed, frame_nbytes, row_offsets, row_nbytes, background,
            threshold, bit_depth, out, min(int(cap), np.iinfo(np.int32).max))

    def _gather_count(self, packed, frame_nbytes, row_offsets, row_nbytes,
                      background, threshold, bit_depth, out, cap):
        """The fused entry ``gather_count{bit_depth}`` with a count cap in
        ``[0, INT32_MAX]``: ``(band, counts, stopped)``."""
        fn = {
            8: self._lib.gather_count8,
            10: self._lib.gather_count10,
            12: self._lib.gather_count12,
            16: self._lib.gather_count16,
        }[bit_depth]
        group = {8: 1, 10: 5, 12: 3, 16: 2}[bit_depth]
        if row_nbytes <= 0 or row_nbytes % group or frame_nbytes % row_nbytes:
            raise ValueError("frames must be whole rows of whole pixel groups")
        packed, offsets, out = _band_args(packed, frame_nbytes, row_offsets,
                                          row_nbytes, out)
        if np.any(offsets % row_nbytes):
            raise ValueError("row offsets must start rows")
        n_frames = len(out)
        counts = np.empty(n_frames, dtype=np.int32)
        stopped = fn(
            packed, n_frames, frame_nbytes, offsets, offsets.size,
            row_nbytes, float(background), float(threshold), cap, out,
            counts,
        )
        return out, counts, int(stopped)

    def gather_rows(
        self,
        packed: np.ndarray,
        frame_nbytes: int,
        row_offsets: np.ndarray,
        row_nbytes: int,
        out: Optional[np.ndarray] = None,
    ) -> np.ndarray:
        """(n_frames, n_rows, row_nbytes) copy of byte-aligned rows from a
        packed payload — the parallel band-staging gather (bandwidth-bound;
        beats numpy's single-threaded gather under CPU contention).

        ``out`` (optional, C-contiguous uint8 of exactly that shape) lets a
        caller gather straight into a slice of a larger staging buffer —
        e.g. the fused library path's single batched payload — skipping
        one full-payload copy on the bandwidth-starved host.
        """
        packed, offsets, out = _band_args(packed, frame_nbytes, row_offsets,
                                          row_nbytes, out)
        n_frames = len(out)
        self._lib.gather_rows(
            packed, n_frames, frame_nbytes, offsets, offsets.size,
            row_nbytes, out,
        )
        return out


def native_decoder() -> NativeDecoder:
    """The process-wide decoder, building the library on first use.

    Raises on toolchain/build failure — callers catch and fall back to numpy.
    """
    global _DECODER, _FAILED
    if _DECODER is not None:
        return _DECODER
    if _FAILED:
        raise RuntimeError("native decoder build previously failed")
    try:
        _DECODER = NativeDecoder(build_library())
    except Exception:
        _FAILED = True
        raise
    return _DECODER
