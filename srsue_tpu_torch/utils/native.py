"""ctypes bindings of the native C++ host library (``native/*.cc``):
counterpart of ``srsue_tpu/utils/native.py``.

The reference runs ``make -C native`` into the tracked
``native/libsrsue_native.so``, which was built with ``-march=native`` on
another machine. The port never loads that file and never writes under
``native/``: at first use it compiles the three sources with the system
``g++`` and the Makefile's flags into ``build/native/`` at the root of the
checkout (git-ignored), and loads that. The bindings are the reference's,
symbol for symbol. As there, every function returns None when the library
cannot be built (no compiler), and ``available()`` says whether it can.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from pathlib import Path

import numpy as np

_REPO = Path(__file__).resolve().parent.parent.parent
_NATIVE_DIR = _REPO / "native"
SOURCES = ("srsue_native.cc", "turbo_decode.cc", "iq_stream.cc")
CXXFLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17")  # native/Makefile's
BUILD_DIR = _REPO / "build" / "native"
_LIB_PATH = BUILD_DIR / "libsrsue_native.so"
_lib = None
_tried = False
build_error: str | None = None  # why the last build failed


def _build() -> None:
    """g++ the sources into a private file of BUILD_DIR, then rename it into
    place (several processes may build at once). Skipped while the library
    is newer than every source."""
    srcs = [_NATIVE_DIR / s for s in SOURCES]
    if _LIB_PATH.exists() and all(
            _LIB_PATH.stat().st_mtime >= s.stat().st_mtime for s in srcs):
        return
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f"libsrsue_native.so.{os.getpid()}.tmp"
    try:
        subprocess.run(["g++", *CXXFLAGS, "-shared", "-o", str(tmp), *map(str, srcs),
                        "-lpthread"], check=True, capture_output=True, text=True,
                       timeout=300)
        os.replace(tmp, _LIB_PATH)
    finally:
        tmp.unlink(missing_ok=True)


def _load():
    global _lib, _tried, build_error
    if _tried:
        return _lib
    _tried = True
    try:
        _build()
        lib = ctypes.CDLL(str(_LIB_PATH))
    except subprocess.CalledProcessError as e:
        build_error = f"g++ failed ({e.returncode}): {e.stderr}"
        return None
    except (OSError, subprocess.TimeoutExpired) as e:
        build_error = f"native build unavailable: {e}"
        return None
    lib.gold_sequence.argtypes = [
        ctypes.c_uint32, ctypes.c_int32,
        np.ctypeslib.ndpointer(np.uint8, flags="C"),
    ]
    lib.turbo_encode.argtypes = [
        np.ctypeslib.ndpointer(np.uint8, flags="C"),
        np.ctypeslib.ndpointer(np.int32, flags="C"),
        ctypes.c_int32,
        np.ctypeslib.ndpointer(np.uint8, flags="C"),
    ]
    lib.conv_encode.argtypes = [
        np.ctypeslib.ndpointer(np.uint8, flags="C"),
        ctypes.c_int32,
        np.ctypeslib.ndpointer(np.uint8, flags="C"),
    ]
    lib.crc_bits.argtypes = [
        np.ctypeslib.ndpointer(np.uint8, flags="C"),
        ctypes.c_int32, ctypes.c_uint32, ctypes.c_int32,
    ]
    lib.crc_bits.restype = ctypes.c_uint32
    lib.turbo_decode_maxlog_batch.argtypes = [
        np.ctypeslib.ndpointer(np.float32, flags="C"),
        np.ctypeslib.ndpointer(np.int32, flags="C"),
        np.ctypeslib.ndpointer(np.int32, flags="C"),
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_uint32, ctypes.c_int32,
        np.ctypeslib.ndpointer(np.uint8, flags="C"),
        np.ctypeslib.ndpointer(np.int32, flags="C"),
    ]
    # IQ stream / timed-TX runtime (native/iq_stream.cc)
    lib.iqstream_open.argtypes = [ctypes.c_char_p, ctypes.c_uint64,
                                  ctypes.c_uint32]
    lib.iqstream_open.restype = ctypes.c_void_p
    lib.iqstream_read.argtypes = [
        ctypes.c_void_p, np.ctypeslib.ndpointer(np.float32, flags="C"),
        ctypes.c_int64, ctypes.POINTER(ctypes.c_int64),
    ]
    lib.iqstream_read.restype = ctypes.c_int64
    lib.iqstream_seek.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    lib.iqstream_seek.restype = ctypes.c_int
    lib.iqstream_underflows.argtypes = [ctypes.c_void_p]
    lib.iqstream_underflows.restype = ctypes.c_uint64
    lib.iqstream_close.argtypes = [ctypes.c_void_p]
    lib.txq_create.restype = ctypes.c_void_p
    lib.txq_submit.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
        np.ctypeslib.ndpointer(np.float32, flags="C"), ctypes.c_int64,
    ]
    lib.txq_submit.restype = ctypes.c_int64
    for name in ("txq_late", "txq_committed"):
        getattr(lib, name).argtypes = [ctypes.c_void_p]
        getattr(lib, name).restype = ctypes.c_uint64
    for name in ("txq_stream_len", "txq_stream_t0"):
        getattr(lib, name).argtypes = [ctypes.c_void_p]
        getattr(lib, name).restype = ctypes.c_int64
    lib.txq_read_stream.argtypes = [
        ctypes.c_void_p, ctypes.c_int64,
        np.ctypeslib.ndpointer(np.float32, flags="C"), ctypes.c_int64,
    ]
    lib.txq_read_stream.restype = ctypes.c_int64
    lib.txq_destroy.argtypes = [ctypes.c_void_p]
    _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


def gold_sequence(c_init: int, length: int) -> np.ndarray | None:
    lib = _load()
    if lib is None:
        return None
    out = np.empty(length, np.uint8)
    lib.gold_sequence(c_init & 0x7FFFFFFF, length, out)
    return out


def turbo_encode(bits: np.ndarray, perm: np.ndarray) -> np.ndarray | None:
    lib = _load()
    if lib is None:
        return None
    k = len(bits)
    out = np.empty(3 * (k + 4), np.uint8)
    lib.turbo_encode(
        np.ascontiguousarray(bits, np.uint8),
        np.ascontiguousarray(perm, np.int32), k, out,
    )
    return out.reshape(3, k + 4)


def conv_encode(bits: np.ndarray) -> np.ndarray | None:
    lib = _load()
    if lib is None:
        return None
    n = len(bits)
    out = np.empty(3 * n, np.uint8)
    lib.conv_encode(np.ascontiguousarray(bits, np.uint8), n, out)
    return out.reshape(3, n)


def crc_bits(bits: np.ndarray, poly: int, order: int) -> int | None:
    lib = _load()
    if lib is None:
        return None
    b = np.ascontiguousarray(bits, np.uint8)
    return int(lib.crc_bits(b, len(b), poly, order))


def turbo_decode(d_llrs: np.ndarray, perm: np.ndarray, inv: np.ndarray,
                 n_iters: int = 8, crc_poly: int = 0, crc_order: int = 0
                 ) -> tuple[np.ndarray, np.ndarray] | None:
    """Native max-log-MAP decode of [n, 3, k+4] LLR blocks -> (hard
    [n, k] uint8, iters [n] int32). None if native code unavailable."""
    lib = _load()
    if lib is None:
        return None
    d = np.ascontiguousarray(d_llrs, np.float32)
    if d.ndim == 2:
        d = d[None]
    n, three, kp4 = d.shape
    assert three == 3
    k = kp4 - 4
    hard = np.empty((n, k), np.uint8)
    iters = np.empty((n,), np.int32)
    lib.turbo_decode_maxlog_batch(
        d.reshape(n, -1), np.ascontiguousarray(perm, np.int32),
        np.ascontiguousarray(inv, np.int32), k, n, n_iters,
        crc_poly, crc_order, hard, iters,
    )
    return hard, iters
