"""ctypes binding for the native codec decoder (csrc/codec_decode.cpp, a
copy of the JAX package's native/codec_decode.cpp).

The port's copy of ld_decode_tpu/tbc/native_codec.py.  Built per host into
build/ld_decode_tpu_torch/ at first use (utils/native_build.py; no pip
dependency); where the toolchain is missing or the known-stream self-test
fails, `available()` is False and tbc/codec.py::decode_payload takes the
numpy decode, reporting the route it took.  The native decode is the numpy
decode's arithmetic in one pass, and returns the shipped-word count that
the consistency gate compares with the device's.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np

_LIB = None
_TRIED = False
_ENABLED = True
# the decodes of a batch run on several threads, and the first of them
# builds the library: the others wait for it rather than take numpy
_LOCK = threading.Lock()


def _selftest(lib) -> bool:
    """Decode a hand-crafted minimal stream (R=1, NB=1, k=1; row
    [1, 0 x15] -> head-row h-delta d=[1,-1,0..], zigzag z=[2,1,0..],
    2 bit planes: plane0 word=0b10, plane1 word=0b01, each padded to
    the 32-word unit) and check the exact reconstruction."""
    tab = np.array([2], np.uint16)             # nwords=2, mode=0
    dense = np.zeros(64, np.uint16)
    dense[0] = 2                               # plane 0: bit0 of z1
    dense[32] = 1                              # plane 1: bit1 of z0
    q = np.zeros(8, np.uint16)
    out = np.empty((1, 16), np.uint16)
    shipped = lib.codec_decode(tab.ctypes.data, dense.ctypes.data, 64,
                               q.ctypes.data, 8, 1, 1, 1, 0,
                               out.ctypes.data)
    want = np.zeros((1, 16), np.uint16)
    want[0, 0] = 1
    return shipped == 64 and np.array_equal(out, want)


def _load():
    with _LOCK:
        return _load_locked()


def _load_locked():
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    try:
        from ld_decode_tpu_torch.utils.native_build import build_and_load
        lib = build_and_load('codec_decode.cpp', 'ldcodec')
        lib.codec_decode.restype = ctypes.c_int64
        lib.codec_decode.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_void_p]
        lib.unpack_tab6.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                    ctypes.c_void_p]
        _LIB = lib if _selftest(lib) else None
    except Exception:
        _LIB = None
    return _LIB


def available() -> bool:
    """True where the native decode is the route codec decodes take."""
    return _ENABLED and _load() is not None


def set_native(enabled: bool):
    """enabled=False sends codec decodes to the numpy route; True gives
    the native route back where it builds."""
    global _ENABLED
    _ENABLED = bool(enabled)


def route() -> str:
    """'native' or 'numpy': the route the next codec decode takes."""
    return 'native' if available() else 'numpy'


def decode_image(tab: np.ndarray, dense: np.ndarray, qstream: np.ndarray,
                 shape, k: int, hpass: bool = False):
    """(image (R, C) u16, shipped_words); shipped_words = -1 flags short
    buffers.  tab: (R, NB) or flat 6-bit table values."""
    lib = _load()
    R, C = shape
    tab = np.ascontiguousarray(np.asarray(tab).reshape(-1), dtype=np.uint16)
    dense = np.ascontiguousarray(dense, dtype=np.uint16)
    qstream = np.ascontiguousarray(qstream, dtype=np.uint16)
    out = np.empty((R, C), np.uint16)
    shipped = lib.codec_decode(
        tab.ctypes.data, dense.ctypes.data, len(dense),
        qstream.ctypes.data, len(qstream),
        R, C // 16, k, int(hpass), out.ctypes.data)
    return out, int(shipped)


def unpack_tab(words: np.ndarray, n: int) -> np.ndarray:
    """(n,) 6-bit table values from the packed u16 wire format."""
    lib = _load()
    words = np.ascontiguousarray(words, dtype=np.uint16)
    out = np.empty(n, np.uint16)
    lib.unpack_tab6(words.ctypes.data, n, out.ctypes.data)
    return out
