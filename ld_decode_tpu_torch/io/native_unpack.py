"""ctypes binding for the native bit-unpack library (csrc/unpack.cpp, a
copy of the JAX package's native/unpack.cpp).

The port's copy of ld_decode_tpu/io/native_unpack.py.  Built per host into
build/ld_decode_tpu_torch/ (utils/native_build.py; no pip dependency);
io/loaders.py falls back to its vectorized numpy unpack when the toolchain
is unavailable.
"""

from __future__ import annotations

import ctypes

import numpy as np

_LIB = None
_TRIED = False


def _load():
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    try:
        from ld_decode_tpu_torch.utils.native_build import build_and_load
        lib = build_and_load('unpack.cpp', 'ldunpack')
        lib.unpack_4_40.argtypes = [ctypes.c_void_p, ctypes.c_size_t,
                                    ctypes.c_void_p]
        lib.pack_4_40.argtypes = [ctypes.c_void_p, ctypes.c_size_t,
                                  ctypes.c_void_p]
        lib.unpack_3_32.argtypes = [ctypes.c_void_p, ctypes.c_size_t,
                                    ctypes.c_void_p]
        _LIB = lib
    except Exception:
        _LIB = None
    return _LIB


def available() -> bool:
    return _load() is not None


def unpack_4_40(raw: np.ndarray, readlen: int, offset: int) -> np.ndarray:
    lib = _load()
    groups = len(raw) // 5
    raw = np.ascontiguousarray(raw[:groups * 5])
    out = np.empty(groups * 4, dtype=np.uint16)
    lib.unpack_4_40(raw.ctypes.data, groups, out.ctypes.data)
    return out[offset:offset + readlen]


def pack_4_40(samples: np.ndarray) -> np.ndarray:
    lib = _load()
    groups = len(samples) // 4
    s = np.ascontiguousarray(samples[:groups * 4], dtype=np.uint16)
    out = np.empty(groups * 5, dtype=np.uint8)
    lib.pack_4_40(s.ctypes.data, groups, out.ctypes.data)
    return out


def unpack_3_32(words: np.ndarray, readlen: int, offset: int) -> np.ndarray:
    lib = _load()
    words = np.ascontiguousarray(words, dtype='<u4')
    out = np.empty(len(words) * 3, dtype=np.int16)
    lib.unpack_3_32(words.ctypes.data, len(words), out.ctypes.data)
    return out[offset:offset + readlen]
