"""Capture-file loaders: 8/16-bit raw and the 10-bit packed formats.

Implements the loader API contract of the reference
(lddutils.py:117-129): `loader(infile, sample, readlen) -> np.ndarray | None`
(None on EOF/short read).  Formats:

  * .lds  — Domesday Duplicator 10-bit, 4 samples in 5 bytes
            (reference lddutils.py:195-229; packing per ddpack comment)
  * .r30  — 3x10-bit in uint32 (reference lddutils.py:150-173, ddpack.c)
  * .r16  — int16 LE (reference lddutils.py:146-147)
  * .raw/.u8 — uint8 cxADC (reference lddutils.py:143-144)

A C++ fast path for the .lds bit-unpack lives in csrc/unpack_threads.cpp
(ctypes, io/native_unpack.py), split across the host's cores for large
reads; these numpy versions are the reference-parity fallback, taken when
no g++ can build it.  The PyTorch port's copy of
ld_decode_tpu/io/loaders.py (the port imports nothing of the JAX package).
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from ld_decode_tpu_torch.utils.spans import span

_native = None
# .lds unpacks done by each route and the seconds they took (the
# `load.unpack` span's readings), for callers that must know which route
# ran and what it cost
unpack_calls = {'native': 0, 'numpy': 0}
unpack_seconds = {'native': 0.0, 'numpy': 0.0}
# native .lds unpacks that ran on more than one thread, and the threads
# the last of them used
unpack_threads = {'split': 0, 'threads': 0}


def _try_native():
    global _native
    if _native is None:
        try:
            from ld_decode_tpu_torch.io import native_unpack
            _native = native_unpack if native_unpack.available() else False
        except Exception:
            _native = False
    return _native


def unpack_route() -> str:
    """'native' or 'numpy': the route the next .lds unpack takes."""
    return 'native' if _try_native() else 'numpy'


def set_native(enabled: bool):
    """enabled=False makes the .lds unpack take the numpy route;
    enabled=True gives the native route back where it builds."""
    global _native
    _native = None if enabled else False


def _read(infile, start: int, nbytes: int) -> bytes:
    """The bytes [start, start + nbytes) of the file, or fewer at its end:
    the `load.read` span of every loader."""
    with span('load.read'):
        infile.seek(start)
        return infile.read(nbytes)


def load_u8(infile, sample: int, readlen: int) -> Optional[np.ndarray]:
    buf = _read(infile, sample, readlen)
    if len(buf) < readlen:
        return None
    return np.frombuffer(buf, np.uint8)


def load_s16(infile, sample: int, readlen: int) -> Optional[np.ndarray]:
    buf = _read(infile, sample * 2, readlen * 2)
    if len(buf) < readlen * 2:
        return None
    return np.frombuffer(buf, '<i2')


def unpack_data_4_40(raw: np.ndarray, readlen: int,
                     offset: int) -> np.ndarray:
    """5 bytes -> 4x 10-bit samples (bit layout per lddutils.py:178-191)."""
    nat = _try_native()
    route = 'native' if nat else 'numpy'
    with span('load.unpack') as sp:
        if nat:
            out = nat.unpack_4_40(raw, readlen, offset)
            if nat.last_threads > 1:
                unpack_threads['split'] += 1
                unpack_threads['threads'] = nat.last_threads
        else:
            groups = len(raw) // 5
            b = raw[:groups * 5].reshape(groups, 5).astype(np.uint16)
            out = np.empty((groups, 4), dtype=np.uint16)
            out[:, 0] = (b[:, 0] << 2) | (b[:, 1] >> 6)
            out[:, 1] = ((b[:, 1] & 0x3f) << 4) | (b[:, 2] >> 4)
            out[:, 2] = ((b[:, 2] & 0x0f) << 6) | (b[:, 3] >> 2)
            out[:, 3] = ((b[:, 3] & 0x03) << 8) | b[:, 4]
            out = out.reshape(-1)[offset:offset + readlen]
    unpack_calls[route] += 1
    unpack_seconds[route] += sp.seconds
    return out


def load_packed_4_40(infile, sample: int, readlen: int) -> Optional[np.ndarray]:
    start = (sample // 4) * 5
    offset = sample % 4
    needed = ((readlen + offset + 3) // 4) * 5 + 5
    buf = _read(infile, start, needed)
    raw = np.frombuffer(buf, np.uint8)
    if (len(raw) // 5) * 4 < readlen + offset:
        return None
    return unpack_data_4_40(raw, readlen, offset)


def pack_data_4_40(samples: np.ndarray) -> np.ndarray:
    """Inverse of unpack_data_4_40 (for writing .lds fixtures)."""
    n = (len(samples) // 4) * 4
    s = samples[:n].astype(np.uint16).reshape(-1, 4)
    out = np.empty((s.shape[0], 5), dtype=np.uint8)
    out[:, 0] = s[:, 0] >> 2
    out[:, 1] = ((s[:, 0] & 0x3) << 6) | (s[:, 1] >> 4)
    out[:, 2] = ((s[:, 1] & 0xf) << 4) | (s[:, 2] >> 6)
    out[:, 3] = ((s[:, 2] & 0x3f) << 2) | (s[:, 3] >> 8)
    out[:, 4] = s[:, 3] & 0xff
    return out.reshape(-1)


def load_packed_3_32(infile, sample: int, readlen: int) -> Optional[np.ndarray]:
    """3x10-bit in each LE uint32 (reference lddutils.py:150-173)."""
    start = (sample // 3) * 4
    offset = sample % 3
    needed = int(np.ceil(readlen * 3 / 4) * 4) + 8
    buf = _read(infile, start, needed)
    words = np.frombuffer(buf, '<u4')
    if len(words) * 3 < readlen + offset:
        return None
    out = np.empty((len(words), 3), dtype=np.int16)
    out[:, 0] = words & 0x3ff
    out[:, 1] = (words >> 10) & 0x3ff
    out[:, 2] = (words >> 20) & 0x3ff
    return out.reshape(-1)[offset:offset + readlen]


def pack_data_3_32(samples: np.ndarray) -> np.ndarray:
    n = (len(samples) // 3) * 3
    s = samples[:n].astype(np.uint32).reshape(-1, 3)
    words = (s[:, 0] & 0x3ff) | ((s[:, 1] & 0x3ff) << 10) \
        | ((s[:, 2] & 0x3ff) << 20)
    return words.astype('<u4')


def load_available(loader, infile, sample: int, readlen: int,
                   min_len: int) -> Optional[np.ndarray]:
    """`loader(infile, sample, n)` for the largest n <= readlen that the
    file still satisfies (loaders return None on short reads, per the
    reference contract lddutils.py:117-129).  Bisects in O(log) loader
    calls; returns None if even `min_len` samples aren't there."""
    data = loader(infile, sample, readlen)
    if data is not None:
        return data
    lo, hi = min_len, readlen          # hi known-bad, lo to test
    if loader(infile, sample, lo) is None:
        return None
    while hi - lo > max(min_len // 16, 4096):
        mid = (lo + hi) // 2
        if loader(infile, sample, mid) is None:
            hi = mid
        else:
            lo = mid
    return loader(infile, sample, lo)


def make_array_loader(arr: np.ndarray):
    """Loader over an in-memory sample array (tests, bench)."""
    def loader(_infile, sample: int, readlen: int) -> Optional[np.ndarray]:
        sample = int(sample)
        if sample < 0 or sample + readlen > len(arr):
            return None
        return arr[sample:sample + readlen]
    loader.total_samples = len(arr)
    return loader


# samples per byte for each loader, (num, den): used to compute how many
# samples a file holds without probe reads (see file_samples)
_SAMPLES_PER_BYTE = {
    load_packed_4_40: (4, 5),
    load_packed_3_32: (3, 4),
    load_s16: (1, 2),
    load_u8: (1, 1),
}


def file_samples(loader, infile) -> Optional[int]:
    """Total samples `loader` can produce from `infile`, from the file
    size alone (None for loaders without a known byte ratio)."""
    ratio = _SAMPLES_PER_BYTE.get(loader)
    if ratio is None:
        return getattr(loader, 'total_samples', None)
    pos = infile.tell()
    infile.seek(0, os.SEEK_END)
    nbytes = infile.tell()
    infile.seek(pos)
    num, den = ratio
    return nbytes * num // den


def loader_for_path(path: str):
    """Extension-based loader selection (reference lddecode.py:53-58)."""
    ext = os.path.splitext(path)[1].lower()
    return {
        '.lds': load_packed_4_40,
        '.r30': load_packed_3_32,
        '.r16': load_s16,
        '.raw': load_u8,
        '.u8': load_u8,
    }.get(ext, load_packed_4_40)


def bytes_per_sample_for_path(path: str) -> float:
    """On-disk bytes per sample for the format `loader_for_path` picks.
    (The reference hardcoded 5/4 regardless of format, lddecode.py:41-42,
    so its frame-count estimate was wrong for .r30/.r16/.raw inputs.)"""
    ext = os.path.splitext(path)[1].lower()
    return {
        '.lds': 5 / 4,
        '.r30': 4 / 3,
        '.r16': 2.0,
        '.raw': 1.0,
        '.u8': 1.0,
    }.get(ext, 5 / 4)
