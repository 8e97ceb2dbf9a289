"""ctypes binding for the native bit-unpack libraries: csrc/unpack.cpp (a
copy of the JAX package's native/unpack.cpp; its pack and .r30 unpack) and
csrc/unpack_threads.cpp (the .lds unpack, split across host threads).

The port's copy of ld_decode_tpu/io/native_unpack.py, with the .lds unpack
moved to the threaded library.  Built per host into
build/ld_decode_tpu_torch/ (utils/native_build.py; no pip dependency);
io/loaders.py falls back to its vectorized numpy unpack when the toolchain
is unavailable.
"""

from __future__ import annotations

import ctypes
import functools
import os

import numpy as np

# groups of 5 bytes that each thread of a split .lds unpack gets at least:
# below twice this a read stays on one thread (the --batch 1 path's field
# windows of about 1 M samples, the tests' small blocks).  Set from the
# step from one thread to two only: on an 8-core H100 host two threads
# first beat one at 2^19 groups (chip_smoke.py phase 31).  Wider splits
# of small reads are not tuned: at 2^22 groups 8 threads took 9.6 ms
# against 4 threads' 8.5 on one such host.
MIN_GROUPS_PER_THREAD = 1 << 18

# the threads the last .lds unpack ran on
last_threads = 0

_LIB = None
_TRIED = False
_THREADS_LIB = None
_THREADS_TRIED = False


def _load():
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    try:
        from ld_decode_tpu_torch.utils.native_build import build_and_load
        lib = build_and_load('unpack.cpp', 'ldunpack')
        lib.pack_4_40.argtypes = [ctypes.c_void_p, ctypes.c_size_t,
                                  ctypes.c_void_p]
        lib.unpack_3_32.argtypes = [ctypes.c_void_p, ctypes.c_size_t,
                                    ctypes.c_void_p]
        _LIB = lib
    except Exception:
        _LIB = None
    return _LIB


def _load_threads():
    global _THREADS_LIB, _THREADS_TRIED
    if _THREADS_TRIED:
        return _THREADS_LIB
    _THREADS_TRIED = True
    try:
        from ld_decode_tpu_torch.utils.native_build import build_and_load
        lib = build_and_load('unpack_threads.cpp', 'ldunpack_threads')
        lib.unpack_4_40_threads.argtypes = [ctypes.c_void_p, ctypes.c_size_t,
                                            ctypes.c_void_p, ctypes.c_int]
        lib.unpack_4_40_threads.restype = None
        _THREADS_LIB = lib
    except Exception:
        _THREADS_LIB = None
    return _THREADS_LIB


def available() -> bool:
    """Both libraries built: the .lds route (unpack_threads.cpp) and the
    pack and .r30 route (unpack.cpp)."""
    return _load_threads() is not None and _load() is not None


def _read(path: str) -> str:
    with open(path) as f:
        return f.read()


@functools.lru_cache(maxsize=None)
def quota_cpus(root: str = '') -> int | None:
    """The CPUs this process's CPU quota lets it use at once, rounded up:
    the smallest over its cgroup and their ancestors (v2 `cpu.max`, v1
    `cpu.cfs_quota_us` over `cpu.cfs_period_us`), read under `root`;
    None where no quota is set or none can be read.  sched_getaffinity
    does not see a quota."""
    try:
        with open(f'{root}/proc/self/cgroup') as f:
            entries = [ln.rstrip('\n').split(':', 2) for ln in f]
    except OSError:
        return None
    cpus = None
    for entry in entries:
        if len(entry) != 3:
            continue
        _, controllers, path = entry
        if controllers == '':
            base, files = f'{root}/sys/fs/cgroup', ('cpu.max',)
        elif 'cpu' in controllers.split(','):
            base = f'{root}/sys/fs/cgroup/{controllers}'
            files = ('cpu.cfs_quota_us', 'cpu.cfs_period_us')
        else:
            continue
        parts = [p for p in path.split('/') if p]
        for k in range(len(parts) + 1):
            where = '/'.join([base] + parts[:k])
            try:
                words = ' '.join(_read(f'{where}/{name}')
                                 for name in files).split()
                quota, period = int(words[0]), int(words[1])
            except (OSError, ValueError, IndexError):
                continue                        # unset ('max', -1) or absent
            if quota > 0 and period > 0:
                n = max(1, -(-quota // period))
                cpus = n if cpus is None else min(cpus, n)
    return cpus


def threads_for(groups: int) -> int:
    """Threads for an .lds unpack of `groups` groups: the cores this
    process may use (its affinity, cut to its CPU quota), cut so that each
    thread gets MIN_GROUPS_PER_THREAD groups; 1 below twice that."""
    cores = len(os.sched_getaffinity(0))
    quota = quota_cpus()
    if quota is not None:
        cores = min(cores, quota)
    return max(1, min(cores, groups // MIN_GROUPS_PER_THREAD))


def unpack_4_40(raw: np.ndarray, readlen: int, offset: int) -> np.ndarray:
    """The samples [offset, offset + readlen) of the whole groups in
    `raw`, unpacked on threads_for's count of threads (last_threads)."""
    global last_threads
    groups = len(raw) // 5
    raw = np.ascontiguousarray(raw[:groups * 5])
    out = np.empty(groups * 4, dtype=np.uint16)
    last_threads = threads_for(groups)
    _load_threads().unpack_4_40_threads(raw.ctypes.data, groups,
                                        out.ctypes.data, last_threads)
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
