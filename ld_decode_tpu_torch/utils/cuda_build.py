"""Build the package's CUDA sources with nvcc at first use.

Each source under ld_decode_tpu_torch/csrc/ compiles into a shared library
with a plain C interface, loaded with ctypes.  The library lands in
build/ld_decode_tpu_torch/ at the repository root (git-ignored), named by
a hash of the source and the flags, so an edited source never loads a
stale binary; concurrent builders race benignly through tmp + rename.
A missing nvcc or a failed build raises, with nvcc's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from typing import Dict, Optional

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, 'csrc')
BUILD_DIR = os.path.join(os.path.dirname(PKG_DIR), 'build',
                         'ld_decode_tpu_torch')

NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-fmad=false', '-shared', '-Xcompiler', '-fPIC',
              '-Xptxas', '-v')


class BuildInfo:
    """What one build did: library path, seconds spent in nvcc (0 when the
    library was already built) and nvcc's register/spill report (kept
    beside the library, so a later process reads it too)."""

    def __init__(self, path: str, seconds: float, log: str):
        self.path = path
        self.seconds = seconds
        self.log = log


BUILDS: Dict[str, BuildInfo] = {}


def find_nvcc() -> str:
    for cand in (os.path.join(os.environ.get('CUDA_HOME', ''), 'bin', 'nvcc'),
                 '/usr/local/cuda/bin/nvcc', shutil.which('nvcc') or ''):
        if cand and os.path.isfile(cand) and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError('nvcc not found (set CUDA_HOME or put nvcc on PATH): '
                       'the CUDA kernels build from source at first use')


def build(source: str, name: Optional[str] = None) -> ctypes.CDLL:
    """Compile csrc/<source> (or the .cu file at an absolute path, such as
    an earlier version timed against this one) into
    build/ld_decode_tpu_torch/ and load it."""
    src = os.path.join(CSRC_DIR, source)
    with open(src, 'rb') as f:
        text = f.read()
    name = name or os.path.splitext(source)[0]
    key = hashlib.sha256(text + b'\0' + ' '.join(NVCC_FLAGS).encode()
                         ).hexdigest()[:16]
    so = os.path.join(BUILD_DIR, f'{name}_{key}.so')
    seconds, log = 0.0, ''
    if os.path.exists(so) and os.path.exists(so + '.log'):
        with open(so + '.log') as f:
            log = f.read()
    if not os.path.exists(so):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f'{so}.tmp.{os.getpid()}'
        cmd = [find_nvcc(), *NVCC_FLAGS, '-o', tmp, src]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            if os.path.exists(tmp):
                os.remove(tmp)
            raise RuntimeError(f'nvcc failed ({proc.returncode}) building '
                               f'{source}:\n{" ".join(cmd)}\n{log}')
        with open(so + '.log', 'w') as f:
            f.write(log)
        os.replace(tmp, so)
    BUILDS[name] = BuildInfo(so, seconds, log)
    return ctypes.CDLL(so)
