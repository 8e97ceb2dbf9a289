"""Build the package's host C++ helpers with g++ at first use.

The port's copy of ld_decode_tpu/utils/native_build.py, with ``-pthread``
added for the helpers that start threads.  A helper is compiled with
``-O3 -march=native``, so a binary built on another machine can SIGILL
(killing the process from inside a ctypes call) or run stale code.  Each
library therefore lands in build/ld_decode_tpu_torch/ at the repository
root (git-ignored, beside the CUDA builds of
utils/cuda_build.py), named by a hash of the source, the host's CPU and
the compiler: an edited source or a foreign binary never loads.
Concurrent builders race benignly through tmp + rename.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess

from ld_decode_tpu_torch.utils.cuda_build import BUILD_DIR, CSRC_DIR

CXX_FLAGS = ('-O3', '-march=native', '-shared', '-fPIC', '-pthread')


def _host_fingerprint() -> bytes:
    """CPU and compiler identity: -march=native binaries must not be
    shared between different machines."""
    parts = [platform.machine().encode()]
    try:
        with open('/proc/cpuinfo', 'rb') as f:
            for line in f:
                if line.startswith((b'model name', b'flags')):
                    parts.append(line.strip())
                    if len(parts) >= 3:
                        break
    except OSError:
        pass
    try:
        parts.append(subprocess.run(['g++', '--version'],
                                    capture_output=True).stdout[:200])
    except OSError:
        pass
    return b'\n'.join(parts)


def build_and_load(source: str, tag: str) -> ctypes.CDLL:
    """Compile csrc/<source> (g++ -O3 -march=native) into
    build/ld_decode_tpu_torch/<tag>_<hash>.so and load it.  Raises on any
    compile or load failure (callers catch it and take their numpy
    version)."""
    src = os.path.join(CSRC_DIR, source)
    with open(src, 'rb') as f:
        text = f.read()
    key = hashlib.sha256(text + b'\0' + ' '.join(CXX_FLAGS).encode()
                         + b'\0' + _host_fingerprint()).hexdigest()[:16]
    so = os.path.join(BUILD_DIR, f'{tag}_{key}.so')
    if not os.path.exists(so):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f'{so}.tmp.{os.getpid()}'
        subprocess.run(['g++', *CXX_FLAGS, '-o', tmp, src], check=True,
                       capture_output=True)
        os.replace(tmp, so)
    return ctypes.CDLL(so)
