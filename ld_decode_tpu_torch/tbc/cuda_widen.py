"""Capture widening: a capture's integer samples to the float32 device
capture.  The hand-written CUDA kernel, its in-place schedule, its plain
version and the count of widenings by route.

The kernel (csrc/capture_widen.cu, built with nvcc at first use by
utils/cuda_build.py and bound with ctypes) replaces no TPU kernel: the JAX
package keeps the capture as uint16 on the device and widens inside its
jitted graphs, while the port's float32 buffer, read in place by its CUDA
graphs, was filled from the host.  On the card a segment swap copies the
loader's samples as they are, 1 or 2 bytes a sample (`stage`; from the
Framer's pinned staging buffer, asynchronously), into the
top of the first 4n bytes of the float32 buffer, and the kernel widens
them in place (`widen`), in ranges launched in stream order
(`widen_schedule`): no scratch memory, so a swap allocates nothing on the
card.  A sample becomes float32(x), or
float32(x + 32768) for a signed type: the plain version's recentre
(`widen_plain`), bit for bit.

Dispatch (tbc/framer.py::to_device_capture) follows the output's device:
a CUDA output takes the kernel, and samples it does not take (anything
but 1-D 1- or 2-byte integers of native byte order, which every loader
and the encoder give) raise; a CPU output takes the plain version on the
host.  ``routes`` counts the widenings by route ('card', 'host'); each
kernel launch adds one to ``widen.launches``.
"""

from __future__ import annotations

import ctypes
import warnings
from typing import List, Optional

import numpy as np
import torch

_LIB = None

# widenings done by each route, for callers that must know which route ran
routes = {'card': 0, 'host': 0}


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C entry point's signature on a loaded library."""
    fn = lib.capture_widen_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
                   ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def _lib():
    global _LIB
    if _LIB is None:
        from ld_decode_tpu_torch.utils import cuda_build
        _LIB = _bind(cuda_build.build('capture_widen.cu'))
    return _LIB


def widen_plain(samples: np.ndarray) -> np.ndarray:
    """The plain version, on the host: signed samples are recentred to
    unsigned 16-bit (a DC shift is invisible to the FM demod's RF
    bandpass), then converted to float32, which holds every 16-bit sample
    exactly."""
    arr = np.asarray(samples)
    if np.issubdtype(arr.dtype, np.signedinteger):
        arr = arr.astype(np.int32) + 32768
    routes['host'] += 1
    return arr.astype(np.float32)


def card_kind(dtype) -> Optional[int]:
    """The kernel's code for a sample type (0 uint8, 1 int8, 2 uint16,
    3 int16), or None for a type the kernel does not take."""
    dt = np.dtype(dtype)
    if dt.kind not in 'iu' or dt.itemsize > 2 or not dt.isnative:
        return None
    return 2 * (dt.itemsize - 1) + (dt.kind == 'i')


def sample_kind(samples: np.ndarray) -> int:
    """The kernel's code for a 1-D sample array (card_kind), or a
    ValueError: the card has no other route."""
    arr = np.asarray(samples)
    kind = card_kind(arr.dtype) if arr.ndim == 1 else None
    if kind is None:
        raise ValueError(f'capture widening: samples must be a 1-D array of '
                         f'1- or 2-byte integers of native byte order, got '
                         f'{arr.dtype} {arr.shape}')
    return kind


def widen_schedule(n: int, itemsize: int) -> List[int]:
    """The kernel's ranges for n samples of `itemsize` bytes (1 or 2):
    bounds 0 = b0 < b1 < ... = n, one launch a range [b_k, b_k+1), in
    order.  The samples lie at bytes [(4-s)n, 4n) of the buffer and output
    i at bytes [4i, 4i+4), so a range [a, b) writes below byte 4b and reads
    from byte (4-s)n + s*a: each range ends at the largest b that keeps
    the two apart, short of the last sample, which is widened alone by the
    thread that reads it.  No n has more than 2 + log2(n) ranges."""
    if itemsize not in (1, 2):
        raise ValueError(f'widen_schedule: itemsize must be 1 or 2, got '
                         f'{itemsize}')
    if n <= 0:
        return []
    bounds = [0]
    while bounds[-1] < n - 1:
        a = bounds[-1]
        bounds.append(min(((4 - itemsize) * n + itemsize * a) // 4, n - 1))
    bounds.append(n)
    return bounds


def _check_out(out: torch.Tensor, n: int):
    if out.device.type != 'cuda' or out.dtype != torch.float32 \
            or out.dim() != 1 or not out.is_contiguous() or out.numel() < n:
        raise ValueError(f'capture widening: out must be a contiguous 1-D '
                         f'float32 CUDA tensor of at least {n} samples, got '
                         f'{out.dtype} {tuple(out.shape)} on {out.device}')


def stage(samples, out: torch.Tensor) -> None:
    """Copy the n samples as they are into out's bytes [(4-s)n, 4n), where
    `widen` reads them: a copy on the current stream, so it follows any
    queued work still reading the old contents.  From a numpy array
    (pageable memory) the host returns when the copy is done.  From a host
    tensor in pinned memory (the segmented Framer's staging buffer) the
    copy is asynchronous: the host returns at once, and the caller leaves
    the samples as they are until an event recorded after this call has
    passed."""
    arr = np.asarray(samples)
    sample_kind(arr)
    n, s = arr.shape[0], arr.dtype.itemsize
    _check_out(out, n)
    dst = out.view(torch.uint8)[(4 - s) * n:4 * n]
    if isinstance(samples, torch.Tensor):
        src = samples.contiguous().view(torch.uint8)
        dst.copy_(src, non_blocking=src.is_pinned())
        return
    with warnings.catch_warnings():
        # the loaders' arrays may be read-only views of the file's bytes;
        # the copy only reads them
        warnings.simplefilter('ignore', UserWarning)
        src = torch.from_numpy(np.ascontiguousarray(arr).view(np.uint8))
    dst.copy_(src)


def widen(out: torch.Tensor, n: int, kind: int) -> torch.Tensor:
    """Widen the n samples of type `kind` (card_kind) that `stage` put in
    `out` to float32 in out[:n], in place, and zero out[n:]: the kernel's
    launches over widen_schedule's ranges on the current stream, without
    synchronising.  Raises where the launcher refuses the kind or the
    ranges, or a launch fails.  Returns out."""
    _check_out(out, n)
    bounds = widen_schedule(n, 1 if kind < 2 else 2)
    nranges = max(len(bounds) - 1, 0)
    table = (ctypes.c_longlong * len(bounds))(*bounds)
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream(out.device).cuda_stream
        rc = _lib().capture_widen_launch(out.data_ptr(), n, out.numel(), kind,
                                         table, nranges, stream)
    if rc != 0:
        raise RuntimeError(f'capture_widen kernel launch failed: '
                           f'cudaError {rc}')
    widen.launches += nranges
    routes['card'] += 1
    return out


widen.launches = 0
