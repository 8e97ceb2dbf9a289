"""Batched per-line cubic resample: the hand-written CUDA kernel and its
dispatcher.

Replaces the TPU Pallas kernel
``ld_decode_tpu/tbc/pallas_resample.py::resample_lines_batch``.  The kernel
source is csrc/resample_lines.cu, built with nvcc at first use
(utils/cuda_build.py) and bound with ctypes.  The picture call is bound by
memory traffic (each line's ~2546-sample span read once, the output
written once), the 48-column burst-window call by latency; see the note
there.  A group of warps resamples one line (`launch_plan`): the line's
span is staged in shared memory with 16-byte asynchronous copies and the
outputs are computed from there.  A line whose span does not fit the
group's buffer, or whose table is broken (steplen negative or not
finite), reads its taps from global memory in the same kernel; so does
every line when the data rows are not 16-byte aligned.  Either way the
result is bit-equal to the plain version.

Dispatch follows the tensor's device: a CPU tensor takes the plain PyTorch
version (`resample_lines_batch_plain`); a CUDA tensor launches the kernel
or raises.  Each launch adds one to ``resample_lines_batch.launches``; a
launch restricted to a column window (ncols < outwidth, the burst window)
also adds one to ``resample_lines_batch.window_launches``.  A launch
captured in a CUDA graph is counted on each replay instead
(utils/graphs.py).
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from ld_decode_tpu_torch.tbc.resample import downscale_lines_split
from ld_decode_tpu_torch.utils.graphs import register_counter

_LIB = None


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C entry point's signature on a loaded library."""
    fn = lib.resample_lines_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 \
        + [ctypes.c_longlong] * 2 + [ctypes.c_int] * 2 \
        + [ctypes.c_float] * 2 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def _lib():
    global _LIB
    if _LIB is None:
        from ld_decode_tpu_torch.utils import cuda_build
        _LIB = _bind(cuda_build.build('resample_lines.cu'))
    return _LIB


_BLOCK = 128                # threads a block
_SMEM_FLOATS = 48 * 1024 // 4   # static shared-memory limit of a block


def launch_plan(ncols: int, outwidth: int, st_nom: float):
    """(group, cap) for a call: `group` threads resample one line -- one
    warp per 128 output columns, rounded up to a power of two and at most
    the whole block (4 warps for the picture's 910 columns, 1 for the burst
    window's 48, so a block holds 4 such lines); `cap` floats of shared
    memory hold one line's span: the columns' share of a line up to 1.25x
    st_nom long, plus a dozen samples for the taps and the widening to
    16-byte chunks.  Longer lines take the kernel's global-memory path."""
    warps = 1
    while 32 * warps < _BLOCK and 128 * warps < ncols:
        warps *= 2
    group = 32 * warps
    span = math.ceil(1.25 * abs(st_nom) * ncols / abs(outwidth)) + 12
    cap = min(-(-span // 4) * 4, _SMEM_FLOATS // (_BLOCK // group) // 4 * 4)
    return group, cap


def _steplen_wow(lli, llf, nlines: int, st_nom: float):
    steplen = (lli[:, 1:nlines + 1] - lli[:, :nlines]).to(torch.float32) \
        + (llf[:, 1:nlines + 1] - llf[:, :nlines])
    # a tensor divisor keeps this a true division on every device (CUDA
    # turns division by a host scalar into a reciprocal multiply)
    return steplen / torch.full((), st_nom, dtype=torch.float32,
                                device=steplen.device)


def resample_lines_batch_plain(data: torch.Tensor, lli: torch.Tensor,
                               llf: torch.Tensor, outwidth: int, nlines: int,
                               st_nom: float, col0: int = 0,
                               ncols: Optional[int] = None) -> torch.Tensor:
    """The plain PyTorch version of the kernel (any device)."""
    wow = _steplen_wow(lli, llf, nlines, st_nom)
    return downscale_lines_split(data, lli, llf, outwidth, nlines, wow,
                                 col0=col0, ncols=ncols)


def resample_lines_batch(data: torch.Tensor, lli: torch.Tensor,
                         llf: torch.Tensor, outwidth: int, nlines: int,
                         st_nom: float, col0: int = 0,
                         ncols: Optional[int] = None) -> torch.Tensor:
    """Batched cubic line resample.

    data (B, nsamp) float32 demod streams; lli/llf (B, >=nlines+1) split
    line locations (int32 anchor, float32 fraction); outwidth output
    samples per nominal line; st_nom nominal line length in input samples
    (the wow amplitude correction is steplen/st_nom); col0/ncols restrict
    the output to columns [col0, col0+ncols).  Returns (B, nlines, ncols or
    outwidth) float32 -- the semantics of `downscale_lines_split(...,
    steplen/st_nom, col0, ncols)`."""
    if ncols is None:
        ncols = outwidth
    if data.device.type == 'cpu':
        return resample_lines_batch_plain(data, lli, llf, outwidth, nlines,
                                          st_nom, col0, ncols)
    if data.device.type != 'cuda':
        raise ValueError(f'resample_lines_batch: no kernel for device '
                         f'{data.device}')
    if data.dim() != 2 or data.dtype != torch.float32 \
            or not data.is_contiguous():
        raise ValueError('resample_lines_batch: data must be a contiguous '
                         f'(B, nsamp) float32 tensor, got {data.dtype} '
                         f'{tuple(data.shape)}')
    B, nsamp = data.shape
    for name, t, dt in (('lli', lli, torch.int32), ('llf', llf,
                                                    torch.float32)):
        if t.device != data.device or t.dtype != dt or t.dim() != 2 \
                or t.shape[0] != B or t.shape[1] < nlines + 1 \
                or t.stride(1) != 1:
            raise ValueError(f'resample_lines_batch: {name} must be ({B}, '
                             f'>={nlines + 1}) {dt} on {data.device} with '
                             f'unit column stride, got {t.dtype} '
                             f'{tuple(t.shape)} strides {t.stride()} on '
                             f'{t.device}')
    if nsamp < 4:
        raise ValueError('resample_lines_batch: need at least 4 samples')
    out = torch.empty((B, nlines, ncols), dtype=torch.float32,
                      device=data.device)
    group, cap = launch_plan(ncols, outwidth, st_nom)
    with torch.cuda.device(data.device):
        stream = torch.cuda.current_stream(data.device).cuda_stream
        # the tables are read in place through their row strides (the
        # picture call passes the views lli[:, 1:], llf[:, 1:])
        rc = _lib().resample_lines_launch(
            data.data_ptr(), lli.data_ptr(), llf.data_ptr(), out.data_ptr(),
            B, nsamp, nlines, lli.stride(0), llf.stride(0), col0, ncols,
            1.0 / outwidth, float(st_nom), group, cap, stream)
    if rc != 0:
        raise RuntimeError(f'resample_lines kernel launch failed: '
                           f'cudaError {rc}')
    resample_lines_batch.launches += 1
    resample_lines_batch.window_launches += int(ncols < outwidth)
    return out


resample_lines_batch.launches = 0
resample_lines_batch.window_launches = 0
register_counter(resample_lines_batch, 'launches', 'window_launches')
