"""Batched per-line cubic resample: the hand-written CUDA kernel and its
dispatcher.

Replaces the TPU Pallas kernel
``ld_decode_tpu/tbc/pallas_resample.py::resample_lines_batch``.  The kernel
source is csrc/resample_lines.cu (one thread per output sample; bound by
memory traffic -- see the note there); it is built with nvcc at first use
(utils/cuda_build.py) and bound with ctypes.

Dispatch follows the tensor's device: a CPU tensor takes the plain PyTorch
version (`resample_lines_batch_plain`); a CUDA tensor launches the kernel
or raises.  Each launch adds one to ``resample_lines_batch.launches``.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ld_decode_tpu_torch.tbc.resample import downscale_lines_split

_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        from ld_decode_tpu_torch.utils import cuda_build
        lib = cuda_build.build('resample_lines.cu')
        fn = lib.resample_lines_launch
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 \
            + [ctypes.c_float, ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB


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
                or t.shape[0] != B or t.shape[1] < nlines + 1:
            raise ValueError(f'resample_lines_batch: {name} must be ({B}, '
                             f'>={nlines + 1}) {dt} on {data.device}, got '
                             f'{t.dtype} {tuple(t.shape)} on {t.device}')
    if nsamp < 4:
        raise ValueError('resample_lines_batch: need at least 4 samples')
    lli = lli[:, :nlines + 1].contiguous()
    llf = llf[:, :nlines + 1].contiguous()
    out = torch.empty((B, nlines, ncols), dtype=torch.float32,
                      device=data.device)
    with torch.cuda.device(data.device):
        stream = torch.cuda.current_stream(data.device).cuda_stream
        rc = _lib().resample_lines_launch(
            data.data_ptr(), lli.data_ptr(), llf.data_ptr(), out.data_ptr(),
            B, nsamp, nlines, nlines + 1, col0, ncols, 1.0 / outwidth,
            float(st_nom), stream)
    if rc != 0:
        raise RuntimeError(f'resample_lines kernel launch failed: '
                           f'cudaError {rc}')
    resample_lines_batch.launches += 1
    return out


resample_lines_batch.launches = 0
