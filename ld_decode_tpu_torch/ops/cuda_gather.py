"""take_along_axis on the card: the ctypes wrapper of kernel K2.

Replaces the TPU Pallas kernel scripts/probe_warp.py:118 (probe_dyngather's
`kern`), placed where that probe was aimed: the quad-row gather of the
Farneback warp (ld_decode_tpu/comb/optflow.py:160, here
comb/optflow.py::_bilinear_gather_quad).  The source is
csrc/take_along_axis.cu (one thread per output element; bound by memory
traffic, at most ~20.7 us for the warp's full level, both fields in one
call, at 3.35 TB/s -- see the note there), built with nvcc at first use
(utils/cuda_build.py).

Each launch adds one to ``take_along_axis.launches``.  Callers go through
ops/gather.py::take_along_axis, which sends CPU tensors to the plain
version.
"""

from __future__ import annotations

import ctypes

import torch

_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        from ld_decode_tpu_torch.utils import cuda_build
        lib = cuda_build.build('take_along_axis.cu')
        fn = lib.take_along_axis_launch
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 \
            + [ctypes.c_longlong] * 2 + [ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def take_along_axis(op: torch.Tensor, idx: torch.Tensor,
                    axis: int) -> torch.Tensor:
    """Launch K2: out[i, j] = op[idx[i, j], j] (axis 0) or op[i, idx[i, j]]
    (axis 1), indices clamped to the operand.  op: contiguous 2-D float32
    on a CUDA device; idx: 2-D int32 on the same device, any non-negative
    strides (a broadcast view is read in place)."""
    if op.device.type != 'cuda':
        raise ValueError(f'take_along_axis kernel: op is on {op.device}, '
                         f'not a CUDA device')
    if op.dim() != 2 or op.dtype != torch.float32 or not op.is_contiguous():
        raise ValueError('take_along_axis kernel: op must be a contiguous '
                         f'2-D float32 tensor, got {op.dtype} '
                         f'{tuple(op.shape)}')
    if idx.device != op.device or idx.dtype != torch.int32 \
            or idx.dim() != 2:
        raise ValueError(f'take_along_axis kernel: idx must be 2-D int32 on '
                         f'{op.device}, got {idx.dtype} {tuple(idx.shape)} '
                         f'on {idx.device}')
    if axis not in (0, 1):
        raise ValueError(f'take_along_axis kernel: axis {axis} of a 2-D '
                         f'operand')
    other = 1 - axis
    if idx.shape[other] != op.shape[other] or op.shape[axis] == 0:
        raise ValueError(f'take_along_axis kernel: idx {tuple(idx.shape)} '
                         f'does not fit op {tuple(op.shape)} on axis '
                         f'{axis}')
    if min(idx.stride()) < 0:
        raise ValueError('take_along_axis kernel: negative idx strides')
    out = torch.empty(idx.shape, dtype=torch.float32, device=op.device)
    with torch.cuda.device(op.device):
        stream = torch.cuda.current_stream(op.device).cuda_stream
        rc = _lib().take_along_axis_launch(
            op.data_ptr(), idx.data_ptr(), out.data_ptr(), idx.shape[0],
            idx.shape[1], op.shape[0], op.shape[1], idx.stride(0),
            idx.stride(1), axis, stream)
    if rc != 0:
        raise RuntimeError(f'take_along_axis kernel launch failed: '
                           f'cudaError {rc}')
    take_along_axis.launches += 1
    return out


take_along_axis.launches = 0
