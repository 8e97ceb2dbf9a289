"""take_along_axis on the card: the ctypes wrapper of kernel K2.

Replaces the TPU Pallas kernel scripts/probe_warp.py:118 (probe_dyngather's
`kern`), placed where that probe was aimed: the quad-row gather of the
Farneback warp (ld_decode_tpu/comb/optflow.py:160, here
comb/optflow.py::_bilinear_gather_quad).  The source is
csrc/take_along_axis.cu, built with nvcc at first use
(utils/cuda_build.py).  It is bound by memory traffic (~19-21 us for the
warp's full level, both fields in one call, at 3.35 TB/s), and reaching
that rate takes many loads in flight: see the note there.

Two paths, one launch either way:
  - the row gather (`take_rows_launch`), when `row_gather_ok`: axis 0,
    one index per row (idx.stride(1) == 0, the warp's broadcast view),
    a width that is a multiple of 4 floats and op and out 16-byte
    aligned -- each output row is one operand row, copied in 16-byte
    chunks, one a thread;
  - the general gather (`take_along_axis_launch`), a thread per output
    element, for every other call (axis 1, a full index, other widths,
    unaligned views).

Each launch adds one to ``take_along_axis.launches``; a launch on the row
path also adds one to ``take_along_axis.row_launches``; a launch captured
in a CUDA graph is counted on each replay instead (utils/graphs.py).
Callers go
through ops/gather.py::take_along_axis, which sends CPU tensors to the
plain version.
"""

from __future__ import annotations

import ctypes

import torch

from ld_decode_tpu_torch.utils.graphs import register_counter

_LIB = None


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C entry points' signatures on a loaded library."""
    fn = lib.take_along_axis_launch
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 \
        + [ctypes.c_longlong] * 2 + [ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    fn = lib.take_rows_launch
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 \
        + [ctypes.c_longlong, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def _lib():
    global _LIB
    if _LIB is None:
        from ld_decode_tpu_torch.utils import cuda_build
        _LIB = _bind(cuda_build.build('take_along_axis.cu'))
    return _LIB


def row_gather_ok(op: torch.Tensor, idx: torch.Tensor, axis: int,
                  out: torch.Tensor) -> bool:
    """Whether a call takes K2's row-gather path: each output row is the
    operand row named by one index (axis 0, idx broadcast along the row),
    copied as 16-byte chunks, so the width is a multiple of 4 floats and
    op and out start on 16-byte boundaries; the chunk count fits 31 bits.
    Reads only shapes, strides and addresses (any device)."""
    return (axis == 0 and idx.dim() == 2 and idx.stride(1) == 0
            and op.dim() == 2 and op.is_contiguous()
            and op.shape[1] % 4 == 0 and op.shape[1] > 0
            and op.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0
            and idx.shape[0] * (op.shape[1] // 4) < 2**31)


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
        rows = row_gather_ok(op, idx, axis, out)
        if rows:
            rc = _lib().take_rows_launch(
                op.data_ptr(), idx.data_ptr(), out.data_ptr(), idx.shape[0],
                op.shape[1], op.shape[0], idx.stride(0), stream)
        else:
            rc = _lib().take_along_axis_launch(
                op.data_ptr(), idx.data_ptr(), out.data_ptr(), idx.shape[0],
                idx.shape[1], op.shape[0], op.shape[1], idx.stride(0),
                idx.stride(1), axis, stream)
    if rc != 0:
        raise RuntimeError(f'take_along_axis kernel launch failed: '
                           f'cudaError {rc}')
    take_along_axis.launches += 1
    take_along_axis.row_launches += int(rows)
    return out


take_along_axis.launches = 0
take_along_axis.row_launches = 0
register_counter(take_along_axis, 'launches', 'row_launches')
