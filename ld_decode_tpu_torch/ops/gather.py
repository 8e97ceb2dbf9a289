"""take_along_axis over a 2-D float32 operand: the plain PyTorch version of
kernel K2 and its dispatcher.

K2 replaces the TPU Pallas kernel scripts/probe_warp.py:118 (Mosaic's
dynamic_gather, `jnp.take_along_axis` in a kernel body) and serves the
Farneback warp's quad-row gather (comb/optflow.py::_bilinear_gather_quad).

Dispatch follows the operand's device: a CPU tensor takes the plain
version; a CUDA tensor launches the kernel (ops/cuda_gather.py) or raises;
any other device raises.
"""

from __future__ import annotations

import torch


def take_along_axis_plain(op: torch.Tensor, idx: torch.Tensor,
                          axis: int) -> torch.Tensor:
    """out[i, j] = op[idx[i, j], j] (axis 0) or op[i, idx[i, j]] (axis 1),
    indices clamped to [0, n-1], as flat-index arithmetic and one advanced
    index (any device)."""
    if op.dim() != 2 or idx.dim() != 2 or axis not in (0, 1):
        raise ValueError(f'take_along_axis: 2-D op and idx and axis 0 or 1, '
                         f'got {tuple(op.shape)}, {tuple(idx.shape)}, '
                         f'axis {axis}')
    rows, cols = op.shape
    k = idx.long().clamp(0, op.shape[axis] - 1)
    if axis == 0:
        j = torch.arange(idx.shape[1], device=op.device)
        flat = k * cols + j
    else:
        i = torch.arange(idx.shape[0], device=op.device)
        flat = i[:, None] * cols + k
    return op.reshape(-1)[flat]


def take_along_axis(op: torch.Tensor, idx: torch.Tensor,
                    axis: int) -> torch.Tensor:
    """K2 for a CUDA operand, its plain version for a CPU one."""
    if op.device.type == 'cpu':
        return take_along_axis_plain(op, idx, axis)
    if op.device.type != 'cuda':
        raise ValueError(f'take_along_axis: no kernel for device '
                         f'{op.device}')
    from ld_decode_tpu_torch.ops import cuda_gather
    return cuda_gather.take_along_axis(op, idx, axis)
