"""Batched line resampling onto the 4*fsc output grid (torch port of
ld_decode_tpu/tbc/resample.py).

All lines of a batch of fields are resampled in one batched
cubic-convolution (Catmull-Rom) gather.  This module is the plain PyTorch
version of the hand-written CUDA kernel in tbc/cuda_resample.py; the
kernel reproduces its float32 operation order.
"""

from __future__ import annotations

from typing import Optional

import torch


def catmull_rom_weights(t: torch.Tensor):
    """Keys cubic-convolution weights (a=-0.5) for the 4-tap neighbourhood."""
    t2 = t * t
    t3 = t2 * t
    w0 = -0.5 * t3 + t2 - 0.5 * t
    w1 = 1.5 * t3 - 2.5 * t2 + 1.0
    w2 = -1.5 * t3 + 2.0 * t2 + 0.5 * t
    w3 = 0.5 * t3 - 0.5 * t2
    return w0, w1, w2, w3


def cubic_gather(data: torch.Tensor, i0: torch.Tensor,
                 t: torch.Tensor) -> torch.Tensor:
    """4-tap cubic interpolation of data (B, n) at integer indices
    i0 (B, ...) plus fraction t; i0 is clipped to [1, n-3]."""
    B, n = data.shape
    shape = i0.shape
    i0 = i0.clamp(1, n - 3).reshape(B, -1).long()
    w0, w1, w2, w3 = catmull_rom_weights(t.to(data.dtype).reshape(B, -1))

    def tap(k):
        return data.gather(1, i0 + k)

    out = w0 * tap(-1) + w1 * tap(0) + w2 * tap(1) + w3 * tap(2)
    return out.reshape(shape)


def downscale_lines_split(data: torch.Tensor, lli: torch.Tensor,
                          llf: torch.Tensor, outwidth: int, nlines: int,
                          wow_scale: Optional[torch.Tensor] = None,
                          col0: int = 0, ncols: Optional[int] = None
                          ) -> torch.Tensor:
    """Resample `nlines` lines of each field onto `outwidth` samples.

    data (B, nsamp); lli/llf (B, >=nlines+1) split line locations (int32
    anchor, float32 offset); wow_scale optional (B, nlines).  Output sample
    k of line l reads data at lli[l] + llf[l] + k*steplen[l]/outwidth.
    col0/ncols restrict the output to columns [col0, col0+ncols).
    Returns (B, nlines, ncols or outwidth)."""
    si = lli[:, :nlines]
    sf = llf[:, :nlines]
    steplen = (lli[:, 1:nlines + 1] - si).to(torch.float32) \
        + (llf[:, 1:nlines + 1] - sf)
    if ncols is None:
        ncols = outwidth
    k = torch.arange(col0, col0 + ncols, dtype=torch.float32,
                     device=data.device)
    # rel = sf + steplen * (k / outwidth), rounded as the JAX package's
    # compiled XLA graph rounds it: the division by the constant becomes a
    # multiply by its float32 reciprocal, and the multiply-add is fused
    # (one rounding).  The product of two float32 values is exact in
    # float64, so the float64 sum cast to float32 is the fused result on
    # every device, and the CUDA kernel computes the same expression.
    kw = k * (1.0 / outwidth)
    rel = (sf[..., None].double() + steplen[..., None].double()
           * kw.double()).to(torch.float32)
    relf = torch.floor(rel)
    i0 = si[..., None] + relf.to(torch.int32)
    out = cubic_gather(data, i0, rel - relf)
    if wow_scale is not None:
        out = out * wow_scale[..., None]
    return out
