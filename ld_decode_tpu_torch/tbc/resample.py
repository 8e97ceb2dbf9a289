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


def sample_cubic(data: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """Cubic interpolation of 1-D `data` at fractional positions `pos`
    (any shape).  Positions are clamped to the valid interior [1, n-3]
    before the floor."""
    n = data.shape[0]
    pos = pos.to(data.dtype).clamp(1.0, n - 3.0)
    i0 = torch.floor(pos).to(torch.int32)
    return cubic_gather(data[None], i0[None], (pos - i0)[None])[0]


def downscale_lines(data: torch.Tensor, lineinfo: torch.Tensor,
                    outwidth: int, nlines: int,
                    wow_scale: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """Resample `nlines` scan lines of 1-D `data` onto `outwidth` samples
    each (reference lddutils.py:93-96 evaluation grid).

    lineinfo: (nlines+1,) float sample locations of line starts; output
    sample k of line l is data interpolated at
    lineinfo[l] + k*(lineinfo[l+1]-lineinfo[l])/outwidth.  wow_scale:
    optional (nlines,) per-line amplitude correction.  Returns (nlines,
    outwidth).

    The positions are `data`'s float32, as the JAX package's are with x64
    off, so past ~1e6 samples they resolve only 1/16 sample, exactly as
    JAX's do; `downscale_lines_split` keeps sub-sample precision there.
    They are rounded as the JAX package's compiled graph rounds them (see
    `downscale_lines_split`): k / outwidth is k times the float32
    reciprocal, and the multiply-add is fused (one rounding, done here as
    the float64 sum cast back)."""
    li = lineinfo.to(data.dtype)
    starts = li[:nlines]
    delta = li[1:nlines + 1] - starts
    k = torch.arange(outwidth, dtype=data.dtype, device=data.device)
    kw = k * (1.0 / outwidth)
    pos = (starts[:, None].double() + delta[:, None].double()
           * kw.double()).to(data.dtype)
    out = sample_cubic(data, pos)
    if wow_scale is not None:
        out = out * wow_scale[:, None]
    return out


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
