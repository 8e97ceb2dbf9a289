"""NTSC colorburst phase refinement (torch port of ld_decode_tpu/tbc/burst.py).

Each line's scaled burst window yields sub-sample zero crossings classified
into rising/falling groups; per-group means (first/last chopped) give the
line's phase offset against the 4-sample subcarrier grid.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ld_decode_tpu_torch.tbc.sync import seq_mean, seq_sum


def burst_phase_offsets(scaled_burst: torch.Tensor, hz_ire: float,
                        win0: int = 20):
    """Per-line burst phase estimates from (..., L, W) resampled
    demod_burst lines; the 40-sample burst window starts at column `win0`
    (grid column 20).  Returns (phase_even, phase_odd, burstlevel,
    level_ok, counts_ok), each (..., L)."""
    L = scaled_burst.shape[-2]
    ba = scaled_burst[..., win0:win0 + 40]
    ba = ba - seq_mean(ba)[..., None]
    level = ba.abs().amax(dim=-1)
    # population std, as numpy/jnp.std (torch.std defaults to correction=1)
    std = torch.sqrt(seq_mean((ba - seq_mean(ba)[..., None]) ** 2))

    # rot-spike / weak-burst rejection
    level_ok = ((level / hz_ire) <= 30) & ((std / hz_ire) >= 3)

    a = ba[..., :-1]
    b = ba[..., 1:]
    crossing = (a * b) < 0
    prev = F.pad(ba.abs(), (1, 0))[..., :a.shape[-1]]
    gate = torch.maximum(a.abs(), prev)
    crossing = crossing & (gate > 0.6 * level[..., None])

    i = torch.arange(a.shape[-1], dtype=scaled_burst.dtype,
                     device=scaled_burst.device)
    d = a - b
    frac = a / torch.where(d == 0, torch.ones_like(d), d)
    zc = i + frac

    # offset against the 4fsc grid, folded to [-0.5, 3.5)
    offset = zc - (torch.floor(zc / 4) * 4 - 1)
    offset = torch.where(offset > 3.5, offset - 4, offset)

    falling = a > 0
    rising = ~falling

    def group_mean(mask):
        mask = crossing & mask
        # chop the first and last crossing of each group
        csum = torch.cumsum(mask.to(torch.int32), dim=-1)
        total = csum[..., -1:]
        keep = mask & (csum > 1) & (csum < total)
        cnt = keep.sum(dim=-1)
        s = seq_sum(torch.where(keep, offset, 0.0))
        mean = s / cnt.clamp(min=1)
        return mean, mask.sum(dim=-1)

    mean_fall, n_fall = group_mean(falling)
    mean_rise, n_rise = group_mean(rising)
    counts_ok = (n_fall >= 3) & (n_rise >= 3)

    # per-line 180-degree flip: odd lines swap the rising/falling roles
    odd = (torch.arange(L, device=scaled_burst.device) % 2) == 1
    ph0 = torch.where(odd, 2.0 - mean_rise, 2.0 - mean_fall)
    ph1 = torch.where(odd, 2.0 - mean_fall, 2.0 - mean_rise)
    return ph0, ph1, level, level_ok, counts_ok
