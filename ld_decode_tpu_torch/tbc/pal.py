"""PAL pilot-burst TBC refinement on the device (torch port of
ld_decode_tpu/tbc/pal.py).

Each line's pilot signal (demod minus its 0.5 MHz low-pass, over the 4.7 us
window before the hsync end, reversed) yields sub-sample rising zero
crossings; their fractional phase against the wow-adjusted 3.75 MHz grid
gives per-line offsets whose medians drive the alignment (reference
lddecode_core.py:962-1021 `refine_linelocs_pilot`).

Every function takes a leading field axis: demod (B, n), line tables
(B, L).  Nothing here reads a value back to the host.  Medians go through a
sort (`fused._masked_nanmedian`): the two middles averaged for an even
count and NaN for an empty row, as jnp.nanmedian gives them.  Divisions
whose quotient feeds a floor use a tensor divisor (`fused._tdiv`), so the
card and the CPU round them alike.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ld_decode_tpu_torch.tbc.fused import _masked_nanmedian as _nanmedian
from ld_decode_tpu_torch.tbc.fused import _tdiv
from ld_decode_tpu_torch.tbc.sync import gather_windows

PILOT_W = 188           # usectoinpx(4.7) at 40 MSa/s


def pilot_offsets(demod: torch.Tensor, demod05: torch.Tensor,
                  lli: torch.Tensor, llf: torch.Tensor, linelen: int,
                  freq: float, pilot_mhz: float = 3.75):
    """Per-line pilot phase offsets (reference lddecode_core.py:972-1006).

    Returns (frac (B, L, W-1), the mask of its valid crossings)."""
    L = lli.shape[-1]
    dev = lli.device
    w0 = lli - PILOT_W
    pilot = gather_windows(demod, w0, PILOT_W) \
        - gather_windows(demod05, w0, PILOT_W)
    pilot = pilot.flip(-1)

    a = pilot[..., :-1]
    b = pilot[..., 1:]
    crossing = (a < 0) & (b >= 0)       # rising zero crossings
    # trigger gate: the reference walks from samples in (-300k, -100k); at
    # ~10.7 samples a cycle one of the 3 samples before a genuine rising
    # crossing lies in that window.  The shifted gates are pads, not rolls.
    inr = (pilot > -300000.0) & (pilot < -100000.0)
    n1 = a.shape[-1]
    g0 = inr[..., :-1]
    g1 = F.pad(F.pad(inr, (1, 0))[..., :-2], (0, 1))[..., :n1]
    g2 = F.pad(F.pad(inr, (2, 0))[..., :-3], (0, 2))[..., :n1]
    crossing = crossing & (g0 | g1 | g2)

    i = torch.arange(n1, dtype=torch.float32, device=dev)
    d = a - b
    zc = i + a / torch.where(d == 0, 1.0, d)

    # wow-adjusted sample rate (reference lddecode_core.py:981-983)
    gaps = (lli - lli.roll(1, -1)).to(torch.float32) \
        + (llf - llf.roll(1, -1))
    adjfreq = torch.where(torch.arange(L, device=dev) > 1,
                          freq / _tdiv(gaps, linelen), freq)
    zcp = zc / _tdiv(adjfreq, pilot_mhz)[..., None]
    frac = zcp - torch.floor(zcp)
    return frac, crossing


def _refine_pilot_once(demod, demod05, lli, llf, linelen: int, freq: float,
                       relative_only: bool):
    """One damped pilot-alignment pass over (B, L) split line tables.

    relative_only=False is the reference's pass verbatim, including its
    global phase shift toward tgt (lddecode_core.py:996-1006): plain
    (non-circular) medians, so with tgt=0 and fracs near 1 it commands
    nearly a full-cycle move, damped to a quarter.  relative_only=True
    removes the per-line deviation around the lines' common phase without
    moving the global position (the extra convergence passes)."""
    Bn, L = lli.shape
    dev = lli.device
    frac, crossing = pilot_offsets(demod, demod05, lli, llf, linelen, freq)

    # trim the first and last crossing of each line for l >= 2
    csum = torch.cumsum(crossing.to(torch.int32), dim=-1)
    total = csum[..., -1:]
    trimmed = crossing & (csum > 1) & (csum < total)
    l2 = (torch.arange(L, device=dev) >= 2)[:, None]
    use = torch.where(l2, trimmed, crossing)

    global_med = _nanmedian(frac.reshape(Bn, -1),
                            (trimmed & l2).reshape(Bn, -1))
    # NaN (no crossing in the field) fails both comparisons: tgt = 0
    tgt = torch.where((global_med >= 0.25) & (global_med <= 0.75), 0.5, 0.0)

    has = use.any(dim=-1)
    if not relative_only:
        line_med = _nanmedian(frac, use)
        adjustment = torch.where(has, tgt[:, None] - line_med, 0.0)
    else:
        # circular deviation around the target (floor-mod), median-centred
        # so only per-line jitter moves
        d = torch.remainder(frac - tgt[:, None, None] + 0.5, 1.0) - 0.5
        line_dev = _nanmedian(d, use)
        line_dev = line_dev - _nanmedian(line_dev, has)[:, None]
        adjustment = torch.where(has, -line_dev, 0.0)
    adjustment = torch.where(torch.isnan(adjustment), 0.0, adjustment)

    llf2 = llf + adjustment * (freq / 3.75) * 0.25
    q = torch.floor(llf2)
    return (lli + q.to(torch.int32)).to(torch.int32), llf2 - q


def refine_pilot(demod, demod05, lli, llf, linelen: int, freq: float,
                 passes: int = 1):
    """Apply the pilot alignment to a batch of fields; returns the adjusted
    (lli, llf).  passes=1 (the default, and what the decode runs) is the
    reference's single damped pass; passes > 1 adds relative-only passes
    (wrap-aware and median-centred: pass 1 keeps the reference's global
    phase shift, which is the framing contract)."""
    for k in range(passes):
        lli, llf = _refine_pilot_once(demod, demod05, lli, llf, linelen,
                                      freq, relative_only=k > 0)
    return lli, llf
