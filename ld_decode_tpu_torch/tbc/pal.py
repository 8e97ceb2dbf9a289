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

The pass moves a line by the plain median of its pilot fractions, the
reference's pass verbatim, and the port keeps it (ROADMAP.md Queue 3,
F3): the oracle framing depends on pass 1 (ld_decode_tpu/tbc/pal.py:
102-105).  Where a line's fractions straddle the 0/1 wrap under the
target 0.5, the line sits about half a cycle off, a move with no right
direction, and one fraction crossing the wrap moves the median to the
next order statistic.  Such lines sit in the vertical interval.  The
pass also measures a line's phases from its location's integer anchor,
so where that location sits next to an integer, two decodes can anchor a
sample apart and read phases a sample's 0.094 cycle apart.  Two decodes
of a field whose rounding differs (the card and the CPU) can differ there
by a quarter of a pixel: `wrap_flip_lines` names those lines and the
difference the two decodes' phases predict, so a comparison accounts for
them instead of exempting them.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ld_decode_tpu_torch.tbc.fused import _masked_nanmedian as _nanmedian
from ld_decode_tpu_torch.tbc.fused import _tdiv
from ld_decode_tpu_torch.tbc.sync import gather_windows

PILOT_W = 188           # usectoinpx(4.7) at 40 MSa/s
# the card-vs-CPU budget of a line location, px: two decodes of a line
# whose pass inputs differ by more are apart before the pass
FLIP_LOC_TOL = 0.02


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


def _pilot_adjustment(frac: torch.Tensor, crossing: torch.Tensor,
                      relative_only: bool):
    """The pass's move of each line, in cycles of the pilot, from a batch
    of fields' (B, L, W-1) `pilot_offsets`: (adjustment (B, L), the mask
    of the phases it used)."""
    Bn, L = frac.shape[:2]
    dev = frac.device
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
    return torch.where(torch.isnan(adjustment), 0.0, adjustment), use


def _refine_pilot_once(demod, demod05, lli, llf, linelen: int, freq: float,
                       relative_only: bool):
    """One damped pilot-alignment pass over (B, L) split line tables.

    relative_only=False is the reference's pass verbatim, including its
    global phase shift toward tgt (lddecode_core.py:996-1006): plain
    (non-circular) medians, so with tgt=0 and fracs near 1 it commands
    nearly a full-cycle move, damped to a quarter.  relative_only=True
    removes the per-line deviation around the lines' common phase without
    moving the global position (the extra convergence passes)."""
    frac, crossing = pilot_offsets(demod, demod05, lli, llf, linelen, freq)
    adjustment, _use = _pilot_adjustment(frac, crossing, relative_only)
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


def _same_phases(x: np.ndarray, y: np.ndarray, tol: float,
                 spare: int = 0) -> bool:
    """Whether two sets of pilot phases (cycles) are one set taken
    circularly, each within tol; the longer may hold `spare` phases more
    (crossings at its window's edge)."""
    if x.size < y.size:
        x, y = y, x
    if y.size == 0 or x.size - y.size > spare:
        return False
    # turned so that the wrap lies half a cycle from the phases' mean
    c = np.angle(np.exp(2j * np.pi * np.concatenate([x, y])).sum()) \
        / (2 * np.pi)
    x, y = (np.sort((v - c + 0.5) % 1.0) for v in (x, y))
    if x.size == y.size:
        return bool(np.abs(x - y).max() <= tol)
    return any(np.abs(np.delete(x, k) - y).max() <= tol
               for k in range(x.size))


def wrap_flip_lines(frac_a, cross_a, frac_b, cross_b, lli, llf,
                    freq: float, tol: float = 0.01):
    """The lines of two decodes a and b of one PAL field (the card and the
    CPU) that the pilot pass moved apart through a wrap at 0/1, though
    they entered it within FLIP_LOC_TOL px of each other.

    frac_*/cross_*: each decode's `pilot_offsets` of the field, (L, W-1)
    numpy arrays; lli, llf: the pairs (decode a's, decode b's) of (L,)
    split line locations the passes started from (the hsync stage: int32
    anchors and float32 fractions).  A line whose two locations lie
    within FLIP_LOC_TOL px flips in one of two ways:

    * the locations straddle an integer, so the two anchors differ by
      one: the pass measures the pilot from windows a sample apart
      (`pilot_offsets` reads from the anchor), and every phase it uses
      (the `use` mask of the pass) moved by a sample's 3.75 / freq of a
      cycle, within tol (a window a sample on may hold one crossing
      more or less at its edge), and so does the median;
    * the anchors are equal, the phases the pass uses are the same in
      both decodes, each within tol of a cycle taken circularly, and a
      different number of them lies below half a cycle: one crossed the
      wrap, and the plain median takes another order statistic.  (Such a
      crossing may sit a sample later in one decode, where a sample next
      to zero rounds to either sign: the phases are compared as sets.)

    A line that entered the pass further apart is no flip.

    Returns (lines, predicted, anchored): the flipped lines; for each, the
    location difference b - a after the pass that the port's pass
    (`_pilot_adjustment`, on the CPU) predicts from the two decodes' pilot
    phases, (loc_b - loc_a) + (move_b - move_a) * (freq / 3.75) / 4,
    where loc = anchor + fraction and move = tgt - the median; and
    whether the anchors differ.  The decode runs one pass, whose
    wow-adjusted rate reads the gaps between the locations it started
    from, so a flip does not reach another line."""
    moves, uses, fracs = [], [], []
    for frac, cross in ((frac_a, cross_a), (frac_b, cross_b)):
        frac = np.array(frac, np.float32)
        move, use = _pilot_adjustment(
            torch.from_numpy(frac)[None],
            torch.from_numpy(np.array(cross, bool))[None], False)
        moves.append(move[0].double().numpy())
        uses.append(use[0].numpy())
        fracs.append(frac.astype(np.float64))
    (ia, ib), (fa, fb) = lli, llf
    ia, ib = np.asarray(ia, np.int64), np.asarray(ib, np.int64)
    loc_a = ia + np.asarray(fa, np.float64)
    loc_b = ib + np.asarray(fb, np.float64)
    step = ib - ia
    flipped = np.zeros(loc_a.shape, bool)
    near = (np.abs(loc_b - loc_a) <= FLIP_LOC_TOL) & (np.abs(step) <= 1)
    for l in np.nonzero(near)[0]:
        a, b = fracs[0][l][uses[0][l]], fracs[1][l][uses[1][l]]
        if step[l]:
            a = (a + step[l] * 3.75 / freq) % 1.0
            flipped[l] = _same_phases(a, b, tol, spare=1)
        elif (a < 0.5).sum() != (b < 0.5).sum():
            flipped[l] = _same_phases(a, b, tol)
    lines = np.nonzero(flipped)[0]
    predicted = (loc_b - loc_a
                 + (moves[1] - moves[0]) * (freq / 3.75) * 0.25)[lines]
    return lines, predicted, step[lines] != 0
