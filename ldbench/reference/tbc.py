"""ld-decode's PAL line locations, worked out again in plain numpy (float64)
from the reference's own demodulation.

A PAL field's lines are located in two stages (lddecode_core.py
`refine_linelocs_hsync`, then `refine_linelocs_pilot`):

  * the hsync stage: from a start inside the sync tip, the first rising
    crossing of -20 IRE in the 0.5 MHz low-passed demod, then the crossing
    of the level midway between the sync tip and the back porch, which
    becomes the line's location; a line whose windows leave the expected
    levels, or whose start carries the next field's pre-equalising pulses
    (ITU-R BT.470's PAL lines 311 and 623.5 on: a first field's lines from
    311, a second field's from 312, which ld-decode's first stage marks),
    is "bad" and continues the last two lines' slope;
  * one damped pilot pass: each line's 3.75 MHz pilot (the demod less its
    0.5 MHz low-pass, over the 188 samples before the line's location,
    reversed) gives its rising zero crossings, gated on a trough between
    -300 and -100 kHz; their phase against the line's wow-adjusted pilot
    grid, with a line's first and last crossing dropped, gives fractions
    whose plain median moves the line by a quarter of its distance to the
    field's target phase (0.5 where the field's median fraction lies in
    [0.25, 0.75], else 0).  A line with no usable crossing is not moved:
    it stays at its hsync location, about 2 px from where its neighbours
    land, which ld-decode does too.

The sync tip's start and the line's nominal time come from the source's
own time base (`hsync_offset_px` of the configuration: ld-decode's
hsync-stage line start against the source's line times), not from the
decode under test.
"""

from __future__ import annotations

import numpy as np

PILOT_W = 188           # 4.7 us at 40 MSa/s
PILOT_MHZ = 3.75
# the reference's search starts this far inside the sync tip, before the
# line's nominal hsync location
TIP_LEAD = 60
# a PAL field's first line that carries the next field's pre-equalising
# pulses at its start: (first field, second field)
PRE_EQUALISING = (311, 312)


def _first_crossing(rows: np.ndarray, target: float, rising: bool):
    """(position relative to rows[1], found) of the first crossing of
    `target` in rows[1:], interpolated between the samples around it
    (ld-decode's calczc)."""
    body = rows[1:]
    cond = body >= target if rising else body <= target
    hit = np.flatnonzero(cond)
    if not hit.size:
        return 0.0, False
    k = int(hit[0])
    a = rows[k] - target
    b = rows[k + 1] - target
    d = a - b
    return (k - 1) + a / (d if d != 0 else 1.0), True


def hsync_locations(d05: np.ndarray, nominal: np.ndarray, cfg,
                    first_field: bool) -> np.ndarray:
    """Each line's hsync-stage location, from line 10 on (earlier lines
    keep `nominal`): the mid-level crossing of the sync's rising edge found
    from a start inside its tip, bad lines continuing the last two lines'
    slope."""
    eq = PRE_EQUALISING[0 if first_field else 1]
    freq = int(round(cfg.freq_mhz))
    ire = cfg.iretohz
    n = d05.shape[0]
    out = np.asarray(nominal, np.float64).copy()
    for l in range(10, len(out)):
        s = int(np.clip(np.floor(nominal[l]) - TIP_LEAD, 1, n - 402))
        rows = d05[s - 1:s + 401]
        zc, found = _first_crossing(rows, ire(-20), rows[1] < ire(-20))
        zc_i = int(np.clip(s + np.floor(zc), 0, n - 1))

        def win(a, w):
            a = int(np.clip(a, 0, n - w))
            return d05[a:a + w]

        w1 = win(s - 2 * freq, 4 * freq)
        wh = win(zc_i - freq, 4 * freq)
        wb = wh[2 * freq:]
        bad_range = (wh.min() < ire(-60) or wh.max() > ire(20)
                     or w1.min() < ire(-60) or w1.max() > ire(100)
                     or wb.min() < ire(-10) or wb.max() > ire(10))
        mid = (wh[:20].mean() + wh[100:120].mean()) / 2
        rows2 = np.concatenate([wh[:1], wh])
        zc2, found2 = _first_crossing(rows2, mid, wh[0] < mid)
        found2 = found2 and zc2 > 0
        zc2r = zc2 + (zc_i - freq - s)
        zc2_ok = found2 and abs(zc2r - zc) < freq / 4
        bad = (not found) or bad_range or not zc2_ok or l >= eq
        if bad and l > 10:
            out[l] = 2 * out[l - 1] - out[l - 2]
        else:
            out[l] = s + (zc2r if zc2_ok and not bad_range else zc)
    return out


def pilot_fractions(demod: np.ndarray, d05: np.ndarray, loc: np.ndarray,
                    cfg):
    """(fractions (L, W-1), the mask of usable crossings (L, W-1)) of each
    line's pilot against its wow-adjusted grid, anchored at the integer
    part of its location; the mask drops each line's first and last
    crossing from line 2 on."""
    freq = cfg.freq_mhz
    n = demod.shape[0]
    L = len(loc)
    li = np.floor(loc).astype(np.int64)
    starts = np.clip(li - PILOT_W, 0, n - PILOT_W)
    idx = starts[:, None] + np.arange(PILOT_W)
    pilot = (demod[idx] - d05[idx])[:, ::-1]
    a, b = pilot[:, :-1], pilot[:, 1:]
    crossing = (a < 0) & (b >= 0)
    inr = (pilot > -300000.0) & (pilot < -100000.0)
    g0 = inr[:, :-1]
    g1 = np.pad(inr, ((0, 0), (1, 0)))[:, :-2]
    g2 = np.pad(inr, ((0, 0), (2, 0)))[:, :-3]
    crossing &= g0 | g1 | g2
    d = a - b
    zc = np.arange(PILOT_W - 1)[None, :] + a / np.where(d == 0, 1.0, d)
    gaps = loc - np.roll(loc, 1)
    adjfreq = np.where(np.arange(L) > 1, freq / (gaps / cfg.linelen), freq)
    zcp = zc / (adjfreq / PILOT_MHZ)[:, None]
    frac = zcp - np.floor(zcp)
    csum = np.cumsum(crossing, axis=1)
    trimmed = crossing & (csum > 1) & (csum < csum[:, -1:])
    use = np.where((np.arange(L) >= 2)[:, None], trimmed, crossing)
    return frac, use


def pilot_pass(demod: np.ndarray, d05: np.ndarray, loc: np.ndarray, cfg):
    """ld-decode's one damped pilot pass over a field's hsync-stage line
    locations (plain medians, the field's target phase): (the locations,
    the lines it left unmoved for want of a usable crossing)."""
    frac, use = pilot_fractions(demod, d05, loc, cfg)
    used = frac[2:][use[2:]]
    gm = float(np.median(used)) if used.size else np.nan
    tgt = 0.5 if 0.25 <= gm <= 0.75 else 0.0
    adj = np.zeros(len(loc))
    for l in range(len(loc)):
        if use[l].any():
            adj[l] = tgt - float(np.median(frac[l][use[l]]))
    moved = loc + adj * (cfg.freq_mhz / PILOT_MHZ) * 0.25
    return moved, np.flatnonzero(~use.any(axis=1))
