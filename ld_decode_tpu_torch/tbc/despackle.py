"""Rot/dropout concealment on TBC output (reference app/tbc/tbc.cpp:1528-1565).

The PyTorch port's copy of ld_decode_tpu/tbc/despackle.py (the port imports
nothing of the JAX package); tests/test_torch_hostcopies.py holds the two
equal.

Samples whose level falls outside the legal -20..140 IRE window are disc
rot; the reference repairs a [-4, +14)-sample neighborhood around each hit
from the average of the lines two above/below (columns ±2).  Vectorized
numpy (host post-pass over the assembled frame): the hit mask is dilated
18 wide and a single select applies the repair — a superset of the
reference's skip-ahead scan (hits inside an already-repaired span also
trigger repair here).
"""

from __future__ import annotations

import numpy as np


def despackle(picture: np.ndarray, outlinelen: int = 910,
              out_scale: float = 51200.0 / 140.0, offset: int = 1024,
              vsync_ire: float = -40.0,
              rot_level: float = 40.0) -> np.ndarray:
    """picture: (nlines*outlinelen,) or (nlines, outlinelen) uint16.

    `rot_level` is the app/tbc `-r` knob (reference main.cpp:165-168,
    default 40.0): it sets how far outside the 0..100 IRE video range a
    sample must land to count as rot.  The detection window is
    [-rot_level/2, 100 + rot_level] IRE — at the default 40.0 this is the
    reference's hardcoded -20..140 window (tbc.cpp:1541-1542); smaller
    values despackle more aggressively, larger ones less.
    """
    pic = np.asarray(picture).reshape(-1, outlinelen)
    rows, cols = pic.shape
    v = pic.astype(np.float64)
    ire = (v - offset) / out_scale + vsync_ire

    lo, hi = -rot_level / 2.0, 100.0 + rot_level
    r = np.arange(rows)[:, None]
    c = np.arange(cols)[None, :]
    hit = ((ire < lo) | (ire > hi)) & (r >= 22) & (c >= 60) & (c < cols - 16)
    if not hit.any():
        return np.asarray(picture)

    # dilate hits over the reference's [x-4, x+14) repair span
    dil = np.zeros_like(hit)
    ys, xs = np.nonzero(hit)
    for dy in range(-4, 14):
        xx = np.clip(xs + dy, 0, cols - 1)
        dil[ys, xx] = True

    up = np.roll(v, 2, axis=0)           # line y-2
    dn = np.roll(v, -2, axis=0)          # line y+2
    rep_top = (np.roll(up, 2, 1) + np.roll(up, -2, 1)) / 2
    rep_both = rep_top / 2 + (np.roll(dn, 2, 1) + np.roll(dn, -2, 1)) / 4
    rep = np.where(r < rows - 3, rep_both, rep_top)

    out = np.where(dil & (r >= 22), np.clip(rep, 0, 65535), v)
    out = out.astype(np.uint16)
    return out.reshape(np.asarray(picture).shape)
