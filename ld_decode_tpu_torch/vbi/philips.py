"""VBI Philips-code (IEC 60857) slicing and interpretation (torch port of
ld_decode_tpu/vbi/philips.py).

The slicer walks 50-IRE crossings at ~2 us spacing across a VBI line and
packs 24 Manchester-coded bits into six nibbles (reference
lddecode_core.py:814-834); interpretation covers CAV picture numbers, CLV
timecodes and status codes (lddecode_core.py:836-884).  The host slicer
and interpreter are the JAX package's numpy code, copied (the port imports
nothing of the JAX package); `slice_philips_dev` is the device slicer,
batched over windows.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from ld_decode_tpu_torch.utils.params import DecoderConfig


def calczc_host(data: np.ndarray, start: float, target: float,
                count: float) -> Optional[float]:
    """Sub-sample zero-crossing search (reference lddutils.py:265-303)."""
    s = int(start)
    c = int(count) + 1
    if s < 0 or s >= len(data):
        return None
    seg = data[s:s + c]
    if len(seg) == 0:
        return None
    if seg[0] < target:
        locs = np.nonzero(seg >= target)[0]
    else:
        locs = np.nonzero(seg <= target)[0]
    if len(locs) == 0:
        return None
    x = s + int(locs[0])
    if x == 0:
        return None
    a = data[x - 1] - target
    b = data[x] - target
    den = (-a + b)
    y = -a / den if den != 0 else 0.0
    return x - 1 + y


def decode_philips_line(data, linestart: float,
                        cfg: DecoderConfig) -> Optional[List[int]]:
    """Slice one VBI line window (host array) into six nibbles, or None."""
    usec = cfg.freq_mhz
    w0 = int(linestart)
    w1 = min(w0 + cfg.linelen + int(16 * usec), data.shape[0])
    if w0 < 0 or w1 - w0 < cfg.linelen // 2:
        return None
    win = np.asarray(data[w0:w1], dtype=np.float64)
    ire50 = cfg.iretohz(50)

    rel0 = linestart - w0
    curzc = calczc_host(win, rel0 + 2 * usec, ire50, 12 * usec)
    zcs = []
    while curzc is not None:
        before = int(curzc - 0.5 * usec)
        bit = bool(win[before] < ire50) if 0 <= before < len(win) else False
        zcs.append((curzc, bit))
        curzc = calczc_host(win, curzc + 1.9 * usec, ire50, 0.2 * usec)

    if len(zcs) != 24:
        return None
    gaps = np.diff([z[0] for z in zcs]) / usec
    if gaps.min() <= 1.85 or gaps.max() >= 2.15:
        return None

    bits = [z[1] for z in zcs]
    nibbles = []
    for b in range(0, 24, 4):
        n = (bits[b] << 3) | (bits[b + 1] << 2) | (bits[b + 2] << 1) \
            | bits[b + 3]
        nibbles.append(n)
    return nibbles


def interpret_philips(linecode: Dict[int, Optional[List[int]]]) -> dict:
    """Merge the per-line codes into the field VBI record."""
    vbi = {
        'minutes': None, 'seconds': None, 'clvframe': None, 'framenr': None,
        'statuscode': None, 'status': None, 'isclv': False,
    }
    for l, lc in linecode.items():
        if lc is None:
            continue
        if lc[0] == 15 and lc[2] == 13:          # CLV timecode (hours/min)
            vbi['minutes'] = 60 * lc[1] + lc[4] * 10 + lc[5]
            vbi['isclv'] = True
        elif lc[0] == 15:                        # CAV picture number
            vbi['framenr'] = ((lc[1] & 7) * 10000 + lc[2] * 1000
                              + lc[3] * 100 + lc[4] * 10 + lc[5])
        else:
            h = 0
            for nib in lc:
                h = (h << 4) | nib
            if lc[2] == 0xE:                     # CLV seconds/frame
                vbi['seconds'] = (lc[1] - 10) * 10 + lc[3]
                vbi['clvframe'] = lc[4] * 10 + lc[5]
                vbi['isclv'] = True
            htop = h >> 12
            if htop in (0x8dc, 0x8ba):           # programme status code
                vbi['status'] = h
            if h == 0x87ffff:
                vbi['isclv'] = True
    return vbi


def slice_philips_dev(win: torch.Tensor, rel0: torch.Tensor, usec: float,
                      ire50: float):
    """Slice M VBI line windows into six nibbles each, on the device.

    win: (M, W) float demod windows starting at each line anchor; rel0:
    (M,) line-start fractions.  Returns (nibbles (M, 6) int32, ok (M,)
    bool) with the host slicer's exact semantics: 24 crossings walked at
    ~2 us spacing, per-crossing bit from the sample 0.5 us before, and the
    1.85..2.15 us gap gate.  The 25-step walk is a loop over steps,
    vectorized over the M windows."""
    M, W = win.shape
    dev = win.device
    rows = torch.arange(M, device=dev)

    def at(x):
        return win[rows, x.long()]

    def calczc(start, span_i, count_c):
        """(zc, found): first 50-IRE crossing in win[s : s+count+1]."""
        s = start.to(torch.int32)             # host int() truncation
        inb = (s >= 0) & (s < W)
        sc = s.clamp(0, W - 1)
        # the window start clamps at W-span_i near the end, so address the
        # segment by its true sample index s0+k
        s0 = sc.clamp(0, max(W - span_i, 0))
        k = torch.arange(span_i, device=dev, dtype=torch.int32)
        idx = s0[:, None] + k
        seg = win.gather(1, idx.long())
        rising = at(sc) < ire50
        cond = torch.where(rising[:, None], seg >= ire50, seg <= ire50)
        cond = cond & (idx >= sc[:, None]) & (idx - sc[:, None] < count_c) \
            & (idx < W)
        found = cond.any(dim=-1) & inb
        fidx = torch.argmax(cond.to(torch.uint8), dim=-1).to(torch.int32)
        x = s0 + fidx
        found = found & (x > 0)
        xm = x.clamp(1, W - 1)
        a = at(xm - 1) - ire50
        b = at(xm) - ire50
        den = b - a
        y = torch.where(den != 0,
                        -a / torch.where(den == 0, torch.ones_like(den), den),
                        0.0)
        return (x - 1).to(win.dtype) + y, found

    span0 = int(12 * usec) + 2
    spann = int(0.2 * usec) + 2

    zc, active = calczc(rel0 + 2 * usec, span0, int(12 * usec) + 1)
    zcs = [zc]
    acts = [active]
    for _ in range(24):                        # 23 more + the overrun probe
        zc2, f2 = calczc(zcs[-1] + 1.9 * usec, spann, int(0.2 * usec) + 1)
        nxt_active = acts[-1] & f2
        zcs.append(torch.where(nxt_active, zc2, zcs[-1]))
        acts.append(nxt_active)

    nfound = torch.stack(acts, dim=-1).to(torch.int32).sum(dim=-1)
    ok = nfound == 24                          # exactly 24 (25th must fail)

    z = torch.stack(zcs[:24], dim=-1)          # (M, 24)
    gaps = (z[:, 1:] - z[:, :-1]) / usec
    ok = ok & (gaps.amin(dim=-1) > 1.85) & (gaps.amax(dim=-1) < 2.15)

    before = (z - 0.5 * usec).to(torch.int32)
    binb = (before >= 0) & (before < W)
    vals = win.gather(1, before.clamp(0, W - 1).long())
    bits = binb & (vals < ire50)

    shifts = 3 - torch.arange(4, device=dev, dtype=torch.int32)
    nibbles = (bits.reshape(M, 6, 4).to(torch.int32) << shifts).sum(
        dim=-1, dtype=torch.int32)
    return nibbles, ok
