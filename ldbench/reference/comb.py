"""The plain reference of the NTSC chain after the decode: ld-decode's comb at
dim 3 without optical flow (`comb -d 3 -F`), its burst AGC, and the CX
expander (`cx`).

Plain PyTorch in float64 (on the card or the CPU), written from ld-decode's
description (SURVEY.md: comb-ntsc.cxx, class Comb, and cx-expander.cxx);
the JAX package served as a guide to the edge conventions.  It imports
nothing of `ld_decode_tpu_torch` or of the JAX package.  TF32 is off.

The comb of one frame e (`CombReference.frame`), from the ring (e-1, e,
e+1) of 525 x 910 .tbc frames; line 0's column 0 carries each line's
burst phase flag (16384: the line's chroma is taken as it is, else
negated) and column 1 its burst level, both written by the decode:

  * Split1D (comb-ntsc.cxx:246-288): clp0 = (x[h-2] + x[h+2]) / 2 - x[h],
    lines 44 on, columns 4-839;
  * Split3D, the K-map gate (369-412): clp2 = (prev + next) / 2 - cur;
    the motion map |prev - next| * 2 through the 17-tap fir1(16, 0.1),
    fed from column 13 and read 8 columns on (columns 5-831), the map
    itself from column 836; k2 = clamp(1 - (map - 1.25 IRE) / 5.5 IRE),
    lines 36 on, columns 4-839;
  * Split2D (294-367): clp1 from lines l-2 and l+2 with the adaptive
    similarity weights kp, kn (45-IRE range, 3x dominance, the both-zero
    fallback), lines 4-523, columns 18-839; Split3D then sets k1 = 1 - k2
    on lines 2-523 and k0 = 1 - k2 - k1 over lines 36 on, columns 4-839;
  * SplitIQ (414-483): the blend (clp2 k2 + clp1 k1 + clp0 k0) / 2,
    negated on lines without the flag, demodulated at h mod 4 with the
    other phase held from the sample before; luma is the frame itself;
  * AdjustY (735-763): YIQ read 2 samples on, the chroma taken out of the
    luma, lines 38 on, columns 2-841;
  * FilterIQ, HQ (212-243): I and Q each through the 1.3 MHz one-pole
    Butterworth, I fed at even and Q at odd columns from 4, held, written
    2 columns back, lines 44 on, columns 2-837;
  * DoYNR (523-553) at nr_y 1 IRE: the 25-tap 1.8 MHz high-pass fed from
    column 40, read 12 on, cored at +-1 IRE and taken from the luma,
    lines 38 on, columns 40-842; DoCNR at nr_c 0 does nothing;
  * ToRGB (555-598): gain 10 / the line's AGC level on the chroma, YIQ to
    RGB with I and Q swapped as the reference names them, black at 7.5
    IRE, brightness 236, clamped to 0-65535 and truncated; lines 38-517
    (480 lines), columns 78-821 (the 744-wide crop, 894-938).

The AGC (`agc`, comb-ntsc.cxx:563-564): each line from 38 on whose burst
level is over 3 IRE moves the level 1 % towards it (the first such line
of the stream seeds it); the level runs on across lines and frames from
-1 at the stream's start.

The burst words themselves (`BurstWords`, lddecode_core.py:1054-1158),
made from the decode reference's demodulation: the video through the
colour-burst band-pass; each line's 40-sample window (grid columns
20-59) by the decode's Catmull-Rom resample with its wow correction, at
the port's line locations less the colour-phase shift; the level the
window's largest distance from its mean, kept where it is at most 30 IRE
and the window's deviation at least 3 IRE; the zero crossings' two phase
groups pick which alternate lines are negated, and a line whose phase is
over 2 samples off gets level 0; the words 16384 (level over 0) or 32768
and floor(327.67 |level| / (1.45 hz_ire)).  Departure: ld-decode reads
the level at the second burst pass's input, which that pass then moves
by a few hundredths of a sample; only the moved locations are known
here, so the levels agree to about 1 % and the flags exactly.

Departures, each invisible in the 480 x 744 picture: the VBI rows that
comb-ntsc.cxx:876-882 copies up to lines 0-23 are not made (the picture
starts at line 38); line 524 is combed but never shown; the K-map's
columns 832-835, where the reference reads stack it never wrote, are 0,
as in the port and the JAX package.

The CX expander (`CXReference`, cx-expander.cxx): each channel through the
4-pole 500 Hz Butterworth high-pass (a500_48k), the larger magnitude of
the two into the fast (x 0.9998, up by 4 % of the input a sample) and slow
(x 0.999985, up by 0.2 %) followers, gain 1 + max(0, max(fast, slow) -
6500 m14) / (6500 m14) times m14 (-14 dB), the 4-pole 40 Hz high-pass
(a40h_48k), x 0.4, offset by 32768 and truncated to 16 bits; every state
carried from call to call.  The two high-passes run as
`scipy.signal.lfilter`.

`precision` 'bfloat16' is the control: the same computation with every
value rounded to bfloat16 after each step, as `reference/decode.py` does
(tensors through `decode._Precision`, the scalar recurrences by
`bf16`).
"""

from __future__ import annotations

import math
from typing import List, Tuple

import numpy as np
import scipy.signal as sps
import torch

from ldbench.reference import filters as FD
from ldbench.reference.decode import NBLOCKS, _Precision, read_samples

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

IN_Y, IN_X = 525, 910
FSC4_MHZ = 4 * 315.0 / 88.0
IRESCALE = 358.4            # comb-ntsc.cxx:60, 16-bit counts an IRE
IREBASE = 1024.0
FIRSTLINE = 38              # 480 lines out
LINESOUT = 480
CROP, WIDTH = 78, 744
FLAG = 16384                # the burst phase flag of column 0


def bf16(x: float) -> float:
    """A Python float rounded to bfloat16 (8 significant bits, to nearest,
    ties to even)."""
    if x == 0 or not math.isfinite(x):
        return x
    m, e = math.frexp(x)
    return math.ldexp(round(m * 256) / 256, e)


def _designs():
    half = FSC4_MHZ / 2
    return {
        # fir1(16, 0.1): the K-map low-pass (comb-ntsc.cxx:378-379)
        'lp3d': sps.firwin(17, 0.1, window='hamming'),
        # the luma NR high-pass (filtermaker.py nr)
        'nr': sps.firwin(25, 1.80 / half, window='hamming', pass_zero=False),
        # colorlpi, the HQ chroma low-pass for both I and Q
        'lpi': sps.butter(1, 1.3 / half, 'low'),
    }


class CombReference:
    """ld-decode's NTSC comb at dim 3 with the K-map gate (module
    docstring), on `device`, at `precision` (float64, or the bfloat16
    control)."""

    def __init__(self, device, precision: str = 'float64',
                 p_3dcore: float = 1.25, p_3drange: float = 5.5,
                 nr_y: float = 1.0, brightness: float = 236.0,
                 black_ire: float = 7.5):
        self.device = torch.device(device)
        self.q = _Precision(precision)
        self.core = p_3dcore * IRESCALE
        self.range = p_3drange * IRESCALE
        self.nr_y = nr_y * IRESCALE
        self.brightness = brightness
        self.black_ire = black_ire
        d = _designs()
        self.lp3d = [float(t) for t in d['lp3d']]
        self.nr = [float(t) for t in d['nr']]
        b, a = d['lpi']
        self.lpi = (float(b[0]), float(b[1]), float(a[1]))
        dev = self.device
        self.row = torch.arange(IN_Y, device=dev)[:, None]
        self.col = torch.arange(IN_X, device=dev)[None, :]

    # ------------------------------------------------------------ helpers

    def _put(self, frame: np.ndarray) -> torch.Tensor:
        """A frame's 16-bit samples as a (525, 910) tensor on the device
        (exact at either precision)."""
        return torch.as_tensor(np.asarray(frame, np.float64).reshape(
            IN_Y, IN_X)).to(self.device, self.q.real)

    def _area(self, r0, r1, c0, c1) -> torch.Tensor:
        """Lines r0..r1-1, columns c0..c1-1."""
        return ((self.row >= r0) & (self.row < r1)
                & (self.col >= c0) & (self.col < c1))

    @staticmethod
    def _at(x: torch.Tensor, n: int) -> torch.Tensor:
        """x[h + n] at column h, 0 past either edge."""
        out = torch.zeros_like(x)
        if n > 0:
            out[..., :-n] = x[..., n:]
        elif n < 0:
            out[..., -n:] = x[..., :n]
        else:
            out.copy_(x)
        return out

    @staticmethod
    def _line(x: torch.Tensor, n: int) -> torch.Tensor:
        """x[l + n] at line l, 0 past either edge."""
        out = torch.zeros_like(x)
        if n > 0:
            out[:-n] = x[n:]
        else:
            out[-n:] = x[:n]
        return out

    def _fir(self, x: torch.Tensor, taps: List[float], start: int
             ) -> torch.Tensor:
        """The streaming FIR of each line fed from column `start` with a
        zero state: out[h] = sum_k taps[k] x[h - k], x 0 before `start`."""
        q = self.q
        x = torch.where(self.col >= start, x, 0.0)
        out = torch.zeros_like(x)
        for k, t in enumerate(taps):
            out = q(out + q(t * self._at(x, -k)))
        return out

    def _iir1(self, x: torch.Tensor) -> torch.Tensor:
        """The one-pole low-pass along each line's samples (the last
        axis), from a zero state: y[n] = b0 x[n] + b1 x[n-1] - a1 y[n-1]."""
        q = self.q
        b0, b1, a1 = self.lpi
        y = torch.empty_like(x)
        xp = torch.zeros_like(x[..., 0])
        yp = torch.zeros_like(xp)
        for n in range(x.shape[-1]):
            xn = x[..., n]
            yp = q(q(q(b0 * xn) + q(b1 * xp)) - q(a1 * yp))
            y[..., n] = yp
            xp = xn
        return y

    # ----------------------------------------------------------------- AGC

    def agc(self, burst: np.ndarray, carry: float
            ) -> Tuple[np.ndarray, float]:
        """(each line's AGC level from line 38, as float64, the carry after
        the frame) for one frame's burst column (525 values of column 1)
        from the carry entering it."""
        rnd = bf16 if self.q.name == 'bfloat16' else float
        c = float(carry)
        out = np.empty(IN_Y - FIRSTLINE)
        for n, v in enumerate(np.asarray(burst, np.float64)[FIRSTLINE:]):
            b = rnd(float(v) / IRESCALE)
            if b > 3.0:
                if c < 0:
                    c = b
                c = rnd(rnd(c * 0.99) + rnd(b * 0.01))
            out[n] = c
        return out, c

    # ---------------------------------------------------------------- comb

    def frame(self, prev: np.ndarray, cur: np.ndarray, nxt: np.ndarray,
              levels: np.ndarray) -> np.ndarray:
        """Frame `cur` combed against `prev` and `nxt` (each 525 x 910
        16-bit samples), its lines from 38 at the AGC `levels`: the
        (480, 744, 3) uint16 RGB48 frame."""
        q = self.q
        raw, pv, nx = self._put(cur), self._put(prev), self._put(nxt)
        flagged = (raw[:, 0] == FLAG)[:, None]
        at, area = self._at, self._area

        # Split1D
        clp0 = q(q(q(at(raw, -2) + at(raw, 2)) / 2) - raw)
        clp0 = torch.where(area(44, IN_Y, 4, 840), clp0, 0.0)

        # Split3D: the temporal estimate and the K-map gate
        blend_area = area(36, IN_Y, 4, 840)
        clp2 = torch.where(blend_area, q(q(q(pv + nx) / 2) - raw), 0.0)
        k2 = self._gate(pv, nx)

        # Split2D
        clp1 = self._split2d(clp0)
        k1 = torch.where(area(2, 524, 0, IN_X) & blend_area, q(1 - k2), 0.0)
        k0 = torch.where(blend_area, q(q(1 - k2) - k1), 0.0)

        # SplitIQ
        cavg = q(q(q(q(clp2 * k2) + q(clp1 * k1)) + q(clp0 * k0)) / 2)
        cavg = torch.where(flagged, cavg, -cavg)
        phase = self.col % 4
        before = at(cavg, -1)
        i = torch.where(phase == 0, cavg, torch.where(
            phase == 1, before, torch.where(phase == 2, -cavg, -before)))
        qq = torch.where(phase == 0, before, torch.where(
            phase == 1, -cavg, torch.where(phase == 2, -before, cavg)))
        y = torch.where(blend_area, raw, 0.0)
        i = torch.where(blend_area, i, 0.0)
        qq = torch.where(blend_area, qq, 0.0)

        # AdjustY
        y2, i2, q2 = at(y, 2), at(i, 2), at(qq, 2)
        comp = torch.where(phase == 0, i2, torch.where(
            phase == 1, -q2, torch.where(phase == 2, -i2, q2)))
        comp = torch.where(flagged, -comp, comp)
        adj = area(FIRSTLINE, IN_Y, 2, 842)
        y = torch.where(adj, q(y2 + comp), y)
        i = torch.where(adj, i2, i)
        qq = torch.where(adj, q2, qq)

        # FilterIQ (HQ): I at even columns from 4, Q at odd from 5
        fi = self._iir1(torch.where(self.col < 840, i, 0.0)[:, 4:840:2])
        fq = self._iir1(torch.where(self.col < 840, qq, 0.0)[:, 5:840:2])
        held_i = torch.zeros_like(i)
        held_q = torch.zeros_like(qq)
        held_i[:, 2:838] = fi.repeat_interleave(2, dim=-1)[:, :836]
        held_q[:, 3:838] = fq.repeat_interleave(2, dim=-1)[:, :835]
        lpf = area(44, IN_Y, 2, 838)
        i = torch.where(lpf, held_i, i)
        qq = torch.where(lpf, held_q, qq)

        # DoYNR
        hp = self._fir(y, self.nr, 40)
        core = torch.clamp(at(hp, 12), -self.nr_y, self.nr_y)
        y = torch.where(area(FIRSTLINE, IN_Y, 40, 843), q(y - core), y)

        return self._to_rgb(y, i, qq, levels)

    def gate(self, prev: np.ndarray, nxt: np.ndarray) -> np.ndarray:
        """The K-map weight k2 of the temporal estimate (1 still, 0
        moving) between a frame's neighbours, (525, 910) float64."""
        return self._gate(self._put(prev), self._put(nxt)
                          ).double().cpu().numpy()

    def _gate(self, pv: torch.Tensor, nx: torch.Tensor) -> torch.Tensor:
        q = self.q
        motion = q(q(pv - nx).abs() * 2)
        lp = self._fir(motion, self.lp3d, 13)
        kmap = torch.zeros_like(motion)
        kmap[:, 5:832] = lp[:, 13:840]
        kmap[:, 836:] = motion[:, 836:]
        k2 = torch.clamp(q(1 - q(q(kmap - self.core) / self.range)), 0, 1)
        return torch.where(self._area(36, IN_Y, 4, 840), k2, 0.0)

    def _split2d(self, clp0: torch.Tensor) -> torch.Tensor:
        """The adaptive 2D estimate clp1 (comb-ntsc.cxx:294-367)."""
        q, at = self.q, self._at
        p1, n1, c1 = self._line(clp0, -2), self._line(clp0, 2), clp0
        ac, ap, an = c1.abs(), p1.abs(), n1.abs()
        acm1, apm1, anm1 = at(ac, -1), at(ap, -1), at(an, -1)
        kp = q(q(q(ac - ap).abs() + q(acm1 - apm1).abs())
               - q(q(ac + acm1) * 0.1))
        # the kn term pairs c1[h] with n1[h-1] (comb-ntsc.cxx:318)
        kn = q(q(q(ac - an).abs() + q(acm1 - anm1).abs())
               - q(q(ac + anm1) * 0.1))
        rng = 45 * IRESCALE
        kp = torch.clamp(q(1 - q(q(kp / 2) / rng)), 0, 1)
        kn = torch.clamp(q(1 - q(q(kn / 2) / rng)), 0, 1)
        both_zero = (kp == 0) & (kn == 0)
        kp2 = torch.where(kn > q(3 * kp), 0.0, kp)
        kn2 = torch.where(kp > q(3 * kn), 0.0, kn)
        denom = q(kn2 + kp2)
        sc = torch.where(denom > 0, q(2.0 / torch.where(denom > 0, denom,
                                                          1.0)), 1.0)
        sc = torch.clamp(sc, min=1.0)
        fallback = (q(q(ap - an).abs() - q(q(n1 + p1) * 0.2).abs()) <= 0
                    ).to(clp0.dtype)
        kp2 = torch.where(both_zero, fallback, kp2)
        kn2 = torch.where(both_zero, fallback, kn2)
        sc = torch.where(both_zero, 1.0, sc)
        tc1 = q(q(q(q(q(c1 - p1) * kp2) * sc) + q(q(q(c1 - n1) * kn2) * sc))
                / 4.0)
        return torch.where(self._area(4, 524, 18, 840), tc1, 0.0)

    def _to_rgb(self, y, i, qq, levels) -> np.ndarray:
        q = self.q
        rows = slice(FIRSTLINE, FIRSTLINE + LINESOUT)
        gain = q(10.0 / torch.as_tensor(np.asarray(levels, np.float64)[
            :LINESOUT]).to(self.device, self.q.real))[:, None]
        yv, iv, qv = y[rows], q(i[rows] * gain), q(qq[rows] * gain)
        ire = torch.where(yv == 0, -100.0,
                          q(-40.0 + q(q(yv - IREBASE) / IRESCALE)))
        y2 = q(q(ire - self.black_ire) * (100.0 / (100.0 - self.black_ire)))
        # ToRGB's I is the Q demodulated above, and its Q the I
        # (comb-ntsc.cxx:135-136)
        qi, ii = q(iv / IRESCALE), q(qv / IRESCALE)
        r = q(q(y2 + q(0.956 * ii)) + q(0.621 * qi))
        g = q(q(y2 - q(0.272 * ii)) - q(0.647 * qi))
        b = q(q(y2 - q(1.106 * ii)) + q(1.703 * qi))
        m = self.brightness * 256 / 100
        rgb = q(torch.stack([r, g, b], dim=-1) * m)
        rgb = torch.floor(torch.clamp(rgb, 0, 65535))[:, CROP:CROP + WIDTH]
        return rgb.cpu().numpy().astype(np.uint16)


class BurstWords:
    """The burst words that the NTSC decode writes into columns 0 and 1 of
    a field's rows (module docstring), made again in float64 from the
    reference decode's demodulation (`reference/decode.py::Reference`) at
    the port's line locations."""

    COLORPHASE = 90 + 1.5       # ld-decode's colour-phase shift, degrees
    COLORLEVEL = 1.45           # and its colour level

    def __init__(self, ref):
        self.ref = ref
        cfg = ref.cfg
        self.f_burst = torch.as_tensor(np.asarray(
            FD.design_video_filters(cfg).f_video_burst,
            np.complex128)).to(ref.device)
        self.px_per_phase = cfg.freq_mhz / FSC4_MHZ
        self.hz_ire = 1700000 / 140

    def tap(self, src, readsample: int) -> torch.Tensor:
        """The demodulated video of a field's decode window through the
        colour-burst band-pass (ld-decode's demod_burst), float64, in the
        coordinates of the reference's video."""
        ref, cfg = self.ref, self.ref.cfg
        n, keep, cut = cfg.blocklen, cfg.block_keep, cfg.blockcut
        x = torch.as_tensor(read_samples(src, readsample - cut,
                                         ref.stream_len).astype(np.float64))
        blocks = x.to(ref.device).unfold(0, n, keep)[:NBLOCKS]
        w = ref.rf_video * ref.mtf ** ref.mtf_level
        z = torch.fft.ifft(torch.fft.fft(blocks) * w)
        dphi = torch.remainder(torch.angle(z[..., 1:]
                                           * torch.conj(z[..., :-1])),
                               2 * np.pi)
        hz = torch.nn.functional.pad(dphi, (1, 0)) * (cfg.freq_hz
                                                      / (2 * np.pi))
        burst = torch.fft.ifft(torch.fft.fft(hz) * self.f_burst).real
        return burst[:, cut:cut + keep].reshape(-1)

    def _windows(self, tap: torch.Tensor, ll: np.ndarray,
                 linecount: int) -> torch.Tensor:
        """Each line's 40-sample burst window, grid columns 20-59, by the
        decode's Catmull-Rom resample with its wow correction:
        (linecount, 40)."""
        cfg = self.ref.cfg
        W = cfg.sys.outlinelen
        ll = torch.as_tensor(ll[:linecount + 1], dtype=torch.float64,
                             device=tap.device)
        step = ll[1:] - ll[:-1]
        k = torch.arange(20, 60, dtype=torch.float64, device=tap.device)
        pos = (ll[:-1, None] + k[None, :] * (step[:, None] / W)).clamp(
            1.0, tap.shape[0] - 3.0)
        i0 = torch.floor(pos)
        t = pos - i0
        i0 = i0.long()
        t2, t3 = t * t, t * t * t
        wts = (-0.5 * t3 + t2 - 0.5 * t, 1.5 * t3 - 2.5 * t2 + 1.0,
               -1.5 * t3 + 2.0 * t2 + 0.5 * t, 0.5 * t3 - 0.5 * t2)
        out = sum(wt * tap[i0 + d] for wt, d in zip(wts, (-1, 0, 1, 2)))
        return out * (step / float(cfg.linelen))[:, None]

    def levels(self, tap: torch.Tensor, linelocs: np.ndarray,
               linecount: int) -> np.ndarray:
        """Each line's signed burst level, the second burst pass's
        (lddecode_core.py:1054-1133): the level is the window's largest
        distance from its mean, 0 where the burst is out of range; its sign
        is the line's phase group; 0 where the phase is over 2 samples off.

        The port's final locations carry the colour-phase shift, which is
        taken off again; the pass measured the burst before its own
        correction of those locations, a few hundredths of a sample, which
        this leaves in (the level of a burst peak moves by its square)."""
        ll = np.asarray(linelocs, np.float64) - (
            self.COLORPHASE * np.pi / 180 - 8) * self.px_per_phase
        ba = self._windows(tap, ll, linecount)
        ba = ba - ba.mean(dim=-1, keepdim=True)
        level = ba.abs().amax(dim=-1)
        std = torch.sqrt((ba ** 2).mean(dim=-1))
        level_ok = ((level / self.hz_ire) <= 30) & ((std / self.hz_ire) >= 3)

        a, b = ba[:, :-1], ba[:, 1:]
        prev = torch.nn.functional.pad(ba.abs(), (1, 0))[:, :a.shape[1]]
        crossing = ((a * b) < 0) & (torch.maximum(a.abs(), prev)
                                    > 0.6 * level[:, None])
        zc = torch.arange(a.shape[1], dtype=ba.dtype,
                          device=ba.device) + a / (a - b).where(
                              a != b, torch.ones_like(a))
        offset = zc - (torch.floor(zc / 4) * 4 - 1)
        offset = torch.where(offset > 3.5, offset - 4, offset)

        def group(mask):
            mask = crossing & mask
            csum = torch.cumsum(mask.long(), dim=-1)
            keep = mask & (csum > 1) & (csum < csum[:, -1:])
            mean = torch.where(keep, offset, 0.0).sum(dim=-1) \
                / keep.sum(dim=-1).clamp(min=1)
            return mean, mask.sum(dim=-1)

        fall, n_fall = group(a > 0)
        rise, n_rise = group(a <= 0)
        odd = (torch.arange(linecount, device=ba.device) % 2) == 1
        ph = torch.stack([torch.where(odd, 2.0 - rise, 2.0 - fall),
                          torch.where(odd, 2.0 - fall, 2.0 - rise)], -1)
        ok = level_ok & (n_fall >= 3) & (n_rise >= 3)
        ph = torch.where(ok[:, None], ph, 0.0).cpu().numpy()
        bl = torch.where(level_ok, level, 0.0).cpu().numpy()
        cut = ph[(ph[:, 0] != 0) | (ph[:, 1] != 0)]
        if len(cut) == 0:
            return bl
        pg = 0 if abs(np.median(cut[:, 0])) < abs(np.median(cut[:, 1])) \
            else 1
        bl[pg::2] = -bl[pg::2]
        bl[np.abs(ph[:, pg]) > 2] = 0.0
        return bl

    def words(self, levels: np.ndarray) -> np.ndarray:
        """Columns 0 and 1 of a field's rows 1 to linecount - 2 from its
        signed burst levels (lddecode_core.py:1135-1158): (rows, 2)
        float64, the flag 16384 where the level is over 0, else 32768, and
        the level's 16-bit word."""
        clevel = (1 / self.COLORLEVEL) / self.hz_ire
        bl = levels[1:-1]
        return np.stack([np.where(bl > 0, float(FLAG), 32768.0),
                         np.floor(327.67 * clevel * np.abs(bl))], -1)


class CXReference:
    """ld-decode's CX expander (module docstring) with its state carried
    from call to call, at `precision`."""

    M14DB = 10 ** (-14 / 20)
    FACTOR = 6500.0

    def __init__(self, precision: str = 'float64'):
        self.precision = precision
        self.hp500 = sps.butter(4, 500.0 / 24000.0, btype='highpass')
        self.hp40 = sps.butter(4, 40.0 / 24000.0, btype='highpass')
        self.z500 = [np.zeros(4), np.zeros(4)]
        self.z40 = [np.zeros(4), np.zeros(4)]
        self.fast = 0.0
        self.slow = 0.0

    def _r(self, x: np.ndarray) -> np.ndarray:
        if self.precision == 'float64':
            return x
        return torch.from_numpy(np.asarray(x, np.float32)).to(
            torch.bfloat16).to(torch.float32).double().numpy()

    def _filter(self, ba, x, zi):
        if self.precision == 'float64':
            return sps.lfilter(*ba, x, zi=zi)
        y, z = sps.lfilter(*ba, np.asarray(x, np.float32),
                           zi=np.asarray(zi, np.float32))
        return self._r(y), z

    def process(self, pcm: np.ndarray) -> np.ndarray:
        """Interleaved int16 stereo in, interleaved uint16 (offset 32768)
        out, of the same length."""
        r = self._r
        x = np.asarray(pcm).astype(np.float64)
        chans = [x[0::2], x[1::2]]
        hp = []
        for c in range(2):
            y, self.z500[c] = self._filter(self.hp500, chans[c], self.z500[c])
            hp.append(y)
        env = r(np.maximum(np.abs(hp[0]), np.abs(hp[1])))
        gain = np.empty(len(env))
        rnd = bf16 if self.precision == 'bfloat16' else float
        pivot = self.FACTOR * self.M14DB
        fast, slow = self.fast, self.slow
        for n, m in enumerate(env.tolist()):
            fast = rnd(fast * 0.9998)
            if m > fast:
                fast = min(m, rnd(fast + rnd(m * 0.040)))
            slow = rnd(slow * 0.999985)
            if m > slow:
                slow = min(m, rnd(slow + rnd(m * 0.0020)))
            val = max(rnd(max(fast, slow) - pivot), 0.0)
            gain[n] = rnd(self.M14DB * rnd(1.0 + rnd(val / pivot)))
        self.fast, self.slow = fast, slow
        out = np.empty(len(x))
        for c in range(2):
            y, self.z40[c] = self._filter(self.hp40, r(chans[c] * gain),
                                          self.z40[c])
            out[c::2] = r(y * 0.4)
        return np.floor(np.clip(out + 32768.0, 0, 65535)).astype(np.uint16)

