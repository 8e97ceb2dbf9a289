"""NTSC comb-filter chroma decoder (1D/2D/3D), torch port of
ld_decode_tpu/comb/comb_ntsc.py.

Whole-frame stencil passes over (525, 910) TBC frames (reference
comb-ntsc.cxx, class Comb).  Every op takes leading batch dimensions: a
window's frames are combed in one pass.  Frames come in as integer tensors
holding 16-bit samples (int32 on the device); RGB48 goes out as int32
values 0..65535, made np.uint16 on the host.

What changed in the port, each held to JAX by tests/test_torch_comb.py:
  * `_causal_fir` (jnp.convolve, a convolution) is F.conv1d (a
    correlation) with the taps flipped, in full float32;
  * `_iir1_scan` (an associative scan) is one float32 matmul by the
    lower-triangular Toeplitz matrix of the pole's powers;
  * the burst-AGC EMA (a lax.scan over lines inside to_rgb) is
    `agc_levels`, a float32 host loop over the burst column of a window's
    frames, computed before the comb; `to_rgb` takes its levels.

`NTSCComb` is the frame-at-a-time comb (the reference's `Comb::Process`,
what ldexport and ldview run): the 3-frame ring, the flow carry, the AGC
carry (one small device-to-host copy of the burst column a frame), the
line-0 words of the emitted frame, and the debug surfaces -D
(`debug2d_stats`), -k and -l, which only it serves: the batched comb
(comb/batch.py) refuses them, as the JAX package's does.  Its flow runs
both fields of a frame through one batched Farnebäck call
(`farneback_combk2`), or through OpenCV on the host with
optflow_engine='cv2' (a parity oracle).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import scipy.signal as sps
import torch
import torch.nn.functional as F

from ld_decode_tpu_torch.comb.optflow import calc_optical_flow_farneback
from ld_decode_tpu_torch.utils.device import DEFAULT as DEFAULT_DEVICE
from ld_decode_tpu_torch.utils.device import constant
from ld_decode_tpu_torch.utils.device import resolve as resolve_device

IN_Y, IN_X = 525, 910
FREQ4 = 4 * 315.0 / 88.0
IRESCALE = 358.4          # comb-ntsc.cxx:60
IREBASE = 0x400

# frame line-0 flag word bits read by the pulldown assembler (reference
# ld-decoder.h:246-252)
FRAME_INFO_CAV_EVEN = 0x4
FRAME_INFO_CAV_ODD = 0x8
FRAME_INFO_WHITE_ODD = 0x100
FRAME_INFO_WHITE_EVEN = 0x200


@dataclass(frozen=True)
class CombConfig:
    dim: int = 2
    bw: bool = False
    colorlpf: bool = True
    colorlpf_hq: bool = True
    adaptive2d: bool = True
    phase_invert: bool = False
    nr_y: float = 1.0          # IRE (scaled by irescale like the reference)
    nr_c: float = 0.0
    brightness: float = 236.0
    black_ire: float = 7.5
    p_3dcore: float = 1.25     # no-opticalflow defaults (comb-ntsc.cxx:1078)
    p_3drange: float = 5.5
    # optical-flow gate thresholds, in FLOW PIXELS, not IRE
    # (comb-ntsc.cxx:1074-1076: core 0.0, range 0.5 when f_opticalflow)
    of_3dcore: float = 0.0
    of_3drange: float = 0.5
    wide: bool = False
    linesout: int = 480
    opticalflow: bool = True   # dim 3: Farneback flow gating (reference
                               # default; False = the K-map `-F` path)
    debug2d: bool = False      # -D: replace chroma with the 2D-3D estimate
                               # difference over 50-IRE gray and report
                               # per-line/total MSE+ME (comb-ntsc.cxx:440-482)
    showk: bool = False        # -k: render combk[dim-1] as grayscale
                               # (comb-ntsc.cxx:575-579)
    debugline: int = -10000    # -l: expose + black out line debugline+25
                               # (comb-ntsc.cxx:581-591)
    optflow_engine: str = 'native'  # 'native' = the port's Farneback
                                    # (comb/optflow.py); 'cv2' = OpenCV on
                                    # the host, a parity oracle

    @property
    def firstline(self) -> int:
        return 20 if self.linesout == IN_Y else 38

    @property
    def has_debug(self) -> bool:
        """-D, -k or -l: the streaming NTSCComb's debug surfaces."""
        return self.debug2d or self.showk or self.debugline > -9999


def _filters():
    """Comb-side filter kernels (designs from reference filtermaker.py)."""
    freq = FREQ4
    nr_b = sps.firwin(25, 1.80 / (freq / 2.0), window='hamming',
                      pass_zero=False)
    nrc_b = sps.firwin(17, 0.4 / (freq / 2.0), window='hamming',
                       pass_zero=False)
    lpi_b, lpi_a = sps.butter(1, 1.3 / (freq / 2), 'low')
    lpq_b, lpq_a = sps.butter(1, 0.6 / (freq / 2), 'low')
    # a = fir1(16, 0.1) (comb-ntsc.cxx:378-379)
    lp3d_b = sps.firwin(17, 0.1, window='hamming')
    return {
        'nr': np.asarray(nr_b), 'nrc': np.asarray(nrc_b),
        'lpi': (np.asarray(lpi_b), np.asarray(lpi_a)),
        'lpq': (np.asarray(lpq_b), np.asarray(lpq_a)),
        'lp3d': np.asarray(lp3d_b),
    }


FILTERS = _filters()


def _row_mask(lo, hi, dev):
    r = torch.arange(IN_Y, device=dev)[:, None]
    return (r >= lo) & (r < hi)


def _col_mask(lo, hi, dev):
    c = torch.arange(IN_X, device=dev)[None, :]
    return (c >= lo) & (c < hi)


def _shift_right(x, n=1):
    """x[..., h-n] with zeros shifted in (jnp.pad((n, 0))[..., :-n])."""
    return F.pad(x, (n, 0))[..., :-n]


def _shift_left(x, n):
    """x[..., h+n] with zeros shifted in (jnp.pad((0, n))[..., n:])."""
    return F.pad(x, (0, n))[..., n:]


def _causal_fir(x: torch.Tensor, b: np.ndarray, start: int) -> torch.Tensor:
    """Per-row streaming FIR like the reference's Filter::feed, fed from
    column `start` with zeroed initial state: out[h] = sum_k b[k]*x[h-k]
    with x treated as 0 before `start`.  F.conv1d correlates, so the taps
    are flipped; float32 throughout (TF32 is off package-wide)."""
    xm = torch.where(_col_mask(start, IN_X, x.device), x, 0.0)
    nb = len(b)
    w = constant(b[::-1], x.dtype, x.device).reshape(1, 1, nb)
    rows = F.pad(xm.reshape(-1, 1, IN_X), (nb - 1, 0))
    return F.conv1d(rows, w).reshape(x.shape)


@functools.lru_cache(maxsize=None)
def _pole_powers(n: int, pole: float, device: str) -> torch.Tensor:
    """T[k, m] = pole**(m-k) for m >= k, else 0: (n, n) float32."""
    e = np.arange(n)[None, :] - np.arange(n)[:, None]
    t = np.where(e >= 0, float(pole) ** np.maximum(e, 0), 0.0)
    return torch.from_numpy(t.astype(np.float32)).to(device)


def _iir1_scan(x: torch.Tensor, b: np.ndarray, a: np.ndarray) -> torch.Tensor:
    """First-order IIR y[n] = b0 x[n] + b1 x[n-1] - a1 y[n-1] along the last
    axis (state starts at zero): y = c @ T with c = b0 x + b1 x[n-1] and T
    the Toeplitz matrix of the pole's powers.  |pole| < 0.8 for the comb's
    filters, so powers below float32 resolution (after ~80 taps) vanish."""
    b0, b1 = float(b[0]), float(b[1])
    a1 = float(a[1])
    c = b0 * x + b1 * _shift_right(x)
    return c @ _pole_powers(x.shape[-1], -a1, str(x.device))


def split1d(raw: torch.Tensor) -> torch.Tensor:
    """(comb-ntsc.cxx:246-288); the un-filtered tc1 path used by dim>=2.
    The phase-invert sign cancels for this path."""
    rp = F.pad(raw, (2, 2))
    tc1 = ((rp[..., 4:] + rp[..., :-4]) / 2) - raw
    mask = _row_mask(44, IN_Y, raw.device) & _col_mask(4, 840, raw.device)
    return torch.where(mask, tc1, 0.0)


def _phase_sign(dev):
    phase = torch.arange(IN_X, device=dev)[None, :] % 4
    return torch.where((phase == 0) | (phase == 3), 1.0, -1.0)


def split1d_filtered(raw: torch.Tensor, plain: torch.Tensor,
                     invert_col: torch.Tensor) -> torch.Tensor:
    """dim-1 variant: the line-local chroma is phase-demodulated through the
    one-pole color LPFs and re-modulated, written 16 samples earlier
    (comb-ntsc.cxx:254-279, f_toffset=16); columns 824..839 keep the plain
    value (never overwritten by the h-16 store)."""
    dev = raw.device
    rp = F.pad(raw, (2, 2))
    tc1 = ((rp[..., 4:] + rp[..., :-4]) / 2) - raw
    tc1 = torch.where(invert_col[..., None], tc1, -tc1)

    sign = _phase_sign(dev)
    fed = tc1 * sign                       # tsi at even h, tsq at odd h
    fed = torch.where(_col_mask(4, 840, dev), fed, 0.0)

    bi, ai = FILTERS['lpi']
    bq, aq = FILTERS['lpq']
    fi = _iir1_scan(fed[..., 4::2], bi, ai)
    fq = _iir1_scan(fed[..., 5::2], bq, aq)

    # interleave back: filtered value at each h (fresh at its own phase)
    full = torch.zeros_like(raw)
    full[..., 4::2] = fi
    full[..., 5::2] = fq
    tc1f = full * sign
    tc1f = torch.where(invert_col[..., None], tc1f, -tc1f)

    # written at h-16 for h in 4..839
    out = _shift_left(tc1f, 16)
    mask = _row_mask(44, IN_Y, dev) & _col_mask(4, 824, dev)
    return torch.where(mask, out, plain)


def split2d(clp0: torch.Tensor, combk2: torch.Tensor, adaptive: bool
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(comb-ntsc.cxx:294-367).  Returns (clp1, combk1, combk0)."""
    dev = clp0.device
    z2 = torch.zeros_like(clp0[..., :2, :])
    p1 = torch.cat([z2, clp0[..., :-2, :]], dim=-2)
    n1 = torch.cat([clp0[..., 2:, :], z2], dim=-2)
    c1 = clp0

    ac, ap, an = c1.abs(), p1.abs(), n1.abs()
    acm1 = _shift_right(ac)
    apm1 = _shift_right(ap)
    anm1 = _shift_right(an)

    kp = (ac - ap).abs() + (acm1 - apm1).abs() - (ac + acm1) * .10
    # the reference's kn term mixes c1[h] with n1[h-1] (comb-ntsc.cxx:318)
    kn = (ac - an).abs() + (acm1 - anm1).abs() - (ac + anm1) * .10
    kp = kp / 2
    kn = kn / 2

    p_2drange = 45 * IRESCALE
    kp = torch.clamp(1 - (kp / p_2drange), 0, 1)
    kn = torch.clamp(1 - (kn / p_2drange), 0, 1)
    if not adaptive:
        kp = torch.ones_like(kp)
        kn = torch.ones_like(kn)

    both_zero = (kp == 0) & (kn == 0)
    kp2 = torch.where((kn > 3 * kp), 0.0, kp)
    kn2 = torch.where((kp > 3 * kn), 0.0, kn)
    denom = kn2 + kp2
    sc = torch.where(denom > 0,
                     2.0 / torch.where(denom > 0, denom, 1.0), 1.0)
    sc = torch.clamp(sc, min=1.0)
    # both-zero fallback (comb-ntsc.cxx:337-341)
    fb = ((ap - an).abs() - ((n1 + p1) * .2).abs()) <= 0
    fbv = torch.where(fb, 1.0, 0.0)
    kp2 = torch.where(both_zero, fbv, kp2)
    kn2 = torch.where(both_zero, fbv, kn2)
    sc = torch.where(both_zero, 1.0, sc)

    tc1 = ((c1 - p1) * kp2 * sc + (c1 - n1) * kn2 * sc) / 4.0

    inner = _row_mask(4, 524, dev) & _col_mask(18, 840, dev)
    clp1 = torch.where(inner, tc1, 0.0)
    combk1 = torch.where(inner, 1.0, 0.0).expand_as(clp0)

    outer = _row_mask(36, IN_Y, dev) & _col_mask(4, 840, dev)
    k2mask = _row_mask(2, 524, dev)            # 2 <= l <= 523
    combk1 = torch.where(outer & k2mask, combk1 * (1 - combk2), combk1)
    combk0 = torch.where(outer, 1.0 - combk2 - combk1, 0.0)
    # rows 44..IN_Y outside `outer` columns keep k0=1 from split1d; the
    # reference only updates combk0 inside the h 4..840 loop
    base0 = torch.where(_row_mask(44, IN_Y, dev) & _col_mask(4, 840, dev),
                        1.0, 0.0)
    combk0 = torch.where(outer, combk0, base0)
    return clp1, combk1, combk0


def split3d_optflow(raw: torch.Tensor, prev_raw: torch.Tensor,
                    combk2_in: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Temporal chroma for the optical-flow mode: clp2 = prev - cur with the
    externally computed flow confidence map (comb-ntsc.cxx:394-395,
    600-662)."""
    clp2 = prev_raw - raw
    mask = _row_mask(36, IN_Y, raw.device) & _col_mask(4, 840, raw.device)
    return torch.where(mask, clp2, 0.0), torch.where(mask, combk2_in, 0.0)


def split3d(raw: torch.Tensor, prev_raw: torch.Tensor,
            next_raw: torch.Tensor, cfg: CombConfig
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Temporal chroma + K-map motion gate, no-opticalflow path
    (comb-ntsc.cxx:369-412 with opt_flow=False).  Returns (clp2, combk2)."""
    dev = raw.device
    clp2 = ((prev_raw + next_raw) / 2.0) - raw

    __k = (prev_raw - next_raw).abs() * 2.0
    lp = _causal_fir(__k, FILTERS['lp3d'], 13)   # fed only for h>12
    # _k[h-8] = lp(h) for h in 13..839; _k[h] = __k[h] for h >= 836;
    # elsewhere the reference reads uninitialized stack (UB) -- 0 here.
    h = torch.arange(IN_X, device=dev)[None, :]
    lp_sh = torch.roll(lp, -8, dims=-1)                 # lp[h+8] at h
    _k = torch.where((h >= 5) & (h < 832), lp_sh, 0.0)
    _k = torch.where(h >= 836, __k, _k)

    core = cfg.p_3dcore * IRESCALE
    rng = cfg.p_3drange * IRESCALE
    combk2 = torch.clamp(1 - ((_k - core) / rng), 0, 1)
    mask = _row_mask(36, IN_Y, dev) & _col_mask(4, 840, dev)
    clp2 = torch.where(mask, clp2, 0.0)
    combk2 = torch.where(mask, combk2, 0.0)
    return clp2, combk2


def split_iq(raw, clps, combks, invert_col: torch.Tensor, cfg: CombConfig):
    """(comb-ntsc.cxx:414-483).  Returns (y, i, q) float tensors.

    With cfg.debug2d the blended chroma is replaced by the raw 2D-3D
    estimate difference and luma by 50-IRE gray (comb-ntsc.cxx:440-461);
    the MSE/ME statistics over that difference are `debug2d_stats`."""
    dev = raw.device
    if cfg.debug2d:
        cavg = clps[1] - clps[0]          # clp1 - clp2 (2D minus 3D)
    else:
        cavg = sum(c * k for c, k in zip(clps, combks)) / 2.0
    cavg = torch.where(invert_col[..., None], cavg, -cavg)

    phase = torch.arange(IN_X, device=dev)[None, :] % 4
    si_val = torch.where(phase == 0, cavg,
                         torch.where(phase == 2, -cavg, 0.0))
    sq_val = torch.where(phase == 1, -cavg,
                         torch.where(phase == 3, cavg, 0.0))
    si = torch.where((phase == 0) | (phase == 2), si_val,
                     _shift_right(si_val))
    sq = torch.where((phase == 1) | (phase == 3), sq_val,
                     _shift_right(sq_val))

    mask = _row_mask(36, IN_Y, dev) & _col_mask(4, 840, dev)
    # ire_to_u16(50) = (50+40)*irescale + irebase (comb-ntsc.cxx:150-155,461)
    ybase = torch.full_like(raw, 50 * IRESCALE + 40 * IRESCALE + IREBASE) \
        if cfg.debug2d else raw
    y = torch.where(mask, ybase, 0.0)
    i = torch.where(mask, si, 0.0)
    q = torch.where(mask, sq, 0.0)
    if cfg.bw:
        i = torch.zeros_like(i)
        q = torch.zeros_like(q)
    return y, i, q


def debug2d_stats(clp1, clp2):
    """Per-line and total MSE/ME of the 2D-3D chroma difference
    (comb-ntsc.cxx:440-445,476-482): columns 4..839, per-line mean over
    836 samples, totals over lines 36..523 (the SplitIQ loop floor
    intersected with the 6..523 print window)."""
    dev = clp1.device
    d = torch.where(_col_mask(4, 840, dev), clp1 - clp2, 0.0)
    msel = (d * d).sum(dim=-1) / 836.0
    sel = d.abs().sum(dim=-1) / 836.0
    lr = torch.arange(IN_Y, device=dev)
    lmask = (lr >= 36) & (lr <= 523)
    return (msel, sel, torch.where(lmask, msel, 0.0).sum(dim=-1),
            torch.where(lmask, sel, 0.0).sum(dim=-1))


def adjust_y(y, i, q, invert_col: torch.Tensor, cfg: CombConfig):
    """Remove chroma from luma; shifts the whole YIQ left by 2
    (comb-ntsc.cxx:735-763)."""
    dev = y.device
    phase = torch.arange(IN_X, device=dev)[None, :] % 4
    y2, i2, q2 = (_shift_left(v, 2) for v in (y, i, q))     # x[h+2]
    comp = torch.where(phase == 0, i2,
                       torch.where(phase == 1, -q2,
                                   torch.where(phase == 2, -i2, q2)))
    comp = torch.where(invert_col[..., None], -comp, comp)
    ynew = y2 + comp
    mask = _row_mask(cfg.firstline, IN_Y, dev) & _col_mask(2, 842, dev)
    return (torch.where(mask, ynew, y),
            torch.where(mask, i2, i),
            torch.where(mask, q2, q))


def chroma_lpf_pair(a, b, ba_a, ba_b, W: int, nrows: int, row_lo: int,
                    feed_hi: int, out_hi: int):
    """Post-demod chroma LPF over two held alternating sample streams
    (the FilterIQ structure, comb-ntsc.cxx:212-243): one-pole IIRs fed at
    even/odd h from h=4, held outputs written back at h-2."""
    dev = a.device
    col = torch.arange(W, device=dev)[None, :]
    row = torch.arange(nrows, device=dev)[:, None]
    fm = (col >= 4) & (col < feed_hi)
    a_in = torch.where(fm, a, 0.0)
    b_in = torch.where(fm, b, 0.0)
    fa = _iir1_scan(a_in[..., 4::2], ba_a[0], ba_a[1])
    fb = _iir1_scan(b_in[..., 5::2], ba_b[0], ba_b[1])

    # held outputs at each h (value from the last feed at or before h)
    def held(seq_out, first_col):
        up = torch.repeat_interleave(seq_out, 2, dim=-1)
        return F.pad(up, (first_col, 0))[..., :W]

    ha = held(fa, 4)
    hb = held(fb, 5)
    mask = (row >= row_lo) & (col >= 2) & (col < out_hi)
    return (torch.where(mask, _shift_left(ha, 2), a),
            torch.where(mask, _shift_left(hb, 2), b))


def filter_iq(i, q, cfg: CombConfig):
    """Post chroma LPF: one-pole IIRs over the alternating I/Q sample
    streams (comb-ntsc.cxx:212-243).  hq mode filters Q with the I LPF."""
    bi_ai = FILTERS['lpi']
    bq_aq = FILTERS['lpi'] if cfg.colorlpf_hq else FILTERS['lpq']
    return chroma_lpf_pair(i, q, bi_ai, bq_aq, IN_X, IN_Y,
                           row_lo=44, feed_hi=840, out_hi=838)


def do_ynr(y, cfg: CombConfig):
    """Luma coring NR (comb-ntsc.cxx:523-553)."""
    if cfg.nr_y <= 0:
        return y
    nr_y = cfg.nr_y * IRESCALE
    hp = _causal_fir(y, FILTERS['nr'], 40)
    a = torch.clamp(_shift_left(hp, 12), -nr_y, nr_y)      # hp[h+12]
    mask = _row_mask(cfg.firstline, IN_Y, y.device) \
        & _col_mask(40, 843, y.device)
    return torch.where(mask, y - a, y)


def do_cnr(i, q, cfg: CombConfig, min_val: float = -1.0):
    """Chroma coring NR (comb-ntsc.cxx:485-521)."""
    nr_c = max(cfg.nr_c, min_val)
    if nr_c <= 0:
        return i, q
    nr_c = nr_c * IRESCALE
    out = []
    for chan in (i, q):
        hp = _causal_fir(chan, FILTERS['nrc'], 60)
        a = torch.clamp(_shift_left(hp, 12), -nr_c, nr_c)
        mask = _row_mask(cfg.firstline, IN_Y, chan.device) \
            & _col_mask(60, 842, chan.device)
        out.append(torch.where(mask, chan - a, chan))
    return out[0], out[1]


def agc_levels(burst_raw: np.ndarray, aburstlev: float, cfg: CombConfig
               ) -> Tuple[np.ndarray, float]:
    """The burst-AGC EMA (comb-ntsc.cxx:563-564; the JAX package's
    `agc_ema_step` scan) for a run of frames, on the host in float32 and
    in the scan's operation order.  burst_raw: (E, IN_Y) column 1 of the E
    frames in emission order.  Lines with burst > 3 IRE update the EMA,
    seeded by the first such line; the carry runs across lines and
    frames.  Returns ((E, IN_Y - firstline) float32 levels, the carry)."""
    f32 = np.float32
    burst = (np.asarray(burst_raw, f32)[:, cfg.firstline:]
             / f32(IRESCALE)).astype(f32)
    out = np.empty_like(burst)
    c, k99, k01, three = f32(aburstlev), f32(.99), f32(.01), f32(3)
    for e in range(burst.shape[0]):
        row, orow = burst[e], out[e]
        for n in range(burst.shape[1]):
            b = row[n]
            if b > three:
                if c < 0:
                    c = b
                c = c * k99 + b * k01
            orow[n] = c
    return out, float(c)


def burst_levels(frames: torch.Tensor, aburstlev: float, cfg: CombConfig):
    """AGC levels of `frames` (E, IN_Y, IN_X) in order, from the carry
    `aburstlev`: (levels (E, IN_Y - firstline) on the frames' device, the
    new carry).  Synchronises with the device: the frames' burst column
    (E x 525 values) comes to the host for the EMA loop (agc_levels)."""
    lv, ab = agc_levels(frames[:, :, 1].cpu().numpy(), aburstlev, cfg)
    return torch.from_numpy(lv).to(frames.device), ab


def to_rgb(y, i, q, levels: torch.Tensor, cfg: CombConfig) -> torch.Tensor:
    """YIQ -> RGB48 (comb-ntsc.cxx:555-598) with the burst-AGC levels of
    each line from firstline on (`agc_levels`).  Returns (..., linesout,
    910, 3) int32 holding the uint16 values (clamped, truncated)."""
    first = cfg.firstline
    gain = 10.0 / levels                              # (..., rows)

    nrows = min(cfg.linesout, IN_Y - first)
    yv = y[..., first:first + nrows, :]
    iv = i[..., first:first + nrows, :] * gain[..., :nrows, None]
    qv = q[..., first:first + nrows, :] * gain[..., :nrows, None]

    y_ire = torch.where(yv == 0, -100.0, -40.0 + (yv - IREBASE) / IRESCALE)
    y2 = (y_ire - cfg.black_ire) * (100.0 / (100.0 - cfg.black_ire))
    # NB: the reference swaps i/q names here (comb-ntsc.cxx:135-136)
    qq = iv / IRESCALE
    ii = qv / IRESCALE
    r = y2 + (.956 * ii) + (.621 * qq)
    g = y2 - (.272 * ii) - (.647 * qq)
    b = y2 - (1.106 * ii) + (1.703 * qq)
    m = cfg.brightness * 256 / 100
    rgb = torch.stack([r, g, b], dim=-1) * m
    rgb = torch.clamp(rgb, 0, 65535).to(torch.int32)
    if nrows < cfg.linesout:
        # linesout=525 with firstline=20: the reference zero-fills the
        # tail rows it never computes -- keep the promised output shape
        rgb = F.pad(rgb, (0, 0, 0, 0, 0, cfg.linesout - nrows))
    return rgb


def _invert_col(raw_u16: torch.Tensor, cfg: CombConfig) -> torch.Tensor:
    invert = raw_u16[..., 0] == 16384
    return ~invert if cfg.phase_invert else invert


def flow_luma(raw_u16: torch.Tensor, cfg: CombConfig) -> torch.Tensor:
    """The NR'd adjusted luma the reference feeds Farneback
    (comb-ntsc.cxx:852-857: SplitIQ -> AdjustY -> YNR/CNR with min 4)."""
    raw = raw_u16.to(torch.float32)
    invert_col = _invert_col(raw_u16, cfg)
    clp0 = split1d(raw)
    z = torch.zeros_like(raw)
    clp1, k1, k0 = split2d(clp0, z, cfg.adaptive2d)
    y, i, q = split_iq(raw, (z, clp1, clp0), (z, k1, k0), invert_col, cfg)
    y, i, q = adjust_y(y, i, q, invert_col, cfg)
    # the reference's DoYNR/DoCNR 'min 4' floor is in raw units against
    # the already-irescaled nr (1 IRE = 358.4), so it never binds for
    # normal settings -- floor at 4 RAW counts, not 4 IRE
    ycfg = CombConfig(dim=cfg.dim, nr_y=max(cfg.nr_y, 4.0 / IRESCALE),
                      nr_c=max(cfg.nr_c, 4.0 / IRESCALE),
                      linesout=cfg.linesout)
    return do_ynr(y, ycfg)


def _frame_core(raw_u16, prev_u16, next_u16, levels: torch.Tensor,
                cfg: CombConfig, combk2_in=None):
    """Comb frames (..., IN_Y, IN_X) to (RGB48 (..., linesout, 910, 3)
    int32, extras).  prev/next are the temporal neighbours for dim 3 (the
    optical-flow mode reads prev only, gated by combk2_in); levels are the
    AGC levels of `agc_levels`.  extras holds the debug surfaces the
    configuration asks for: -D's per-line and total MSE/ME (mse_line,
    me_line, mse, me), -l's pre-AGC YIQ row (dbg_y, dbg_i, dbg_q); -k
    renders the K-map as the picture itself."""
    dev = raw_u16.device
    raw = raw_u16.to(torch.float32)
    invert_col = _invert_col(raw_u16, cfg)

    clp0 = split1d(raw)
    if cfg.dim == 1:
        clp0 = split1d_filtered(raw, clp0, invert_col)
    if cfg.dim >= 3 and combk2_in is not None:
        prev = prev_u16.to(torch.float32)
        clp2, combk2 = split3d_optflow(raw, prev, combk2_in)
    elif cfg.dim >= 3:
        prev = prev_u16.to(torch.float32)
        nxt = next_u16.to(torch.float32)
        clp2, combk2 = split3d(raw, prev, nxt, cfg)
    else:
        clp2 = torch.zeros_like(raw)
        combk2 = torch.zeros_like(raw)

    if cfg.dim >= 2:
        clp1, combk1, combk0 = split2d(clp0, combk2, cfg.adaptive2d)
    else:
        clp1 = torch.zeros_like(raw)
        combk1 = torch.zeros_like(raw)
        combk0 = torch.where(_row_mask(44, IN_Y, dev) & _col_mask(4, 840, dev),
                             1.0, 0.0).expand_as(raw)

    if cfg.dim >= 3:
        # Split3D also rewrites combk1/combk0 (comb-ntsc.cxx:404-409)
        mask36 = _row_mask(36, IN_Y, dev) & _col_mask(4, 840, dev)
        k1row = _row_mask(2, 524, dev)
        combk1 = torch.where(mask36 & k1row, 1.0 - combk2, combk1)
        combk0 = torch.where(mask36, 1.0 - combk2 - combk1, combk0)

    y, i, q = split_iq(raw, (clp2, clp1, clp0), (combk2, combk1, combk0),
                       invert_col, cfg)
    y, i, q = adjust_y(y, i, q, invert_col, cfg)
    if cfg.colorlpf:
        i, q = filter_iq(i, q, cfg)

    # VBI pass-through (comb-ntsc.cxx:876-882)
    # rows 20..43 copied up by 20: y[l-20] = raw[l]
    raw_sh = torch.cat([raw[..., 20:, :], raw[..., :20, :]], dim=-2)
    vbi_dst = _row_mask(0, 24, dev) & _col_mask(4, 840, dev)
    y = torch.where(vbi_dst, raw_sh, y)

    y = do_ynr(y, cfg)
    i, q = do_cnr(i, q, cfg)

    extras = {}
    if cfg.debug2d:
        msel, sel, mse, me = debug2d_stats(clp1, clp2)
        extras.update(mse_line=msel, me_line=sel, mse=mse, me=me)
    if cfg.showk:
        # -k: luma = combk[dim-1] rendered as 0..100 IRE, read 82 samples
        # ahead; chroma off (comb-ntsc.cxx:575-579)
        ksel = {1: combk0, 2: combk1, 3: combk2}[cfg.dim]
        y = torch.clamp((_shift_left(ksel, 82) * 100 + 40) * IRESCALE
                        + IREBASE, 1, 65535)
        i = torch.zeros_like(i)
        q = torch.zeros_like(q)
    if cfg.debugline > -9999:
        l = cfg.debugline + 25
        extras.update(dbg_y=y[..., l, :], dbg_i=i[..., l, :],
                      dbg_q=q[..., l, :])
    return to_rgb(y, i, q, levels, cfg), extras


def comb_frame(raw_u16, prev_u16, next_u16, aburstlev: float,
               cfg: CombConfig):
    """One (IN_Y, IN_X) frame: (RGB48 int32, the AGC carry, extras)."""
    levels, ab = burst_levels(raw_u16[None], aburstlev, cfg)
    rgb, extras = _frame_core(raw_u16, prev_u16, next_u16, levels[0], cfg)
    return rgb, ab, extras


def comb_frame_of(raw_u16, newest_u16, combk2, aburstlev: float,
                  cfg: CombConfig):
    """One frame in the optical-flow mode, gated by the flow confidence
    map `combk2` (farneback_combk2)."""
    levels, ab = burst_levels(raw_u16[None], aburstlev, cfg)
    rgb, extras = _frame_core(raw_u16, newest_u16, newest_u16, levels[0],
                              cfg, combk2_in=combk2)
    return rgb, ab, extras


# flow-field geometry (comb-ntsc.cxx:606-615): each field's luma is a
# 252x840 image
_CYSIZE, _CXSIZE = 252, IN_X - 70


def field_pics(lum: torch.Tensor) -> torch.Tensor:
    """(..., IN_Y, IN_X) luma -> (..., 2, 252, 840) field images quantized
    as the reference's uint16 cast does (clamp, truncate), kept as
    float32."""
    out = []
    for field in range(2):
        rows = constant(np.clip(23 + field + 2 * np.arange(_CYSIZE), 0,
                                IN_Y - 1), torch.int64, lum.device)
        pic = lum[..., 70:70 + _CXSIZE].index_select(-2, rows)
        out.append(torch.clamp(pic, 0, 65535).to(torch.int32))
    return torch.stack(out, dim=-3).to(torch.float32)


def flow_confidence(flow: torch.Tensor, core: float, rng: float
                    ) -> torch.Tensor:
    """Per-field flows (..., 2, 252, 840, 2) -> the (..., IN_Y, IN_X) 3D
    confidence map: 1 - clip((|flow| - core) / range) with the horizontal
    component doubled, the lower of the two fields, on both rows of each
    field line pair from column 70 (comb-ntsc.cxx:600-662)."""
    mag = torch.sqrt(flow[..., 1] ** 2 + (flow[..., 0] * 2) ** 2)
    c = 1.0 - torch.clamp((mag - core) / rng, 0, 1)
    c = torch.minimum(c[..., 0, :, :], c[..., 1, :, :])
    return F.pad(torch.repeat_interleave(c, 2, dim=-2),
                 (70, 0, 0, IN_Y - 2 * _CYSIZE))


def farneback_combk2(y_now: torch.Tensor, prev_pics: dict, flows: dict,
                     fcount: int, p_3dcore: float = 0.0,
                     p_3drange: float = 0.5,
                     engine: str = 'native') -> torch.Tensor:
    """Per-pixel 3D confidence from Farneback optical flow on each field's
    luma (comb-ntsc.cxx:600-662): the (IN_Y, IN_X) float32 map, zero
    before the second frame.  Mutates the prev_pics/flows carries (keyed
    by field 0, 1).

    engine='native' runs both fields through one batched
    calc_optical_flow_farneback call on y_now's device (K2 gathers both
    fields' rows in each of its 9 launches); engine='cv2' calls OpenCV on
    the host, one field at a time (the parity oracle)."""
    pics = field_pics(y_now)                       # (2, 252, 840)
    dev = y_now.device
    host = pics.cpu().numpy().astype(np.uint16) if engine == 'cv2' else None
    combk2 = torch.zeros((IN_Y, IN_X), dtype=torch.float32, device=dev)
    if fcount:
        use_init = fcount > 1
        if engine == 'cv2':
            import cv2
            flags = cv2.OPTFLOW_USE_INITIAL_FLOW if use_init else 0
            for field in range(2):
                flows[field] = cv2.calcOpticalFlowFarneback(
                    host[field], prev_pics[field], flows.get(field), 0.5, 4,
                    60, 3, 7, 1.5, flags)
            flow = torch.from_numpy(np.stack([flows[0], flows[1]])).to(dev)
        else:
            init = torch.stack([flows[0], flows[1]]) if use_init else None
            flow = calc_optical_flow_farneback(
                pics, torch.stack([prev_pics[0], prev_pics[1]]), init, 0.5,
                4, 60, 3, 7, 1.5, use_initial_flow=use_init, device=dev)
            flows[0], flows[1] = flow[0], flow[1]
        combk2 = flow_confidence(flow, p_3dcore, p_3drange)
    for field in range(2):
        prev_pics[field] = host[field] if host is not None else pics[field]
    return combk2


class PulldownAssembler:
    """3:2 pulldown film-frame reassembly (reference comb-ntsc.cxx:894-938,
    the `-p` flag at :1009).

    CAV picture-number / white-flag field parity in the frame's line-0
    flag word decides whether a video frame is a whole film frame
    (fstart==0 -> emit it), the odd-field start of one (fstart==1 ->
    hold its odd lines), or -- when an odd frame is pending -- the even
    half that completes it (merge current even lines into the held
    frame and emit).  Frames carrying no parity flags (fstart==-1) are
    the 3:2 redundancy and are dropped.  White flags outrank CAV flags,
    exactly like the reference's two if/else chains."""

    def __init__(self):
        self._odd = None           # held frame with valid odd lines
        self._framecode = 0        # CAV picture number of the held frame

    def process(self, rgb: np.ndarray, words: np.ndarray):
        """rgb: (rows, w, 3) uint16 comb output; words: that frame's 16
        line-0 metadata words (raw TBC line 0 / `frame_metadata_words`).
        Returns a list of (frame, framecode) emissions (0, 1, or 2)."""
        emits = []
        if self._odd is not None:
            merged = self._odd
            merged[0::2] = np.asarray(rgb)[0::2]
            emits.append((merged, self._framecode))
            self._odd = None
        flags = int(words[13])
        fstart = -1
        if flags & FRAME_INFO_CAV_ODD:
            fstart = 1
        elif flags & FRAME_INFO_CAV_EVEN:
            fstart = 0
        if flags & FRAME_INFO_WHITE_ODD:
            fstart = 1
        elif flags & FRAME_INFO_WHITE_EVEN:
            fstart = 0
        self._framecode = (int(words[14]) << 16) | int(words[15])
        if fstart == 0:
            emits.append((np.asarray(rgb).copy(), self._framecode))
        elif fstart == 1:
            self._odd = np.asarray(rgb).copy()
        return emits


def _frame_words(frame: torch.Tensor) -> np.ndarray:
    """A frame's 16 line-0 metadata words as np.uint16."""
    return frame[0, :16].cpu().numpy().astype(np.uint16)


class NTSCComb:
    """Stateful frame-at-a-time comb mirroring `Comb::Process`
    (comb-ntsc.cxx:834-938): 3-frame ring for dim 3, flow and AGC carries,
    the debug surfaces, crop.  Frames live on `device` (default the card);
    each emitted RGB frame comes to the host."""

    def __init__(self, cfg: CombConfig = CombConfig(),
                 device=DEFAULT_DEVICE):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.ring = []
        self.aburstlev = -1.0
        self.framecount = 0
        self._of_prev = {}
        self._of_flows = {}
        self._of_count = 0
        self._of_combk2 = None
        # line-0 metadata words of the frame the last process() output
        # corresponds to (lags the input by one frame in dim-3 mode);
        # the pulldown assembler keys off these (comb-ntsc.cxx:911-921)
        self.last_frame_words = np.zeros(16, np.uint16)
        # debug surfaces: -D stats / -l line dump from the last frame
        # (comb-ntsc.cxx:476-482, 581-591)
        self.last_debug2d = None       # dict(mse, me, mse_line, me_line)
        self.last_debugline = None     # dict(y, i, q) pre-AGC YIQ row

    def process(self, framebuf) -> Optional[np.ndarray]:
        """framebuf: (525*910,) or (525, 910) 16-bit samples, a numpy array
        or a tensor.  Returns RGB48 (linesout, 744 or 910, 3) uint16, or
        None during dim-3 warmup."""
        cfg = self.cfg
        if not isinstance(framebuf, torch.Tensor):
            framebuf = torch.from_numpy(np.asarray(framebuf).astype(np.int32))
        frame = framebuf.to(self.device).reshape(IN_Y, IN_X)
        if cfg.dim >= 3:
            self.ring.append(frame)
            if len(self.ring) > 3:
                self.ring.pop(0)
            if cfg.opticalflow and self.framecount >= 1:
                # flow between the newest frame's NR'd luma and the
                # previous one (comb-ntsc.cxx:852-858)
                self._of_combk2 = farneback_combk2(
                    flow_luma(frame, cfg), self._of_prev, self._of_flows,
                    self._of_count, cfg.of_3dcore, cfg.of_3drange,
                    cfg.optflow_engine)
                self._of_count += 1
            if len(self.ring) < 3:
                self.framecount += 1
                return None
            nxt, cur, prv = self.ring[2], self.ring[1], self.ring[0]
            self.last_frame_words = _frame_words(cur)
            # ring order: Frame[0]=new, Frame[1]=mid, Frame[2]=old;
            # Split3D(f=1): p3=Frame[0] (newest), n3=Frame[2] (oldest)
            if cfg.opticalflow:
                rgb, self.aburstlev, extras = comb_frame_of(
                    cur, nxt, self._of_combk2, self.aburstlev, cfg)
            else:
                rgb, self.aburstlev, extras = comb_frame(
                    cur, nxt, prv, self.aburstlev, cfg)
        else:
            self.last_frame_words = _frame_words(frame)
            rgb, self.aburstlev, extras = comb_frame(
                frame, frame, frame, self.aburstlev, cfg)
        self.framecount += 1
        out = rgb.cpu().numpy().astype(np.uint16)
        if cfg.debug2d:
            self.last_debug2d = {
                'mse_line': extras['mse_line'].cpu().numpy(),
                'me_line': extras['me_line'].cpu().numpy(),
                'mse': float(extras['mse']), 'me': float(extras['me'])}
        if cfg.debugline > -9999:
            self.last_debugline = {k[4:]: extras[k].cpu().numpy()
                                   for k in ('dbg_y', 'dbg_i', 'dbg_q')}
            row = cfg.debugline + 25 - cfg.firstline
            if 0 <= row < out.shape[0]:
                out[row] = 0           # blacked out (comb-ntsc.cxx:588-590)
        if not cfg.wide:
            out = out[:, 78:78 + 744]
        return out
