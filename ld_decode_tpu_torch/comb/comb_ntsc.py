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

Not ported (ROADMAP.md Queue 1, "streaming NTSCComb"): the frame-at-a-time
NTSCComb and its debug surfaces (-D, -k, -l), and the cv2 host engine
`farneback_combk2`.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Tuple

import numpy as np
import scipy.signal as sps
import torch
import torch.nn.functional as F

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

DEBUG_TODO = ('the comb debug surfaces (-D, -k, -l) need the streaming '
              'NTSCComb, which is not ported (ROADMAP.md Queue 1, item P6)')


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
    debug2d: bool = False      # -D, -k, -l: not ported (DEBUG_TODO)
    showk: bool = False
    debugline: int = -10000

    @property
    def firstline(self) -> int:
        return 20 if self.linesout == IN_Y else 38

    @property
    def has_debug(self) -> bool:
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
    w = torch.as_tensor(np.ascontiguousarray(b[::-1]), dtype=x.dtype,
                        device=x.device).reshape(1, 1, nb)
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
    """(comb-ntsc.cxx:414-483).  Returns (y, i, q) float tensors."""
    dev = raw.device
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
    y = torch.where(mask, raw, 0.0)
    i = torch.where(mask, si, 0.0)
    q = torch.where(mask, sq, 0.0)
    if cfg.bw:
        i = torch.zeros_like(i)
        q = torch.zeros_like(q)
    return y, i, q


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
                cfg: CombConfig, combk2_in=None) -> torch.Tensor:
    """Comb frames (..., IN_Y, IN_X) to RGB48 (..., linesout, 910, 3) int32.
    prev/next are the temporal neighbours for dim 3 (the optical-flow mode
    reads prev only, gated by combk2_in); levels are the AGC levels of
    `agc_levels`."""
    if cfg.has_debug:
        raise NotImplementedError(DEBUG_TODO)
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
    return to_rgb(y, i, q, levels, cfg)


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
