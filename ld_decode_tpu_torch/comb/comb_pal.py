"""PAL comb-filter chroma decoder (1D/2D/3D) for the 1135x625 .tbc format,
torch port of ld_decode_tpu/comb/comb_pal.py.

The algorithm is the reference attic's PAL comb (attic2/comb-pal.cxx) on
the pilot-locked 4fsc grid:

  * Split1D / adaptive Split2D with the PAL +-4-line chroma period;
  * SplitUV demodulation at h%4 (4 samples a subcarrier cycle);
  * per-line self-calibration from the swinging burst: the measured burst
    angle rotates each line's (U, V) so burst sits at 135 degrees;
  * the V-switch parity chosen among four row patterns by the vertical
    chroma correlation, then the attic's flip rule; YUV -> RGB;
  * a tapered rfft-bin notch per line that removes the 3.75 MHz pilot of
    Philips pilot discs (240 cycles a line on this grid) before the comb.

Every function takes leading batch dimensions (a window's frames are
combed in one pass).  Frames come in as integer tensors holding 16-bit
samples; RGB48 goes out as int32 values 0..65535, made np.uint16 on the
host.  What changed in the port, each held to JAX by
tests/test_torch_comb_pal.py:
  * the 3D motion gate's `jnp.convolve(...)[:PAL_X]` is comb_ntsc's
    `F.conv1d` form (a correlation with the taps flipped, full float32);
  * the V-switch candidate is chosen from the four scores as one tensor,
    the first maximum winning (JAX's strict `>` walk from -inf), with no
    read-back to the host;
  * in a window the pilot notch runs once per frame (`notch_pilot`), not
    once per use as prev/cur/next.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Optional, Union

import numpy as np
import torch
import torch.nn.functional as F

from ld_decode_tpu_torch.comb.comb_ntsc import (FILTERS, _shift_left,
                                                _shift_right,
                                                chroma_lpf_pair)
from ld_decode_tpu_torch.tbc.sync import first_true
from ld_decode_tpu_torch.utils.device import DEFAULT as DEFAULT_DEVICE
from ld_decode_tpu_torch.utils.device import constant
from ld_decode_tpu_torch.utils.device import resolve as resolve_device
from ld_decode_tpu_torch.utils.graphs import GraphCache, as_cache

PAL_Y, PAL_X = 625, 1135
IRESCALE = 376.32            # (0xd300-0x0100)/(100+42.857): the PAL scale
IREBASE = 256
VSYNC_IRE = -0.3 * (100 / 0.7)


@dataclass(frozen=True)
class CombPALConfig:
    dim: int = 2
    bw: bool = False
    adaptive2d: bool = True
    nr_y: float = 1.0
    brightness: float = 240.0
    black_ire: float = 0.0
    burst_cols: tuple = (20, 48)     # burst window after the hsync-end origin
    linesout: int = 576
    firstline: int = 24
    p_3dcore: float = 1.25           # 3D motion gate (IRE), as NTSC defaults
    p_3drange: float = 5.5
    # post-demod chroma LPF (the attic's FilterIQ behind f_colorlpf, off by
    # default there and here): one-pole filters over the held U/V streams
    colorlpf: bool = False
    colorlpf_hq: bool = True
    # removal of the 3.75 MHz pilot that pilot discs carry through the
    # .tbc as a full-height pattern; it is not chroma, so no comb removes it
    pilot_notch: bool = True


# per-frame constants, built once per device (a torch.device hashes)

@functools.lru_cache(maxsize=None)
def _row_mask(lo: int, hi: int, dev: torch.device) -> torch.Tensor:
    r = torch.arange(PAL_Y, device=dev)[:, None]
    return (r >= lo) & (r < hi)


@functools.lru_cache(maxsize=None)
def _col_mask(lo: int, hi: int, dev: torch.device) -> torch.Tensor:
    c = torch.arange(PAL_X, device=dev)[None, :]
    return (c >= lo) & (c < hi)


@functools.lru_cache(maxsize=None)
def _phase(dev: torch.device) -> torch.Tensor:
    return torch.arange(PAL_X, device=dev)[None, :] % 4


def split1d_pal(raw: torch.Tensor) -> torch.Tensor:
    dev = raw.device
    rp = F.pad(raw, (2, 2))
    tc1 = ((rp[..., 4:] + rp[..., :-4]) / 2) - raw
    mask = _row_mask(24, PAL_Y, dev) & _col_mask(4, PAL_X - 4, dev)
    return torch.where(mask, tc1, 0.0)


def split2d_pal(clp0: torch.Tensor, adaptive: bool):
    """Adaptive 2D with the PAL +-4 line period
    (attic2/comb-pal.cxx:283-341).  Returns (clp1, k1, k0)."""
    dev = clp0.device
    z4 = torch.zeros_like(clp0[..., :4, :])
    p1 = torch.cat([z4, clp0[..., :-4, :]], dim=-2)
    n1 = torch.cat([clp0[..., 4:, :], z4], dim=-2)
    c1 = clp0

    ac, ap, an = c1.abs(), p1.abs(), n1.abs()
    sh = _shift_right
    kp = ((ac - ap).abs() + (sh(ac) - sh(ap)).abs()
          - (ac + sh(ac)) * .10) / 2
    kn = ((ac - an).abs() + (sh(ac) - sh(an)).abs()
          - (ac + sh(an)) * .10) / 2
    rng = 45 * IRESCALE
    kp = torch.clamp(1 - kp / rng, 0, 1)
    kn = torch.clamp(1 - kn / rng, 0, 1)
    if not adaptive:
        kp = torch.ones_like(kp)
        kn = torch.ones_like(kn)
    both0 = (kp == 0) & (kn == 0)
    kp2 = torch.where(kn > 3 * kp, 0.0, kp)
    kn2 = torch.where(kp > 3 * kn, 0.0, kn)
    den = kn2 + kp2
    sc = torch.clamp(torch.where(den > 0,
                                 2.0 / torch.where(den > 0, den, 1.0), 1.0),
                     min=1.0)
    fb = ((ap - an).abs() - ((n1 + p1) * .2).abs()) <= 0
    fbv = torch.where(fb, 1.0, 0.0)
    kp2 = torch.where(both0, fbv, kp2)
    kn2 = torch.where(both0, fbv, kn2)
    sc = torch.where(both0, 1.0, sc)
    tc = ((c1 - p1) * kp2 * sc + (c1 - n1) * kn2 * sc) / 4

    inner = _row_mask(4, PAL_Y - 4, dev) & _col_mask(18, PAL_X - 4, dev)
    clp1 = torch.where(inner, tc, 0.0)
    k1 = torch.where(inner, 1.0, 0.0)
    outer = _row_mask(24, PAL_Y, dev) & _col_mask(4, PAL_X - 4, dev)
    k0 = torch.where(outer & (k1 > 0), 0.0, 1.0)
    k0 = torch.where(outer, k0,
                     torch.where(_row_mask(24, PAL_Y, dev), 1.0, 0.0))
    return clp1, k1, k0


def split3d_pal(raw, prev_raw, next_raw, cfg: CombPALConfig):
    """Temporal (3D) chroma + motion gate for PAL (attic2/comb-pal.cxx:
    355-397, corrected for the PAL frame phase).

    On the 4fsc grid the PAL subcarrier walks 270 degrees a frame and the
    625-line frame flips the V-switch parity, so (prev+next)/2 cancels the
    neighbours' chroma and the difference from the current frame isolates
    -C; the 1D/2D estimates carry -2C on this grid, hence the x2 scale.
    prev and next are antiphase in chroma, so the motion detector cancels
    chroma in their difference with the +-2-sample average and gates on
    the remaining luma motion, smoothed by fir1(16, 0.1)."""
    dev = raw.device
    clp2 = (((prev_raw + next_raw) / 2.0) - raw) * 2.0

    d = prev_raw - next_raw
    dp = F.pad(d, (2, 2))
    luma_d = ((dp[..., :-4] + 2.0 * d + dp[..., 4:]) * 0.25).abs() * 2.0
    luma_d = torch.where(_col_mask(4, PAL_X, dev), luma_d, 0.0)
    # convolve(row, b, 'full')[:PAL_X]: F.conv1d correlates, so the taps
    # are flipped; float32 throughout (TF32 is off package-wide).  The taps
    # are a per-device constant: a CUDA graph capture may not copy them
    # from host memory
    b = FILTERS['lp3d']
    nb = len(b)
    w = constant(b[::-1], luma_d.dtype, dev).reshape(1, 1, nb)
    k = F.conv1d(F.pad(luma_d.reshape(-1, 1, PAL_X), (nb - 1, 0)),
                 w).reshape(luma_d.shape)
    k = torch.roll(k, -8, dims=-1)       # the FIR's group delay; it wraps

    core = cfg.p_3dcore * IRESCALE
    rng = cfg.p_3drange * IRESCALE
    combk2 = torch.clamp(1 - ((k - core) / rng), 0, 1)
    mask = _row_mask(24, PAL_Y, dev) & _col_mask(12, PAL_X - 12, dev)
    return torch.where(mask, clp2, 0.0), torch.where(mask, combk2, 0.0)


def split_uv(raw, clps, ks):
    """Demodulate the blended chroma at h%4 (attic2/comb-pal.cxx:398-452,
    invertphase false for the flag-less PAL .tbc).  Everything outside the
    mask is zero again here: the `y == 0` test of the output stage relies
    on it after the notch."""
    dev = raw.device
    cavg = sum(c * k for c, k in zip(clps, ks)) / 2.0
    cavg = -cavg
    phase = _phase(dev)
    su_v = torch.where(phase == 0, cavg, torch.where(phase == 2, -cavg, 0.0))
    sv_v = torch.where(phase == 1, -cavg, torch.where(phase == 3, cavg, 0.0))
    u = torch.where((phase % 2) == 0, su_v, _shift_right(su_v))
    v = torch.where((phase % 2) == 1, sv_v, _shift_right(sv_v))
    mask = _row_mask(24, PAL_Y, dev) & _col_mask(4, PAL_X - 4, dev)
    return (torch.where(mask, raw, 0.0), torch.where(mask, u, 0.0),
            torch.where(mask, v, 0.0))


def filter_uv(u, v, cfg: CombPALConfig):
    """Post-demod chroma LPF over the held U/V sample streams (the attic's
    FilterIQ, attic2/comb-pal.cxx:203-230, with the NTSC-rate tables as
    there).  hq mode filters V with the U (wider) LPF."""
    bu_au = FILTERS['lpi']
    bv_av = FILTERS['lpi'] if cfg.colorlpf_hq else FILTERS['lpq']
    return chroma_lpf_pair(u, v, bu_au, bv_av, PAL_X, PAL_Y,
                           row_lo=24, feed_hi=PAL_X - 4, out_hi=PAL_X - 6)


def adjust_y_pal(y, u, v):
    """Remove the remodulated chroma from luma, shifting YUV left by 2 (the
    attic's AdjustY, attic2/comb-pal.cxx:454-476).

    The output at h is y[h+2], whose subcarrier phase is (h+2)%4, so the
    modulated chroma there is [-u, v, u, -v] by h-phase; y2 + comp with
    comp = [u2, -v2, -u2, v2] subtracts it.  (With the opposite sign the
    luma carries twice the subcarrier as dot crawl on every saturated
    colour, which bar-mean hue checks integrate away:
    tests/test_torch_comb_pal.py pins the interior flatness.)"""
    dev = y.device
    phase = _phase(dev)
    y2, u2, v2 = (_shift_left(x, 2) for x in (y, u, v))
    comp = torch.where(phase == 0, u2,
                       torch.where(phase == 1, -v2,
                                   torch.where(phase == 2, -u2, v2)))
    mask = _row_mask(24, PAL_Y, dev) & _col_mask(2, PAL_X - 2, dev)
    return (torch.where(mask, y2 + comp, y), torch.where(mask, u2, u),
            torch.where(mask, v2, v))


def _pilot_notch_profile() -> np.ndarray:
    """Per-line rfft gain: unity everywhere except a raised-cosine notch
    (zero at the centre) around bin 240 = 3.75 MHz."""
    prof = np.ones(PAL_X // 2 + 1, np.float32)
    center, width = 240, 8
    for i in range(-width, width + 1):
        prof[center + i] = 1.0 - 0.5 * (1 + np.cos(np.pi * i / (width + 1)))
    return prof


_PILOT_PROF = _pilot_notch_profile()


@functools.lru_cache(maxsize=None)
def _pilot_prof_dev(dev: torch.device) -> torch.Tensor:
    return torch.from_numpy(_PILOT_PROF).to(dev)


def notch_pilot(frames: torch.Tensor) -> torch.Tensor:
    """(..., PAL_Y, PAL_X) 16-bit samples -> float32 with the pilot notched
    out of every line.  1135 = 5 x 227 is odd, so the inverse transform is
    given its length.  Zero regions do not stay zero here: the split / UV
    masks re-zero everything outside the picture area downstream."""
    raw = frames.to(torch.float32)
    spec = torch.fft.rfft(raw, dim=-1) * _pilot_prof_dev(raw.device)
    return torch.fft.irfft(spec, n=PAL_X, dim=-1)


@functools.lru_cache(maxsize=None)
def _vswitch_flips(dev: torch.device) -> torch.Tensor:
    """(4, PAL_Y, 1) bool: the rows each V-switch candidate reflects, in
    the order phase-major, polarity-minor."""
    l = torch.arange(PAL_Y, device=dev)[:, None]
    return torch.stack([(((l + phase) % 4) // 2) == pol
                        for phase in range(2) for pol in range(2)])


def vswitch_choice(u2: torch.Tensor, v2: torch.Tensor) -> torch.Tensor:
    """Index (...,) of the V-switch candidate with the largest vertical
    chroma correlation; the first of equal maxima wins (all four are
    exactly 0 on a grey frame)."""
    flips = _vswitch_flips(u2.device)
    scores = []
    for k in range(4):
        uc = torch.where(flips[k], -v2, u2)
        vc = torch.where(flips[k], -u2, v2)
        us = uc[..., 24:PAL_Y - 2, 64:PAL_X - 16:4]
        vs = vc[..., 24:PAL_Y - 2, 64:PAL_X - 16:4]
        scores.append((us[..., :-2, :] * us[..., 2:, :]
                       + vs[..., :-2, :] * vs[..., 2:, :]).sum(dim=(-2, -1)))
    scores = torch.stack(scores, dim=-1)
    return first_true(scores == scores.amax(dim=-1, keepdim=True))


def comb_core(raw, cfg: CombPALConfig, prev=None, nxt=None):
    """The comb on float32 frames that already passed (or skip) the pilot
    notch: (..., PAL_Y, PAL_X) -> ((..., linesout, 1135, 3) int32 RGB48,
    (..., 625) burst angles in degrees)."""
    dev = raw.device
    base = _row_mask(24, PAL_Y, dev) & _col_mask(4, PAL_X - 4, dev)
    clp0 = split1d_pal(raw)
    if cfg.dim >= 2:
        clp1, k1, k0 = split2d_pal(clp0, cfg.adaptive2d)
    else:
        clp1 = torch.zeros_like(raw)
        k1 = torch.zeros_like(raw)
        k0 = torch.where(base, 1.0, 0.0)
    if cfg.dim >= 3 and prev is not None and nxt is not None:
        clp2, k2 = split3d_pal(raw, prev, nxt, cfg)
        # blend (attic2/comb-pal.cxx:344-351): 2D yields to 3D, 1D takes
        # whatever remains
        k1 = k1 * (1 - k2)
        k0 = torch.clamp(torch.where(base, 1.0, 0.0) - k2 - k1, 0.0, 1.0)
        y, u, v = split_uv(raw, (clp2, clp1, clp0), (k2, k1, k0))
    else:
        y, u, v = split_uv(raw, (clp1, clp0), (k1, k0))
    y, u, v = adjust_y_pal(y, u, v)
    if cfg.colorlpf:
        u, v = filter_uv(u, v, cfg)
    if cfg.bw:
        u = torch.zeros_like(u)
        v = torch.zeros_like(v)

    # per-line burst angle from the demodulated swinging burst.  On lines
    # without burst (and everywhere with bw) the sums are 0 and the angle
    # is atan2(0, 0), whose value turns on the sign of zero: it rotates a
    # chroma of magnitude 0, so it shows nowhere
    b0, b1 = cfg.burst_cols
    bu = u[..., b0:b1].sum(dim=-1)
    bv = v[..., b0:b1].sum(dim=-1)
    angle = torch.rad2deg(torch.atan2(bv, bu))          # (..., 625)

    # rotate each line so its burst lands at 135 degrees: absorbs the
    # line-to-line subcarrier phase walk of the pilot-locked grid
    adj = torch.deg2rad(135.0 - angle)[..., None]
    mag = torch.sqrt(u * u + v * v)
    th = torch.atan2(v, u) + adj
    u2 = torch.cos(th) * mag
    v2 = torch.sin(th) * mag

    # PAL V-switch: the swung lines need the (u, v) -> (-v, -u) reflection
    # (attic2/comb-pal.cxx:625-636).  The burst lies on the reflection
    # axis and cannot pick the polarity; the right row pattern makes U/V
    # smooth down the frame
    choice = vswitch_choice(u2, v2)
    flip = _vswitch_flips(dev).index_select(0, choice.reshape(-1)
                                                 ).reshape(*choice.shape,
                                                           PAL_Y, 1)
    uf = torch.where(flip, -v2, u2)
    vf = torch.where(flip, -u2, v2)

    r0, r1 = cfg.firstline, cfg.firstline + cfg.linesout
    yv = y[..., r0:r1, :]
    uv_ = uf[..., r0:r1, :] / IRESCALE
    vv_ = vf[..., r0:r1, :] / IRESCALE

    y_ire = torch.where(yv == 0, -100.0,
                        (yv - IREBASE) / IRESCALE + VSYNC_IRE)
    y2 = (y_ire - cfg.black_ire) * (100.0 / (100.0 - cfg.black_ire))
    r = y2 + 1.13983 * vv_
    g = y2 - 0.58060 * vv_ - 0.39465 * uv_
    b = y2 + 2.032 * uv_
    m = cfg.brightness * 255 / 100
    rgb = torch.clamp(torch.stack([r, g, b], dim=-1) * m, 0, 65535)
    return rgb.to(torch.int32), angle


def prepare_frames(frames: Optional[torch.Tensor], cfg: CombPALConfig):
    """16-bit frames -> float32, through the pilot notch where the
    configuration has it (None stays None)."""
    if frames is None:
        return None
    return notch_pilot(frames) if cfg.pilot_notch \
        else frames.to(torch.float32)


def comb_pal_frame(raw_u16: torch.Tensor, cfg: CombPALConfig,
                   prev_u16: Optional[torch.Tensor] = None,
                   next_u16: Optional[torch.Tensor] = None):
    """(..., 625, 1135) 16-bit frames -> ((..., linesout, 1135, 3) int32
    RGB48, (..., 625) burst angles in degrees).  dim 3 needs both
    neighbours; without them the frame combs 2D."""
    return comb_core(prepare_frames(raw_u16, cfg), cfg,
                     prepare_frames(prev_u16, cfg),
                     prepare_frames(next_u16, cfg))


class PALComb:
    """Frame-at-a-time PAL comb for .tbc frames (625*1135 uint16), the
    emission oracle of the batched one (comb/batch.py::PALCombBatch).

    With dim=3 a 3-frame ring is kept: frame 0 comes back 2D at once,
    frame k-1 comes back 3D on process(frame k), and flush() returns the
    final frame (2D).  Every frame is emitted exactly once, in order."""

    def __init__(self, cfg: CombPALConfig = CombPALConfig(),
                 device=DEFAULT_DEVICE,
                 graphs: Union[bool, GraphCache] = True):
        """graphs=True (the default) replays `comb_pal_frame` as a CUDA
        graph on the card, one key for the 2D frames and one for the 3D
        ones (utils/graphs.py; eager on the CPU), as the JAX package jits
        it; graphs=False runs it eagerly, for comparisons; a GraphCache is
        used as given."""
        self.cfg = cfg
        self.device = resolve_device(device)
        self.graphs = as_cache(graphs, self.device)
        self._ring: list = []

    def _comb(self, cur, prev=None, nxt=None) -> np.ndarray:
        cfg = self.cfg
        if prev is None:
            rgb = self.graphs(('comb_pal_frame', cfg, False),
                              lambda c: comb_pal_frame(c, cfg)[0], (cur,))
        else:
            rgb = self.graphs(('comb_pal_frame', cfg, True),
                              lambda c, p, n: comb_pal_frame(c, cfg, p,
                                                             n)[0],
                              (cur, prev, nxt))
        # a copy, also on the CPU: replayed, the RGB is the graph's static
        # tensor, which the next frame overwrites
        return rgb.to('cpu', copy=True).numpy().astype(np.uint16)

    def process(self, framebuf: np.ndarray):
        """RGB for one input frame, or None while the dim-3 ring fills."""
        frame = torch.from_numpy(np.asarray(framebuf).reshape(
            PAL_Y, PAL_X).astype(np.int32)).to(self.device)
        if self.cfg.dim < 3:
            return self._comb(frame)
        self._ring.append(frame)
        if len(self._ring) > 3:
            self._ring.pop(0)
        if len(self._ring) == 1:
            return self._comb(frame)                 # first frame: 2D
        if len(self._ring) == 2:
            return None                  # frame 1 pending its successor
        prev, cur, nxt = self._ring
        return self._comb(cur, prev, nxt)

    def flush(self):
        """The final pending frame (2D: it has no successor), or None if
        nothing is pending."""
        if self.cfg.dim < 3 or len(self._ring) < 2:
            return None
        return self._comb(self._ring[-1])
