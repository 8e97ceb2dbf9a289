"""Legacy-geometry PAL comb (torch port of
ld_decode_tpu/comb/comb_pal_legacy.py, the attic2/comb-pal.cxx parity
path).

The reference's only runnable PAL comb is the attic prototype, which reads
the older 1052x610 TBC geometry; the JAX package re-implements it as
whole-frame stencil passes and this module follows it pass for pass:

  * Split1D   -- +-2-sample line chroma (attic2/comb-pal.cxx:236-275);
  * Split2D   -- +-4-line adaptive compare (:283-341); Split3D is compiled
    out in the reference, so dim=3 is 2D on the one-frame-old slot;
  * SplitIQ   -- blend and demodulate at h%4, invertphase from
    rawbuffer[l][0] == 16384 (:400-468);
  * AdjustY (:790-817), DoYNR (:511-539);
  * ToRGB     -- per-line burst angle from h 25..54, rotated to 135
    degrees, V-switch flip on l%4 with the 4-line phase vote, the constant
    AGC gain 10/8, YUV -> RGB (:541-648);
  * PostProcess crop to 974 dots from x=78 (:877-917).

Every function takes leading batch dimensions.  What changed in the port
(held to JAX by tests/test_torch_comb_pal_legacy.py): the luma coring's
`jnp.convolve(row, b)[:L_X]` is a float32 `F.conv1d` with the taps
flipped, divisions by a constant divide by a tensor (CUDA would turn a
division by a host scalar into a reciprocal multiply), and the RGB's
`astype(uint16)` is a clamp and an int32 truncation on the device, made
np.uint16 on the host.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Union

import numpy as np
import torch
import torch.nn.functional as F

from ld_decode_tpu_torch.comb.comb_ntsc import FILTERS
from ld_decode_tpu_torch.utils.device import DEFAULT as DEFAULT_DEVICE
from ld_decode_tpu_torch.utils.device import constant
from ld_decode_tpu_torch.utils.device import resolve as resolve_device
from ld_decode_tpu_torch.utils.graphs import (GraphCache, api_cache,
                                              as_cache, owned)

L_Y, L_X = 610, 1052
IRESCALE = 376.32              # attic2/comb-pal.cxx:49
IRE_OFFSET = -43.122874        # u16_to_ire (attic2/comb-pal.cxx:108-113)
LINEOFFSET = 32                # firstline when linesout=576
LINESOUT = 576
CROP_X0, CROP_W = 78, 1052 - 78


@dataclass(frozen=True)
class LegacyPALConfig:
    dim: int = 2
    bw: bool = False
    adaptive2d: bool = True
    nr_y: float = 1.0          # IRE; scaled by irescale like the reference
    brightness: float = 240.0
    black_ire: float = 0.0
    wide: bool = False


def _rows(lo, hi, dev):
    r = torch.arange(L_Y, device=dev)[:, None]
    return (r >= lo) & (r < hi)


def _cols(lo, hi, dev):
    c = torch.arange(L_X, device=dev)[None, :]
    return (c >= lo) & (c < hi)


def _div(x: torch.Tensor, c: float) -> torch.Tensor:
    """x / c as a true float32 division on every device."""
    return x / torch.full((), c, dtype=x.dtype, device=x.device)


def _shift_right(x):
    """x[..., h-1] with a zero shifted in (jnp.pad((1, 0))[..., :-1])."""
    return F.pad(x, (1, 0))[..., :-1]


def _split1d(raw: torch.Tensor) -> torch.Tensor:
    """+-2-sample chroma; the double phase negation cancels
    (attic2/comb-pal.cxx:236-275).  Integer (a+b)/2 like the C code."""
    rp = F.pad(raw, (2, 2))
    tc1 = torch.floor(_div(rp[..., 4:] + rp[..., :-4], 2.0)) - raw
    mask = _rows(24, L_Y, raw.device) & _cols(4, L_X - 4, raw.device)
    return torch.where(mask, tc1, 0.0)


def _split2d(clp0: torch.Tensor, adaptive: bool):
    """+-4-line adaptive comparison (attic2/comb-pal.cxx:283-341).
    Returns (clp1, combk1, combk0); combk2 is identically 0 (no 3D)."""
    dev = clp0.device
    z = torch.zeros_like(clp0[..., :4, :])
    p1 = torch.cat([z, clp0[..., :-4, :]], dim=-2)
    n1 = torch.cat([clp0[..., 4:, :], z], dim=-2)
    c1 = clp0

    ac, ap, an = c1.abs(), p1.abs(), n1.abs()
    sh = _shift_right
    kp = _div((ac - ap).abs() + (sh(ac) - sh(ap)).abs()
              - (ac + sh(ac)) * .10, 2.0)
    kn = _div((ac - an).abs() + (sh(ac) - sh(an)).abs()
              - (ac + sh(an)) * .10, 2.0)
    rng = 45 * IRESCALE
    kp = torch.clamp(1 - _div(kp, rng), 0, 1)
    kn = torch.clamp(1 - _div(kn, rng), 0, 1)
    if not adaptive:
        kp = torch.ones_like(kp)
        kn = torch.ones_like(kn)
    both0 = (kp == 0) & (kn == 0)
    kp2 = torch.where(kn > 3 * kp, 0.0, kp)
    kn2 = torch.where(kp > 3 * kn, 0.0, kn)
    den = kn2 + kp2
    sc = torch.clamp(torch.where(den > 0, 2.0 / torch.where(den > 0, den,
                                                            1.0), 1.0),
                     min=1.0)
    fb = ((ap - an).abs() - ((n1 + p1) * .2).abs()) <= 0
    kp2 = torch.where(both0, torch.where(fb, 1.0, 0.0), kp2)
    kn2 = torch.where(both0, torch.where(fb, 1.0, 0.0), kn2)
    sc = torch.where(both0, 1.0, sc)
    tc = _div((c1 - p1) * kp2 * sc + (c1 - n1) * kn2 * sc, 4.0)

    # inner 2D region: 24 <= l <= in_y-4 (outer loop floor 24), h 18..1047
    inner = _rows(24, L_Y - 3, dev) & _cols(18, L_X - 4, dev)
    clp1 = torch.where(inner, tc, 0.0)
    combk1 = torch.where(inner, 1.0, 0.0).expand_as(tc)
    # second pass (h 4..1047, rows >= 24): combk0 = 1 - combk2 - combk1
    outer = _rows(24, L_Y, dev) & _cols(4, L_X - 4, dev)
    combk0 = torch.where(outer, 1.0 - combk1, 0.0)
    return clp1, combk1, combk0


def _split_iq(raw, clps, ks, invert_col):
    """Blend + demodulate at h%4 with hold-last I/Q
    (attic2/comb-pal.cxx:400-468)."""
    dev = raw.device
    cavg = _div(sum(c * k for c, k in zip(clps, ks)), 2.0)
    cavg = torch.where(invert_col[..., None], cavg, -cavg)
    phase = torch.arange(L_X, device=dev) % 4
    si_val = torch.where(phase == 0, cavg,
                         torch.where(phase == 2, -cavg, 0.0))
    sq_val = torch.where(phase == 1, -cavg,
                         torch.where(phase == 3, cavg, 0.0))
    si = torch.where((phase == 0) | (phase == 2), si_val,
                     _shift_right(si_val))
    sq = torch.where((phase == 1) | (phase == 3), sq_val,
                     _shift_right(sq_val))
    mask = _rows(24, L_Y, dev) & _cols(4, L_X - 4, dev)
    return (torch.where(mask, raw, 0.0), torch.where(mask, si, 0.0),
            torch.where(mask, sq, 0.0))


def _adjust_y(y, i, q, invert_col):
    """Remove chroma from luma, shifting YIQ left by 2
    (attic2/comb-pal.cxx:790-817; firstline=32)."""
    dev = y.device
    phase = torch.arange(L_X, device=dev) % 4
    shf = lambda x: F.pad(x, (0, 2))[..., 2:]
    y2, i2, q2 = shf(y), shf(i), shf(q)
    comp = torch.where(phase == 0, i2,
                       torch.where(phase == 1, -q2,
                                   torch.where(phase == 2, -i2, q2)))
    comp = torch.where(invert_col[..., None], -comp, comp)
    mask = _rows(LINEOFFSET, L_Y, dev) & _cols(2, L_X, dev)
    return (torch.where(mask, y2 + comp, y),
            torch.where(mask, i2, i),
            torch.where(mask, q2, q))


def _do_ynr(y, nr_y_ire: float):
    """Luma coring NR (attic2/comb-pal.cxx:511-539): highpass fed from
    h=40, core at hp[h+12], rows from firstline=32.  convolve(row, b,
    'full')[:L_X] is a correlation with the taps flipped."""
    if nr_y_ire <= 0:
        return y
    dev = y.device
    nr = nr_y_ire * IRESCALE
    xm = torch.where(_cols(40, L_X, dev), y, 0.0)
    b = FILTERS['nr']
    w = constant(b[::-1], y.dtype, dev).reshape(1, 1, -1)
    hp = F.conv1d(F.pad(xm.reshape(-1, 1, L_X), (len(b) - 1, 0)),
                  w).reshape(y.shape)
    a = torch.clamp(F.pad(hp, (0, 12))[..., 12:], -nr, nr)
    mask = _rows(LINEOFFSET, L_Y, dev) & _cols(40, L_X - 12, dev)
    return torch.where(mask, y - a, y)


def _to_rgb(y, u, v, cfg: LegacyPALConfig) -> torch.Tensor:
    """Per-line burst rotation + V-switch + YUV->RGB
    (attic2/comb-pal.cxx:541-648); (..., 576, L_X, 3) int32 RGB48.
    burstlev is hardcoded 8 so the AGC gain is the constant 10/8."""
    dev = y.device
    # burst angle per line from the demodulated burst, h 25..54
    bu = u[..., 25:55].sum(-1)
    bv = v[..., 25:55].sum(-1)
    angle = torch.rad2deg(torch.atan2(bv, bu))              # (..., L_Y)

    # 4-line phase vote (attic2/comb-pal.cxx:566-573): l = 20,24,..,<606
    ls = torch.arange(20, L_Y - 4, 4, device=dev)
    votes = (angle[..., ls + 1] - angle[..., ls]).abs() < 20
    phase = votes.sum(-1) > (ls.shape[0] // 2)

    adj = torch.deg2rad(135.0 - angle)[..., None]
    mag = torch.sqrt(u * u + v * v)
    th = torch.atan2(v, u) + adj
    gain = 10.0 / 8.0
    ug = torch.cos(th) * mag * gain
    vg = torch.sin(th) * mag * gain

    rot = torch.arange(L_Y, device=dev)[:, None] % 4
    flip = (rot == 1) | (rot == 2)
    flip = torch.where(phase[..., None, None], ~flip, flip)
    uf = torch.where(flip, -vg, ug)
    vf = torch.where(flip, -ug, vg)

    rows = slice(LINEOFFSET, LINEOFFSET + LINESOUT)   # l < in_y-2: 576 rows
    yv = y[..., rows, :]
    uv_ = _div(uf[..., rows, :], IRESCALE)
    vv_ = _div(vf[..., rows, :], IRESCALE)
    y_ire = torch.where(yv == 0, -100.0, _div(yv, IRESCALE) + IRE_OFFSET)
    y2 = (y_ire - cfg.black_ire) * (100.0 / (100.0 - cfg.black_ire))
    r = y2 + 1.13983 * vv_
    g = y2 - 0.58060 * vv_ - 0.39465 * uv_
    b = y2 + 2.032 * uv_
    m = cfg.brightness * 255 / 100
    rgb = torch.clamp(torch.stack([r, g, b], dim=-1) * m, 0, 65535)
    return rgb.to(torch.int32)


def comb_pal_legacy_frame(raw_u16: torch.Tensor, cfg: LegacyPALConfig,
                          graphs: Union[bool, GraphCache] = True
                          ) -> torch.Tensor:
    """(..., 610, 1052) rawbuffers (integer tensors of 16-bit samples) ->
    (..., 576, 1052, 3) int32 RGB48 (before the crop).

    graphs=True (the default; the JAX function is jitted on `cfg`) replays
    the frame as one CUDA graph a cfg (and input shape) key on the card
    and returns a clone of its RGB (utils/graphs.py::api_cache; eager on
    the CPU); False runs it eagerly; a GraphCache is used as given and
    returns its static output."""
    cache, clone = api_cache(graphs, raw_u16.device)
    rgb = cache(('comb_pal_legacy_frame', cfg),
                lambda raw: _legacy_frame(raw, cfg), (raw_u16,))
    return owned(rgb) if clone else rgb


def _legacy_frame(raw_u16: torch.Tensor,
                  cfg: LegacyPALConfig) -> torch.Tensor:
    """comb_pal_legacy_frame's chain of passes."""
    raw = raw_u16.to(torch.float32)
    invert_col = raw_u16[..., 0] == 16384
    dev = raw.device

    clp0 = _split1d(raw)
    if cfg.dim >= 2:
        clp1, k1, k0 = _split2d(clp0, cfg.adaptive2d)
    else:
        clp1 = torch.zeros_like(raw)
        k1 = torch.zeros_like(raw)
        k0 = torch.where(_rows(24, L_Y, dev) & _cols(4, L_X - 4, dev), 1.0,
                         0.0).expand_as(raw)
    y, i, q = _split_iq(raw, (clp1, clp0), (k1, k0), invert_col)
    y, i, q = _adjust_y(y, i, q, invert_col)
    if cfg.bw:
        i = torch.zeros_like(i)
        q = torch.zeros_like(q)
    y = _do_ynr(y, cfg.nr_y)
    return _to_rgb(y, i, q, cfg)


class LegacyPALComb:
    """Frame loop mirroring Process/PostProcess
    (attic2/comb-pal.cxx:820-917).  dim=3 runs the 2D chain on the
    one-frame-old slot (Split3D is #if 0'd out), so the first output of a
    dim-3 run is the all-zero primer frame, exactly like the binary.
    Runs on `device` (the card by default); returns np.uint16 RGB.
    graphs=True (the default) replays each frame as one CUDA graph on the
    card (utils/graphs.py; eager on the CPU); graphs=False runs it
    eagerly, for comparisons; a GraphCache is used as given."""

    def __init__(self, cfg: LegacyPALConfig = LegacyPALConfig(),
                 device=DEFAULT_DEVICE,
                 graphs: Union[bool, GraphCache] = True):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.graphs = as_cache(graphs, self.device)
        self._prev = np.zeros((L_Y, L_X), np.uint16)

    def process(self, framebuf: np.ndarray) -> np.ndarray:
        frame = np.asarray(framebuf).reshape(L_Y, L_X).astype(np.uint16)
        if self.cfg.dim >= 3:
            work, self._prev = self._prev, frame
        else:
            work = frame
        # replayed, the RGB is the graph's static output: the host copy
        # below takes it before the next frame
        rgb = comb_pal_legacy_frame(
            torch.from_numpy(work.astype(np.int32)).to(self.device),
            self.cfg, graphs=self.graphs)
        if not self.cfg.wide:
            rgb = rgb[:, CROP_X0:CROP_X0 + CROP_W]
        return rgb.cpu().numpy().astype(np.uint16)
