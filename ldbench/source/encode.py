# Frozen copy of ld_decode_tpu_torch/models/encode.py at commit 84674a0.  The
# one change: it reads its constants from the frozen copy of
# utils/params.py beside it, not from the port.
"""Synthetic LaserDisc RF capture generator (test fixtures + bench input).

The PyTorch port's copy of ld_decode_tpu/models/encode.py (the port imports
nothing of the JAX package); tests/test_torch_hostcopies.py holds the two
equal.

The reference repo has no checked-in fixtures; it validates against real
captures.  This module synthesizes a standards-correct composite video
waveform (NTSC first), applies the inverse-deemphasis filter (the reference
builds `Femp` "used in test signal generation", lddecode_core.py:190-192),
FM-modulates it onto the video carrier, adds the analog audio FM carriers,
and quantizes to the capture ADC range.  The output feeds both the oracle
(reference lddecode_core under pytest) and our decoder, enabling exact
parity tests without disc rips.

Timing model (NTSC, times in line periods H):
  * normal hsync at every integer H except during vertical intervals
  * field 1 VI at [0, 9): eq 3H, broad 3H, eq 3H, pulses every 0.5H
  * field 2 VI at [262.5, 271.5): same, offset half a line
  * burst + active video on normal lines; Philips codes (24-bit Manchester,
    2 µs cells) on field lines 16-18 (lddecode_core.py:814-834 slicer model)
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import scipy.signal as sps

from ldbench.source.params import DecoderConfig

TAU = 2 * np.pi


@dataclass(frozen=True)
class EncodeSpec:
    pattern: str = 'ramp'        # 'flat50' | 'ramp' | 'bars'
    philips: bool = True
    cav_start_frame: int = 1     # CAV picture number of first frame
    audio: bool = True
    audio_level: float = 0.05    # per-carrier amplitude relative to video RF
    audio_tones: Tuple[float, float] = (1000.0, 3000.0)   # L/R test tones, Hz
    audio_dev: float = 100000.0  # FM deviation, Hz
    noise_rms: float = 0.0       # additive RF noise (fraction of video RF amp)
    burst_ire: float = 20.0
    sync_ire: float = -40.0
    white_flag: bool = False     # >80 IRE flag on field line 11
    pilot_hz: float = 120000.0   # PAL pilot amplitude (Hz deviation)


def cav_frame_nibbles(frame: int) -> List[int]:
    """CAV picture-number Philips code: F8xxxx (lddecode_core.py:855-861)."""
    return [0xF, 0x8 | ((frame // 10000) & 7), (frame // 1000) % 10,
            (frame // 100) % 10, (frame // 10) % 10, frame % 10]


def nibbles_to_bits(nibbles: List[int]) -> List[int]:
    bits = []
    for n in nibbles:
        bits.extend([(n >> 3) & 1, (n >> 2) & 1, (n >> 1) & 1, n & 1])
    return bits


def _frame_pulse_schedule(frame_lines: int = 525) -> List[Tuple[float, str]]:
    """(start_time_H, kind) pulse schedule for one frame.

    NTSC: 3H eq / 3H broad / 3H eq per vertical interval.
    PAL:  2.5H / 2.5H / 2.5H (fields offset half a line the other way)."""
    sched = []
    if frame_lines == 525:
        vi, gap2 = 3.0, 262.5
        for base in (0.0, gap2):
            for k in range(int(vi * 2)):
                sched.append((base + 0.5 * k, 'eq'))
            for k in range(int(vi * 2)):
                sched.append((base + vi + 0.5 * k, 'broad'))
            for k in range(int(vi * 2)):
                sched.append((base + 2 * vi + 0.5 * k, 'eq'))
        for t in range(9, 263):
            sched.append((float(t), 'hsync'))
        for t in range(272, 525):
            sched.append((float(t), 'hsync'))
    else:
        # PAL 625: field 1 VI starts at 0, field 2 VI at 312.5; each VI is
        # 2.5H eq + 2.5H broad + 2.5H eq of half-line pulses.  All hsyncs
        # sit on the uniform 1H grid; the interlace offset lives in the
        # 312.5H field length.  Field-1 VI starts on a line boundary (both
        # bracketing gaps are full lines -> vote<0, istop=True per
        # lddecode_core.py:562-584); field-2 VI starts mid-line (half-line
        # gaps -> vote +1, istop=False).
        for base in (0.0, 312.5):
            for k in range(5):
                sched.append((base + 0.5 * k, 'eq'))
            for k in range(5):
                sched.append((base + 2.5 + 0.5 * k, 'broad'))
            for k in range(5):
                sched.append((base + 5.0 + 0.5 * k, 'eq'))
        for t in range(8, 312):
            sched.append((float(t), 'hsync'))
        for t in range(320, 625):
            sched.append((float(t), 'hsync'))
    return sched


PAL_BARS_UV = [     # (luma IRE, U IRE, V IRE) per bar
    (80.0, 0.0, 0.0), (60.0, 15.0, 0.0), (60.0, 0.0, 15.0),
    (45.0, -12.0, 8.0), (45.0, 0.0, 0.0), (30.0, 10.0, -10.0),
    (20.0, 0.0, 0.0),
]


def _active_pattern(spec: EncodeSpec, x: np.ndarray, line_in_field: int,
                    t_abs_us: np.ndarray, fsc_mhz: float,
                    vswitch: float = 1.0) -> np.ndarray:
    """IRE values for the active-video portion of a line.

    x: position within active region in [0,1).  t_abs_us: absolute time of
    each sample (for subcarrier-locked chroma).  vswitch: PAL V-component
    sign for this line (+1/-1), ignored by the NTSC patterns.
    """
    if spec.pattern == 'palbars':
        idx = np.minimum((x * len(PAL_BARS_UV)).astype(np.int64),
                         len(PAL_BARS_UV) - 1)
        arr = np.array(PAL_BARS_UV)
        y = arr[idx, 0]
        u = arr[idx, 1]
        v = arr[idx, 2] * vswitch
        w = TAU * fsc_mhz * t_abs_us
        return y + u * np.sin(w) + v * np.cos(w)
    if spec.pattern == 'flat50':
        return np.full_like(x, 50.0)
    if spec.pattern == 'ramp':
        # luma ramp 10..90 IRE plus a mid-line chroma packet
        y = 10.0 + 80.0 * x
        chroma = 20.0 * np.sin(TAU * fsc_mhz * t_abs_us)
        gate = ((x > 0.4) & (x < 0.7)).astype(np.float64)
        return y + chroma * gate
    if spec.pattern == 'bars':
        # 7 luma steps with subcarrier on alternating bars
        idx = np.minimum((x * 7).astype(np.int64), 6)
        levels = np.array([80.0, 70.0, 60.0, 50.0, 40.0, 30.0, 20.0])
        y = levels[idx]
        chroma = 20.0 * np.sin(TAU * fsc_mhz * t_abs_us)
        return y + chroma * (idx % 2 == 1)
    raise ValueError(f'unknown pattern {spec.pattern!r}')


def render_composite_ire(cfg: DecoderConfig, nframes: int,
                         spec: EncodeSpec = EncodeSpec()) -> np.ndarray:
    """Render `nframes` NTSC frames of composite video, in IRE, at the
    capture sample rate.  Starts at the top of a field-1 vertical interval."""
    sp = cfg.sys
    fs = cfg.freq_mhz                 # samples per µs
    H = sp.line_period                # µs
    fsc = sp.fsc_mhz

    total_us = nframes * sp.frame_lines * H
    n = int(np.ceil(total_us * fs)) + 16
    ire = np.zeros(n, dtype=np.float64)

    hsync_w, eq_w = 4.7, 2.3
    broad_w = H / 2 - 4.7
    burst_start, burst_end = 5.3, 7.8
    active_start, active_end = 9.4, H - 1.5

    def paint(t0_us, t1_us, value):
        i0, i1 = int(np.ceil(t0_us * fs)), int(np.ceil(t1_us * fs))
        i0, i1 = max(i0, 0), min(i1, n)
        if i1 > i0:
            ire[i0:i1] = value

    def paint_burst(t0_us, t1_us, amp, phase_deg=0.0):
        i0, i1 = int(np.ceil(t0_us * fs)), int(np.ceil(t1_us * fs))
        i0, i1 = max(i0, 0), min(i1, n)
        if i1 > i0:
            t = np.arange(i0, i1) / fs
            ire[i0:i1] += amp * np.sin(TAU * fsc * t
                                       + phase_deg * np.pi / 180.0)

    sched = _frame_pulse_schedule(sp.frame_lines)
    widths = {'hsync': hsync_w, 'eq': eq_w, 'broad': broad_w}
    half = sp.frame_lines / 2.0               # 262.5 / 312.5
    first_active = 21 if sp.frame_lines == 525 else 23

    for f in range(nframes):
        f_t0 = f * sp.frame_lines * H
        for (tH, kind) in sched:
            t0 = f_t0 + tH * H
            paint(t0, t0 + widths[kind], spec.sync_ire)

        # serration "high" part after each broad pulse is blanking: already 0.

        # content on normal lines
        for (tH, kind) in sched:
            if kind != 'hsync':
                continue
            t0 = f_t0 + tH * H
            # which field/line is this?  decoder field line numbering counts
            # from the last regular hsync before vsync (see SURVEY §2.1):
            # field 1: line L starts at (L-1)*H; field 2 offset by the
            # half-line field length.
            if tH < half:
                fieldno, fline = 1, int(round(tH)) + 1
            else:
                fieldno, fline = 2, int(round(tH - half + 0.5))

            # PAL swinging burst: +-135 degrees with the V switch
            vswitch = 1.0
            if sp.system == 'PAL':
                vswitch = 1.0 if (int(round(tH * 2)) // 2) % 2 == 0 else -1.0
                paint_burst(t0 + burst_start, t0 + burst_end, spec.burst_ire,
                            135.0 if vswitch > 0 else -135.0)
            else:
                paint_burst(t0 + burst_start, t0 + burst_end, spec.burst_ire)

            # CAV picture numbers live on one field per frame (the CAV
            # pairing logic, lddecode_core.py:1273-1274, depends on this)
            if spec.philips and fline in sp.philips_codelines \
                    and fieldno == 1:
                framenr = spec.cav_start_frame + f
                bits = nibbles_to_bits(cav_frame_nibbles(framenr))
                cell_us = 2.0
                code_t0 = t0 + 10.8
                for b, bit in enumerate(bits):
                    c0 = code_t0 + b * cell_us
                    if bit:   # Manchester '1': low then high (rising mid-cell)
                        paint(c0, c0 + 1.0, 0.0)
                        paint(c0 + 1.0, c0 + 2.0, 90.0)
                    else:     # '0': high then low (falling mid-cell)
                        paint(c0, c0 + 1.0, 90.0)
                        paint(c0 + 1.0, c0 + 2.0, 0.0)
                continue

            if spec.white_flag and fline == 11:
                paint(t0 + active_start, t0 + active_end, 90.0)
                continue

            if fline >= first_active:
                i0 = int(np.ceil((t0 + active_start) * fs))
                i1 = min(int(np.ceil((t0 + active_end) * fs)), n)
                if i1 > i0:
                    t_abs = np.arange(i0, i1) / fs
                    x = (t_abs - (t0 + active_start)) / (active_end - active_start)
                    ire[i0:i1] = _active_pattern(spec, x, fline, t_abs, fsc,
                                                 vswitch)

    if sp.system == 'PAL' and spec.pilot_hz > 0:
        # 3.75 MHz pilot over the whole line incl. sync (the reference's
        # pilot TBC reads the sync region, lddecode_core.py:973-975)
        t = np.arange(n) / fs
        ire += (spec.pilot_hz / sp.hz_ire) * np.sin(TAU * sp.pilot_mhz * t)

    return ire


def modulate(cfg: DecoderConfig, ire: np.ndarray,
             spec: EncodeSpec = EncodeSpec(),
             seed: int = 0, extra_baseband: np.ndarray = None) -> np.ndarray:
    """IRE composite -> emphasized FM RF + audio carriers -> uint16 samples.

    extra_baseband: optional waveform summed into the composite RF before
    quantization (units of video-RF amplitude, caller pre-scales) — used
    to mix the EFM digital-audio baseband under the carriers the way a
    real disc does (reference attic2/cd-decoder.py:330-470 consumes that
    band)."""
    sp, dp = cfg.sys, cfg.rf
    fs_hz = cfg.freq_hz

    hz = sp.ire0 + sp.hz_ire * ire

    # pre-emphasis: exact inverse of the decode deemphasis
    # (reference lddecode_core.py:190-192, Femp)
    d0, d1 = dp.video_deemp
    tf_b, tf_a = sps.zpk2tf(-d0 * 1e-10, -d1 * 1e-10, d1 / d0)
    emp_b, emp_a = sps.bilinear(tf_b, tf_a, 1.0 / cfg.freq_hz_half)
    hz = sps.lfilter(emp_b, emp_a, hz - sp.ire0) + sp.ire0

    phase = np.cumsum(hz) * (TAU / fs_hz)
    rf = np.cos(phase)

    n = len(ire)
    t = np.arange(n) / fs_hz
    if spec.audio and sp.analog_audio:
        fl, fr = spec.audio_tones
        beta_l = spec.audio_dev / fl
        beta_r = spec.audio_dev / fr
        rf = rf + spec.audio_level * np.cos(
            TAU * sp.audio_lfreq * t + beta_l * np.sin(TAU * fl * t))
        rf = rf + spec.audio_level * np.cos(
            TAU * sp.audio_rfreq * t + beta_r * np.sin(TAU * fr * t))

    if extra_baseband is not None:
        m = min(n, len(extra_baseband))
        rf[:m] = rf[:m] + extra_baseband[:m]

    if spec.noise_rms > 0:
        rng = np.random.default_rng(seed)
        rf = rf + rng.normal(0.0, spec.noise_rms, n)

    # scale into a 10-bit-ish ADC range, like unpacked .lds data
    out = np.round(rf * 350.0 + 512.0)
    return np.clip(out, 0, 1023).astype(np.uint16)


def encode_frames(cfg: DecoderConfig, nframes: int,
                  spec: EncodeSpec = EncodeSpec(), seed: int = 0,
                  extra_baseband: np.ndarray = None) -> np.ndarray:
    """Full synthetic capture: composite render + FM modulation."""
    ire = render_composite_ire(cfg, nframes, spec)
    return modulate(cfg, ire, spec, seed, extra_baseband=extra_baseband)
