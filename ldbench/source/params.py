# Frozen copy of ld_decode_tpu_torch/utils/params.py at commit 84674a0, the
# constants the frozen encoder and the reference read.  Imports nothing of
# the port; a later change to the port leaves this copy as it is.
"""System/RF parameter sets for LaserDisc RF decoding.

These are the physical constants of the NTSC/PAL LaserDisc formats and the
capture hardware, expressed as frozen, hashable dataclasses.  The PyTorch
port's copy of ld_decode_tpu/utils/params.py (the port imports nothing of
the JAX package); tests/test_torch_hostcopies.py holds the two equal.

Parity notes (reference lddecode_core.py:30-117):
  * SysParams_NTSC / SysParams_PAL   -> SysParams dataclass below
  * RFParams_NTSC  / RFParams_PAL    -> RFParams dataclass below
  * calclinelen (lddecode_core.py:23-27) -> outlinelen computation
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from fractions import Fraction


@dataclass(frozen=True)
class SysParams:
    """Television-system invariants (NTSC or PAL).

    Frequencies are in Hz unless the field name says otherwise; periods in
    microseconds.  Mirrors reference lddecode_core.py:30-84.
    """

    system: str                  # 'NTSC' | 'PAL'
    fsc_mhz: float               # color subcarrier (MHz)
    pilot_mhz: float             # PAL pilot (MHz); == fsc for NTSC
    frame_lines: int             # 525 | 625
    line_period: float           # µs per line
    fps: float                   # frames per second
    ire0: float                  # FM frequency of 0 IRE (Hz)
    hz_ire: float                # Hz per IRE
    vsync_ire: float             # sync tip level in IRE
    analog_audio: bool
    audio_lfreq: float           # left audio FM carrier (Hz)
    audio_rfreq: float           # right audio FM carrier (Hz)
    philips_codelines: tuple     # VBI lines carrying Philips codes
    topfirst: bool               # does the frame start with the top field?
    outlinelen: int              # output samples per line at 4*fsc
    outlinelen_pilot: int = 0    # PAL only: output line length at 4*pilot

    @property
    def field_lines(self) -> int:
        return self.frame_lines // 2

    @property
    def audio_cfreq(self) -> float:
        return (self.audio_rfreq + self.audio_lfreq) // 2


@dataclass(frozen=True)
class RFParams:
    """Capture/decode RF filter parameters (reference lddecode_core.py:86-117)."""

    audio_notchwidth: float
    audio_notchorder: int
    video_deemp: tuple           # (t1, t2) deemphasis constants
    video_bpf: tuple             # (lo, hi) Hz
    video_bpf_order: int
    video_lpf_freq: float        # Hz
    video_lpf_order: int


def _calclinelen(line_period_us: float, mult: int, mhz: float) -> int:
    # reference lddecode_core.py:23-27
    return int(round(line_period_us * mhz * mult))


def ntsc_sys_params() -> SysParams:
    fsc = 315.0 / 88.0
    line_period = 1.0 / (fsc / 227.5)            # 63.5555... µs
    fps = 1e6 / (525 * line_period)              # 29.97...
    lrate = 1e6 * fsc / 227.5                    # color line rate (Hz)
    return SysParams(
        system='NTSC',
        fsc_mhz=fsc,
        pilot_mhz=fsc,
        frame_lines=525,
        line_period=line_period,
        fps=fps,
        ire0=8100000.0,
        hz_ire=1700000.0 / 140.0,
        vsync_ire=-40.0,
        analog_audio=True,
        audio_lfreq=lrate * 146.25,
        audio_rfreq=lrate * 178.75,
        philips_codelines=(16, 17, 18),
        topfirst=True,
        outlinelen=_calclinelen(line_period, 4, fsc),          # 910
    )


def pal_sys_params() -> SysParams:
    fsc = ((1.0 / 64.0) * 283.75) + (25.0 / 1e6)
    return SysParams(
        system='PAL',
        fsc_mhz=fsc,
        pilot_mhz=3.75,
        frame_lines=625,
        line_period=64.0,
        fps=25.0,
        ire0=7100000.0,
        hz_ire=800000.0 / 100.0,
        vsync_ire=-0.3 * (100.0 / 0.7),
        analog_audio=True,
        audio_lfreq=(1e6 / 64.0) * 43.75,
        audio_rfreq=(1e6 / 64.0) * 68.25,
        philips_codelines=(19, 20, 21),
        topfirst=False,
        outlinelen=_calclinelen(64.0, 4, fsc),                 # 1135
        outlinelen_pilot=_calclinelen(64.0, 4, 3.75),          # 960
    )


def ntsc_rf_params() -> RFParams:
    return RFParams(
        audio_notchwidth=350000.0,
        audio_notchorder=2,
        video_deemp=(120 * .32, 320 * .32),
        video_bpf=(3500000.0, 13200000.0),
        video_bpf_order=3,
        video_lpf_freq=4200000.0,
        video_lpf_order=5,
    )


def pal_rf_params() -> RFParams:
    return RFParams(
        audio_notchwidth=200000.0,
        audio_notchorder=2,
        video_deemp=(100 * .4, 400 * .4),
        video_bpf=(2500000.0, 14500000.0),
        video_bpf_order=3,
        video_lpf_freq=5200000.0,
        video_lpf_order=9,
    )


def vhs_sys_params() -> SysParams:
    """VHS/S-VHS tape FM profile (reference attic/vhs/vhs-decoder.py).

    NTSC 525/29.97 timing on the same 4*fsc output grid; what changes is
    the FM carrier map: 0 IRE at 5.4 MHz, 16 kHz/IRE (hz_ire_scale =
    (7.0-5.4 MHz)/100, vhs-decoder.py:263-266 — the S-VHS sync-tip/white
    deviation pair).  The analog audio carriers are the same 2.301136 /
    2.812499 MHz pair the attic decoder slices (vhs-decoder.py:203-204).
    VHS has no Philips VBI codes; the code lines are kept only so field
    buffers keep the common shape (their nibbles are meaningless).
    """
    base = ntsc_sys_params()
    return dataclasses.replace(
        base,
        system='VHS',
        ire0=5400000.0,
        hz_ire=1600000.0 / 100.0,
    )


def vhs_rf_params() -> RFParams:
    """Tape RF filters (reference attic/vhs/vhs-decoder.py:277-284).

    Video band 0.5-10 MHz order 2, post-demod LPF 4.4 MHz order 7; the
    deemphasis constants (25, 600) reproduce the attic's final f_deemp
    coefficients (vhs-decoder.py:184-186) to 3e-14 in our bilinear
    one-pole/one-zero convention.
    """
    return RFParams(
        audio_notchwidth=350000.0,
        audio_notchorder=2,
        video_deemp=(25.0, 600.0),
        video_bpf=(500000.0, 10000000.0),
        video_bpf_order=2,
        video_lpf_freq=4400000.0,
        video_lpf_order=7,
    )


def sys_params(system: str) -> SysParams:
    if system.upper() == 'NTSC':
        return ntsc_sys_params()
    if system.upper() == 'PAL':
        return pal_sys_params()
    if system.upper() == 'VHS':
        return vhs_sys_params()
    raise ValueError(f'unknown system {system!r}')


def rf_params(system: str) -> RFParams:
    if system.upper() == 'NTSC':
        return ntsc_rf_params()
    if system.upper() == 'PAL':
        return pal_rf_params()
    if system.upper() == 'VHS':
        return vhs_rf_params()
    raise ValueError(f'unknown system {system!r}')


@dataclass(frozen=True)
class DecoderConfig:
    """Static decode configuration (hashable).

    Block geometry mirrors reference lddecode_core.py:120-145:
    blocklen 16384, head cut 1024, tail cut = F05 group delay (32).
    """

    system: str = 'NTSC'
    freq_mhz: float = 40.0       # capture sample rate, MSa/s
    blocklen: int = 16384
    blockcut: int = 1024
    blockcut_end: int = 32
    decode_analog_audio: bool = True

    @property
    def freq_hz(self) -> float:
        return self.freq_mhz * 1e6

    @property
    def freq_hz_half(self) -> float:
        return self.freq_mhz * 1e6 / 2.0

    @property
    def freq_half(self) -> float:
        return self.freq_mhz / 2.0

    @property
    def block_keep(self) -> int:
        """Useful (non-overlap) samples produced per block."""
        return self.blocklen - self.blockcut - self.blockcut_end

    @property
    def sys(self) -> SysParams:
        return sys_params(self.system)

    @property
    def rf(self) -> RFParams:
        return rf_params(self.system)

    @property
    def linelen(self) -> int:
        """Input samples per line (reference lddecode_core.py:138-139)."""
        return int(round(self.freq_hz / (1e6 / self.sys.line_period)))

    @property
    def linelen_float(self) -> float:
        return self.freq_hz / (1e6 / self.sys.line_period)

    def iretohz(self, ire):
        return self.sys.ire0 + (self.sys.hz_ire * ire)

    def hztoire(self, hz):
        return (hz - self.sys.ire0) / self.sys.hz_ire
