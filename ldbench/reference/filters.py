# Frozen copy of the filter design of ld_decode_tpu_torch/ops/filters.py at
# commit 84674a0 (the module's design half, host numpy/scipy in float64: the
# filters ld-decode specifies; the port's device bank is left out).  It
# reads its constants from the benchmark's frozen copy of utils/params.py.
"""FFT-domain filter bank construction (torch port of ld_decode_tpu/ops/filters.py).

Design runs once on the host in float64 with numpy/scipy, exactly as in the
JAX package (the design code below is the same arithmetic, without the
pytree registration that made that module import jax).  The device-side
`DemodBank` is an `nn.Module` whose filters are native complex buffers, so
`.to(device)` moves the whole bank.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, NamedTuple, Optional

import numpy as np
import scipy.signal as sps

from ldbench.source.params import DecoderConfig

TAU = 2 * np.pi


def filtfft(filt, blocklen: int) -> np.ndarray:
    """(b, a) filter coefficients -> complex frequency response at `blocklen`
    DFT bin centers."""
    return sps.freqz(filt[0], filt[1], blocklen, whole=True)[1]


def polar2z(r: float, theta: float) -> complex:
    return r * np.exp(1j * theta)


def hilbert_kernel(terms: int = 128) -> np.ndarray:
    """FIR Hilbert-transformer kernel (inverse FFT of the ideal SSB selector)."""
    spec = np.array([0] + [1] * terms + [0] * terms, dtype=np.complex128)
    return np.fft.fftshift(np.fft.ifft(spec))


@dataclass(frozen=True)
class VideoFilterSpec:
    rf_video: np.ndarray        # BPF * audio notches * hilbert
    mtf: np.ndarray             # MTF compensation response (raised to mtf_level)
    f_video: np.ndarray         # LPF * deemphasis
    f_video05: np.ndarray       # LPF * deemp * 0.5MHz FIR
    f_video_burst: np.ndarray   # LPF * deemp * burst BPF
    f_psync: np.ndarray         # sync detector LPF
    f_emp: np.ndarray           # inverse emphasis (test-signal generation)
    f_video_pilot: Optional[np.ndarray]  # PAL only
    f05_offset: int


@dataclass(frozen=True)
class AudioFilterSpec:
    lfilt: np.ndarray
    rfilt: np.ndarray
    lpf2: np.ndarray
    deemp2: np.ndarray
    fdiv1: int
    fdiv2: int
    slice_lo: tuple
    slice_hi: tuple
    freq_arf: float
    freq_aud2: float
    lowfreq: float
    stage1_len: int
    stage1_keep: int


def deemp_ba(cfg: DecoderConfig):
    d0, d1 = cfg.rf.video_deemp
    tf_b, tf_a = sps.zpk2tf(-d1 * (10 ** -10), -d0 * (10 ** -10), d0 / d1)
    return sps.bilinear(tf_b, tf_a, 1.0 / cfg.freq_hz_half)


def emp_ba(cfg: DecoderConfig):
    d0, d1 = cfg.rf.video_deemp
    tf_b, tf_a = sps.zpk2tf(-d0 * (10 ** -10), -d1 * (10 ** -10), d1 / d0)
    return sps.bilinear(tf_b, tf_a, 1.0 / cfg.freq_hz_half)


def v05_ba(cfg: DecoderConfig):
    return sps.firwin(65, [0.5 / cfg.freq_half], pass_zero=True), [1.0]


def psync_ba(cfg: DecoderConfig):
    return sps.butter(1, 0.05 / cfg.freq_half, btype='low')


def burst_ba(cfg: DecoderConfig):
    fsc = cfg.sys.fsc_mhz
    return sps.butter(1, [(fsc - .1) / cfg.freq_half,
                          (fsc + .1) / cfg.freq_half], btype='bandpass')


def pilot_ba(cfg: DecoderConfig):
    return sps.butter(1, [3.7 / cfg.freq_half, 3.8 / cfg.freq_half],
                      btype='bandpass')


def audio_stage2_rate(cfg: DecoderConfig) -> float:
    fdiv1 = 32 if cfg.freq_mhz >= 32 else 16
    return cfg.freq_hz / (fdiv1 / 2) / 4


def audio_lpf_ba(cfg: DecoderConfig):
    return sps.firwin(65, [21000 / (audio_stage2_rate(cfg) / 2)]), [1.0]


def audio_deemp_ba(cfg: DecoderConfig):
    d75freq = 1e6 / (2 * np.pi * 75)
    return sps.butter(1, [d75freq / (audio_stage2_rate(cfg) / 2)],
                      btype='lowpass')


def design_video_filters(cfg: DecoderConfig) -> VideoFilterSpec:
    sp, dp = cfg.sys, cfg.rf
    n = cfg.blocklen
    fhz_half = cfg.freq_hz_half

    if cfg.system != 'PAL':
        poles = [polar2z(.7, np.pi * 12.5 / 20), polar2z(.7, np.pi * 27.5 / 20)]
    else:
        poles = [polar2z(.7, np.pi * 10 / 20), polar2z(.7, np.pi * 28 / 20)]
    mtf = filtfft(sps.zpk2tf([], poles, 1.11), n)

    hilbert = np.fft.fft(hilbert_kernel(), n)

    rf_bpf = sps.butter(dp.video_bpf_order,
                        [dp.video_bpf[0] / fhz_half, dp.video_bpf[1] / fhz_half],
                        btype='bandpass')
    rf_video = filtfft(rf_bpf, n)

    if sp.analog_audio:
        for carrier in (sp.audio_lfreq, sp.audio_rfreq):
            notch = sps.butter(
                dp.audio_notchorder,
                [(carrier - dp.audio_notchwidth) / fhz_half,
                 (carrier + dp.audio_notchwidth) / fhz_half],
                btype='bandstop')
            rf_video = rf_video * filtfft(notch, n)

    rf_video = rf_video * hilbert

    video_lpf = filtfft(sps.butter(dp.video_lpf_order,
                                   dp.video_lpf_freq / fhz_half, 'low'), n)
    deemp = filtfft(deemp_ba(cfg), n)
    emp = filtfft(emp_ba(cfg), n)

    f_video = video_lpf * deemp
    f05 = filtfft(v05_ba(cfg), n)
    f_video05 = f_video * f05
    f_video_burst = f_video * filtfft(burst_ba(cfg), n)

    f_video_pilot = None
    if cfg.system == 'PAL':
        f_video_pilot = f_video * filtfft(pilot_ba(cfg), n)

    f_psync = filtfft(psync_ba(cfg), n)

    return VideoFilterSpec(
        rf_video=rf_video, mtf=mtf, f_video=f_video, f_video05=f_video05,
        f_video_burst=f_video_burst, f_psync=f_psync, f_emp=emp,
        f_video_pilot=f_video_pilot, f05_offset=32,
    )


def design_audio_filters(cfg: DecoderConfig) -> AudioFilterSpec:
    """Two-stage decimating FM audio demod filters."""
    sp = cfg.sys
    n = cfg.blocklen
    fhz = cfg.freq_hz
    fhz_half = cfg.freq_hz_half

    fdiv1 = 32 if cfg.freq_mhz >= 32 else 16
    afft_halfwidth = n // (fdiv1 * 2)
    freq_arf = fhz / (fdiv1 / 2)

    cfreq = float((sp.audio_rfreq + sp.audio_lfreq) // 2)
    afft_center = int((cfreq / fhz) * n)
    afft_start = int(afft_center - afft_halfwidth)
    afft_end = int(afft_center + afft_halfwidth)

    slice_lo = (afft_start, afft_end)
    slice_hi = (n - afft_end, n - afft_start)
    stage1_len = (afft_end - afft_start) * 2

    lowfreq = cfreq - (fhz / (2 * fdiv1))

    hilbert = np.fft.fft(hilbert_kernel(), n)

    apass = 150000.0
    afilt_len = 800

    def fdslice(full: np.ndarray) -> np.ndarray:
        return np.concatenate([full[slice_lo[0]:slice_lo[1]],
                               full[slice_hi[0]:slice_hi[1]]])

    afilt_left = filtfft([sps.firwin(afilt_len,
                                     [(sp.audio_lfreq - apass) / fhz_half,
                                      (sp.audio_lfreq + apass) / fhz_half],
                                     pass_zero=False), 1.0], n)
    afilt_right = filtfft([sps.firwin(afilt_len,
                                      [(sp.audio_rfreq - apass) / fhz_half,
                                       (sp.audio_rfreq + apass) / fhz_half],
                                      pass_zero=False), 1.0], n)
    lfilt = fdslice(afilt_left * hilbert)
    rfilt = fdslice(afilt_right * hilbert)

    fdiv2 = 4
    freq_aud2 = freq_arf / fdiv2

    lpf2 = filtfft(list(audio_lpf_ba(cfg)), n // fdiv2)
    deemp2 = filtfft(list(audio_deemp_ba(cfg)), n // fdiv2)

    dec1 = n // stage1_len
    return AudioFilterSpec(
        lfilt=lfilt, rfilt=rfilt, lpf2=lpf2, deemp2=deemp2,
        fdiv1=fdiv1, fdiv2=fdiv2,
        slice_lo=slice_lo, slice_hi=slice_hi,
        freq_arf=freq_arf, freq_aud2=freq_aud2, lowfreq=lowfreq,
        stage1_len=stage1_len,
        stage1_keep=cfg.block_keep // dec1,
    )


