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
import torch
from torch import nn

from ld_decode_tpu_torch.utils.device import DEFAULT as DEFAULT_DEVICE
from ld_decode_tpu_torch.utils.device import resolve as resolve_device
from ld_decode_tpu_torch.utils.params import DecoderConfig

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


class FilterBank(NamedTuple):
    video: VideoFilterSpec
    audio: Optional[AudioFilterSpec]


def design_filter_bank(cfg: DecoderConfig) -> FilterBank:
    video = design_video_filters(cfg)
    audio = design_audio_filters(cfg) if (cfg.decode_analog_audio
                                          and cfg.sys.analog_audio) else None
    return FilterBank(video=video, audio=audio)


def _onesided(F: np.ndarray) -> np.ndarray:
    return F[:len(F) // 2 + 1]


def _conj_reflect_onesided(F: np.ndarray) -> np.ndarray:
    """Q[k] = conj(F[(N-k) mod N]) for k = 0..N/2."""
    n = len(F)
    idx = (n - np.arange(n // 2 + 1)) % n
    return np.conj(F[idx])


# filter buffers of the bank, in the JAX DemodBank's field order
FILTER_NAMES = ('rf_p', 'rf_q', 'mtf_os', 'f_video_os', 'f_video05_os',
                'f_burst_os', 'f_psync_os', 'f_pilot_os',
                'a_lfilt', 'a_rfilt', 'a_lpf2_os', 'a_deemp2_os')
# static geometry of the bank
STATIC_NAMES = ('blocklen', 'f05_offset', 'a_slice_lo', 'a_stage1_len',
                'a_stage1_keep', 'a_freq_arf', 'a_freq_aud2', 'a_lowfreq',
                'a_fdiv2')


class DemodBank(nn.Module):
    """Demod filter bank in one-sided (rfft) form, as complex buffers.

    Layout (same as the JAX bank):
      * Hermitian filters: one-sided response F[0..N/2]
      * the non-Hermitian RF chain is split into P[k]=F[k] and
        Q[k]=conj(F[(N-k)%N]) so the analytic signal comes out of
        one-sided spectra only
      * the 0.5 MHz tap's 32-sample roll is folded in as a linear phase.
    Absent filters (PAL pilot on NTSC, audio when disabled) are None.
    """

    def __init__(self, arrays: Dict[str, Optional[np.ndarray]],
                 static: Dict[str, object], dtype=torch.complex64,
                 device=DEFAULT_DEVICE):
        super().__init__()
        device = resolve_device(device)
        for name in FILTER_NAMES:
            a = arrays.get(name)
            t = None if a is None else torch.as_tensor(
                np.ascontiguousarray(a)).to(dtype=dtype, device=device)
            self.register_buffer(name, t)
        for name in STATIC_NAMES:
            setattr(self, name, static[name])

    @property
    def has_audio(self) -> bool:
        return self.a_lfilt is not None

    @property
    def rdtype(self) -> torch.dtype:
        return torch.float64 if self.rf_p.dtype == torch.complex128 \
            else torch.float32

    @property
    def device(self) -> torch.device:
        return self.rf_p.device


def build_demod_bank(bank: FilterBank, cfg: DecoderConfig,
                     dtype=np.complex64, device=DEFAULT_DEVICE) -> DemodBank:
    """Derive the device-side one-sided bank from the host design bank."""
    v = bank.video
    n = cfg.blocklen
    k = np.arange(n // 2 + 1)
    roll_phase = np.exp(2j * np.pi * k * v.f05_offset / n)
    f05r = _onesided(v.f_video05) * roll_phase

    arrays = dict(
        rf_p=_onesided(v.rf_video),
        rf_q=_conj_reflect_onesided(v.rf_video),
        mtf_os=_onesided(v.mtf),
        f_video_os=_onesided(v.f_video),
        f_video05_os=f05r,
        f_burst_os=_onesided(v.f_video_burst),
        f_psync_os=_onesided(v.f_psync),
        f_pilot_os=(None if v.f_video_pilot is None
                    else _onesided(v.f_video_pilot)),
    )
    static = dict(blocklen=n, f05_offset=v.f05_offset)
    a = bank.audio
    if a is not None:
        arrays.update(a_lfilt=a.lfilt, a_rfilt=a.rfilt,
                      a_lpf2_os=_onesided(a.lpf2),
                      a_deemp2_os=_onesided(a.deemp2))
        static.update(a_slice_lo=a.slice_lo, a_stage1_len=a.stage1_len,
                      a_stage1_keep=a.stage1_keep, a_freq_arf=a.freq_arf,
                      a_freq_aud2=a.freq_aud2, a_lowfreq=a.lowfreq,
                      a_fdiv2=a.fdiv2)
    else:
        static.update(a_slice_lo=None, a_stage1_len=0, a_stage1_keep=0,
                      a_freq_arf=0.0, a_freq_aud2=0.0, a_lowfreq=0.0,
                      a_fdiv2=1)
    tdtype = torch.complex128 if np.dtype(dtype) == np.complex128 \
        else torch.complex64
    return DemodBank(arrays, static, tdtype, device)


def make_demod_bank(cfg: DecoderConfig, dtype=np.complex64,
                    device=DEFAULT_DEVICE) -> DemodBank:
    return build_demod_bank(design_filter_bank(cfg), cfg, dtype, device)


def bank_from_numpy(arrays: Dict[str, Optional[np.ndarray]],
                    static: Dict[str, object],
                    device=DEFAULT_DEVICE) -> DemodBank:
    """A bank from another implementation's filter arrays (numpy).

    `arrays` maps each name of FILTER_NAMES to a complex array, or to a
    float (..., 2) (re, im) pair array as the JAX DemodBank stores them, or
    to None; `static` holds the STATIC_NAMES geometry.  The buffer dtype
    follows the arrays' precision (float64/complex128 -> complex128)."""
    conv = {}
    wide = False
    for name in FILTER_NAMES:
        a = arrays.get(name)
        if a is None:
            conv[name] = None
            continue
        a = np.asarray(a)
        if not np.iscomplexobj(a):
            wide |= a.dtype == np.float64
            c = np.empty(a.shape[:-1], np.complex128 if a.dtype == np.float64
                         else np.complex64)
            c.real, c.imag = a[..., 0], a[..., 1]
            a = c
        else:
            wide |= a.dtype == np.complex128
        conv[name] = a
    dtype = torch.complex128 if wide else torch.complex64
    return DemodBank(conv, {k: static[k] for k in STATIC_NAMES}, dtype,
                     device)
