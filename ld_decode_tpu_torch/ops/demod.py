"""Batched FM demodulation, one-sided-spectrum form (torch port of
ld_decode_tpu/ops/demod.py).

The whole overlap-save loop is one batched computation over a
`(..., nblocks, blocklen)` tensor.  FFTs go to `torch.fft` (cuFFT on the
card, pocketfft on the CPU).  The analytic signal comes from one-sided
spectra by splitting the non-Hermitian RF chain into Hermitian /
anti-Hermitian parts:
    F = Fh + i*(-i*Fa),  analytic = irfft(R*Fh) + 1j*irfft(R*Fa).
The per-sample phase advance is computed directly as
`atan2(cross, dot) mod tau`, which equals the reference's
unwrap-then-clamp sequence elementwise.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ld_decode_tpu_torch.utils.params import DecoderConfig
from ld_decode_tpu_torch.ops.filters import DemodBank

TAU = 2 * np.pi


def delta_phase(hr: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """Per-sample phase advance of an analytic signal, folded into [0, tau).
    First output sample is 0."""
    cross = hr[..., :-1] * hi[..., 1:] - hi[..., :-1] * hr[..., 1:]
    dot = hr[..., 1:] * hr[..., :-1] + hi[..., 1:] * hi[..., :-1]
    dphi = torch.remainder(torch.atan2(cross, dot), TAU)
    return F.pad(dphi, (1, 0))


def instantaneous_freq(analytic: torch.Tensor, freq_hz: float) -> torch.Tensor:
    """Instantaneous frequency in Hz of a complex analytic signal, the
    first sample 0 (reference lddutils.py:320-334).  The JAX package
    carries complex numbers as (re, im) pairs across its host boundary
    (`cx`); torch tensors are complex natively, so this takes one."""
    return delta_phase(analytic.real, analytic.imag) * (freq_hz / TAU)


def overlap_blocks(samples: torch.Tensor, cfg: DecoderConfig,
                   nblocks: int) -> torch.Tensor:
    """(..., stream_len) stream -> (..., nblocks, blocklen) overlapping
    demod blocks; block k covers samples [k*block_keep, k*block_keep +
    blocklen).  A strided view: no copy."""
    return samples.unfold(-1, cfg.blocklen, cfg.block_keep)[..., :nblocks, :]


def stream_len(cfg: DecoderConfig, nblocks: int) -> int:
    """Input samples consumed by an `nblocks` demod call."""
    return nblocks * cfg.block_keep + cfg.blockcut + cfg.blockcut_end


def _level(mtf_level, rdtype, device) -> torch.Tensor:
    if isinstance(mtf_level, torch.Tensor):
        return mtf_level.to(dtype=rdtype)
    return torch.full((), float(mtf_level), dtype=rdtype, device=device)


def demod_video_rfft(R_os: torch.Tensor, bank: DemodBank,
                     cfg: DecoderConfig, mtf_level) -> Dict[str, torch.Tensor]:
    """Demodulate one-sided RF block spectra (..., N/2+1) into the video
    taps, each (..., N) real: demod, demod_05, demod_sync, demod_burst
    [, demod_pilot]."""
    n = bank.blocklen
    rdtype = bank.rdtype
    w = bank.mtf_os ** _level(mtf_level, rdtype, R_os.device)
    p = bank.rf_p * w
    q = bank.rf_q * w
    f_h = (p + q) * 0.5
    f_a = (p - q) * (-0.5j)

    hr = torch.fft.irfft(R_os * f_h, n)
    hi = torch.fft.irfft(R_os * f_a, n)
    demod = delta_phase(hr, hi) * (cfg.freq_hz / TAU)

    D_os = torch.fft.rfft(demod)
    out_video = torch.fft.irfft(D_os * bank.f_video_os, n)
    out_video05 = torch.fft.irfft(D_os * bank.f_video05_os, n)
    out_burst = torch.fft.irfft(D_os * bank.f_burst_os, n)

    # binary slice of the -55..-25 IRE window, then one-pole LPF
    sync_bin = (out_video05 >= cfg.iretohz(-55)) \
        & (out_video05 <= cfg.iretohz(-25))
    S_os = torch.fft.rfft(sync_bin.to(rdtype))
    out_sync = torch.fft.irfft(S_os * bank.f_psync_os, n)

    out = {'demod': out_video, 'demod_05': out_video05,
           'demod_sync': out_sync, 'demod_burst': out_burst}
    if bank.f_pilot_os is not None:
        out['demod_pilot'] = torch.fft.irfft(D_os * bank.f_pilot_os, n)
    return out


def demod_audio_rfft(R_os: torch.Tensor,
                     bank: DemodBank) -> Dict[str, torch.Tensor]:
    """Stage-1 audio FM demod on the frequency-domain slice of each block.
    With one-sided spectra the negative-frequency slice is the
    conjugate-reversed positive slice.  Returns audio_left/audio_right of
    shape (..., stage1_len) in Hz."""
    a, b = bank.a_slice_lo
    lo = R_os[..., a:b]
    hi = torch.conj(R_os[..., a + 1:b + 1].flip(-1))
    sliced = torch.cat([lo, hi], dim=-1)

    out = {}
    for name, filt in (('audio_left', bank.a_lfilt),
                       ('audio_right', bank.a_rfilt)):
        z = torch.fft.ifft(sliced * filt)
        out[name] = (delta_phase(z.real, z.imag) * (bank.a_freq_arf / TAU)
                     + bank.a_lowfreq)
    return out


def demod_blocks(stream: torch.Tensor, bank: DemodBank, cfg: DecoderConfig,
                 nblocks: int, mtf_level
                 ) -> Tuple[Dict[str, torch.Tensor],
                            Optional[Dict[str, torch.Tensor]]]:
    """Demodulate (..., stream_len) streams; returns video taps
    (..., nblocks*block_keep) and audio taps (..., nblocks*stage1_keep) or
    None.  Output sample v[i] corresponds to stream sample blockcut + i."""
    blocks = overlap_blocks(stream.to(bank.rdtype), cfg, nblocks)
    R_os = torch.fft.rfft(blocks)
    lead = stream.shape[:-1]

    video = demod_video_rfft(R_os, bank, cfg, mtf_level)
    keep = cfg.block_keep
    video_out = {k: v[..., cfg.blockcut:cfg.blockcut + keep].reshape(
        *lead, -1) for k, v in video.items()}

    audio_out = None
    if bank.has_audio:
        audio = demod_audio_rfft(R_os, bank)
        dec1 = cfg.blocklen // bank.a_stage1_len
        acut = cfg.blockcut // dec1
        audio_out = {k: v[..., acut:acut + bank.a_stage1_keep].reshape(
            *lead, -1) for k, v in audio.items()}
    return video_out, audio_out


def demod_stream(samples: torch.Tensor, bank: DemodBank, cfg: DecoderConfig,
                 nblocks: int, mtf_level
                 ) -> Tuple[Dict[str, torch.Tensor],
                            Optional[Dict[str, torch.Tensor]]]:
    """Demodulate a contiguous 1-D stream of raw RF samples (exactly
    stream_len(cfg, nblocks) long) in one batched call."""
    expected = stream_len(cfg, nblocks)
    if samples.shape[-1] != expected:
        raise ValueError(
            f'demod_stream: got {samples.shape[-1]} samples, need exactly '
            f'{expected} for nblocks={nblocks} '
            f'(= nblocks*{cfg.block_keep} + '
            f'{cfg.blockcut + cfg.blockcut_end} overlap)')
    return demod_blocks(samples, bank, cfg, nblocks, mtf_level)
