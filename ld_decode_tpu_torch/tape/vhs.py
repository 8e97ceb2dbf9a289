"""VHS/S-VHS tape FM video decode (reference attic/vhs/vhs-decoder.py),
torch port of ld_decode_tpu/tape/vhs.py.

The reference's VHS experiment is a parameterized FM decoder: video
bandpass 0.5-10 MHz, Hilbert demod, 4.4 MHz LPF + tape deemphasis, and
the u16 output scale minire -60 / maxire 140 at 655.34 counts per 100
IRE (vhs-decoder.py:263-268, 456).  It has no TBC and no chroma path.
This module reproduces it through the standard batched demod bank
(`DecoderConfig(system='VHS')` selects the tape carrier map and filter
set in utils/params.py), so the hot path is the same overlap-save rfft
pipeline (cuFFT on the card) the LaserDisc profiles use, plus the analog
audio chain.  The laserdisc TBC refuses the profile (tbc/fused.py
`require_tbc`), as the JAX package's does.

What changed in the port: `luma_to_u16` returns int32 holding the u16
values (made np.uint16 on the host), and `recover_color_under` runs its
two FFT filter passes on the samples' device.  tests/test_torch_vhs.py
holds each function to the JAX package's.

Tape notes: VHS has no MTF (a LaserDisc pickup phenomenon), so decodes
always run mtf_level=0; head-switch transients show up as brief FM
dropouts.
"""

from __future__ import annotations

from typing import Dict, Tuple, Union

import numpy as np
import scipy.signal as sps
import torch

from ld_decode_tpu_torch.ops import demod as D
from ld_decode_tpu_torch.ops.filters import DemodBank, filtfft, make_demod_bank
from ld_decode_tpu_torch.utils.device import DEFAULT as DEFAULT_DEVICE
from ld_decode_tpu_torch.utils.graphs import GraphCache, api_cache, owned
from ld_decode_tpu_torch.utils.params import DecoderConfig

# u16 output scale (reference attic/vhs/vhs-decoder.py:263-268)
MIN_IRE = -60.0
MAX_IRE = 140.0
OUT_SCALE = 65534.0 / (MAX_IRE - MIN_IRE)


def vhs_config(freq_mhz: float = (315.0 / 88.0) * 8.0,
               **kw) -> DecoderConfig:
    """Tape decode configuration.  The default rate is the attic
    experiment's 8*fsc capture (vhs-decoder.py:15)."""
    return DecoderConfig(system='VHS', freq_mhz=freq_mhz, **kw)


def make_vhs_bank(cfg: DecoderConfig, dtype=np.complex64,
                  device=DEFAULT_DEVICE) -> DemodBank:
    assert cfg.system == 'VHS', cfg.system
    return make_demod_bank(cfg, dtype=dtype, device=device)


def luma_to_u16(cfg: DecoderConfig, demod_hz: torch.Tensor) -> torch.Tensor:
    """Demodulated Hz -> the attic's uint16 luma scale
    (vhs-decoder.py:263-268: minn = ire0 + hz_ire*minire, 327.67/IRE), as
    int32.  torch.round rounds half to even, as jnp.round does."""
    ire = (demod_hz - cfg.sys.ire0) / cfg.sys.hz_ire
    out = (ire - MIN_IRE) * OUT_SCALE
    return torch.clamp(torch.round(out), 0, 65535).to(torch.int32)


def decode_vhs(samples: torch.Tensor, bank: DemodBank, cfg: DecoderConfig,
               nblocks: int, graphs: Union[bool, GraphCache] = True
               ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """Demodulate a tape RF stream (exactly stream_len(cfg, nblocks) long)
    on the samples' device: returns (video, audio) dicts.

    video: 'luma' (int32 holding u16 values, attic scale), 'demod' (Hz),
    'demod_sync' (the sync-detector channel: find_sync_peaks locks onto the
    tape line pitch, but the laserdisc TBC does not take the VHS profile).
    audio: instantaneous carrier Hz per channel at the stage-1 decimated
    rate (empty dict when audio is disabled).

    graphs=True (the default; the JAX package jits `demod_stream`) replays
    the demod and the luma scale as one CUDA graph a (window length,
    nblocks) key on the card, the bank read in place, and returns clones
    of its outputs (utils/graphs.py::api_cache; eager on the CPU); False
    runs it eagerly; a GraphCache is used as given and returns its static
    outputs."""
    assert cfg.system == 'VHS', cfg.system
    cache, clone = api_cache(graphs, samples.device)

    def run(x):
        video, audio = D.demod_stream(x, bank, cfg, nblocks, 0.0)
        video = dict(video)
        video['luma'] = luma_to_u16(cfg, video['demod'])
        return video, dict(audio) if audio else {}

    out = cache(('decode_vhs', cfg, samples.shape[-1], nblocks), run,
                (samples,), reads=tuple(bank.buffers()))
    return owned(out) if clone else out


# ---------------------------------------------------------------------------
# Color-under chroma (beyond the reference: the attic experiment was
# luma-only).  VHS records chroma by heterodyning the fsc-centred band
# down to 40*f_H = 629.37 kHz (NTSC) and adding it to the tape signal as
# baseband AM below the luma FM carrier.  Recovery is the inverse
# heterodyne: bandpass the RF, multiply by the conversion carrier, and
# bandpass the product back at fsc for the standard comb machinery.

def color_under_freq(cfg: DecoderConfig) -> float:
    """NTSC VHS down-converted chroma carrier: 40 x line rate (Hz)."""
    return 40.0 * 1e6 / cfg.sys.line_period


def encode_color_under(cfg: DecoderConfig, chroma_at_fsc: np.ndarray,
                       phase0: float = 0.0) -> np.ndarray:
    """Heterodyne an fsc-centred chroma signal down to the color-under
    band (what a VHS recorder writes): x * 2cos(2pi(fsc - f_cu)t),
    lowpassed below luma.  Host-side fixture helper (float64 phase)."""
    fs = cfg.freq_hz
    f_conv = cfg.sys.fsc_mhz * 1e6 - color_under_freq(cfg)
    t = np.arange(len(chroma_at_fsc), dtype=np.float64) / fs
    mixed = chroma_at_fsc * 2.0 * np.cos(2 * np.pi * f_conv * t + phase0)
    b, a = sps.butter(3, 1.2e6 / (fs / 2), btype='low')
    return sps.filtfilt(b, a, mixed)


def recover_color_under(samples: torch.Tensor, cfg: DecoderConfig,
                        blocklen: int = None, phase0: float = 0.0
                        ) -> torch.Tensor:
    """Tape RF (1-D) -> chroma restored at fsc, float32 on the samples'
    device.

    A bandpass below the luma FM carrier isolates the color-under band;
    multiplying by the conversion carrier relocates it to fsc (plus an
    image at fsc - 2*f_cu that the output bandpass rejects).  Both filters
    are zero-phase (|H|^2, the frequency-domain filtfilt), built on the
    host and applied by one rfft/irfft pair each on the device.  The
    conversion carrier is a free-running oscillator with `phase0`, built
    in float64 on the host (float32 cosine arguments lose precision after
    ~0.1 s); a tape TBC would phase-lock it to the burst of each line.
    `blocklen` is the JAX package's signature; neither package reads it."""
    n = samples.shape[-1]
    dev = samples.device
    fs = cfg.freq_hz
    f_cu = color_under_freq(cfg)
    f_conv = cfg.sys.fsc_mhz * 1e6 - f_cu
    fsc = cfg.sys.fsc_mhz * 1e6

    # bandpass, not lowpass: DC/hum in the tape signal would otherwise
    # mix onto the conversion carrier frequency right at the output band
    # edge and swamp the restored chroma
    cu_lpf = filtfft(sps.butter(3, [1e5 / (fs / 2), 1.2e6 / (fs / 2)],
                                btype='bandpass'), n)
    cu_lpf = (cu_lpf * np.conj(cu_lpf)).real
    out_bpf = filtfft(sps.butter(4, [(fsc - 5e5) / (fs / 2),
                                     (fsc + 5e5) / (fs / 2)],
                                 btype='bandpass'), n)
    out_bpf = (out_bpf * np.conj(out_bpf)).real
    t = np.arange(n, dtype=np.float64) / fs
    carrier = (2.0 * np.cos(2 * np.pi * f_conv * t + phase0)
               ).astype(np.float32)

    def on_dev(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)

    x = torch.fft.irfft(torch.fft.rfft(samples.to(torch.float32))
                        * on_dev(cu_lpf[:n // 2 + 1]), n)
    up = x * on_dev(carrier)
    return torch.fft.irfft(torch.fft.rfft(up)
                           * on_dev(out_bpf[:n // 2 + 1]), n)
