"""Filter response analysis / conversion / plotting utilities.

The PyTorch port's copy of ld_decode_tpu/utils/filtertools.py (the port
imports nothing of the JAX package); tests/test_torch_hostcopies.py holds
the two equal.

Equivalents of the reference's ld_utils.py (todb, doplot family with
-3/-10 dB crossing reports, BA_to_FFT) and fft8.py (capture spectrum with
peak-to-background measurement).  Plotting requires matplotlib and is
optional; the analysis functions are plain numpy.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import scipy.signal as sps


def todb(y, zero_base: bool = False) -> np.ndarray:
    """20*log10(|y|), optionally normalized to its maximum."""
    db = 20 * np.log10(np.maximum(np.abs(y), 1e-300))
    return db - db.max() if zero_base else db


def ba_to_fft(b, a, blocklen: int) -> np.ndarray:
    """(b, a) -> whole-circle complex response (reference ld_utils.py:133)."""
    return sps.freqz(b, a, blocklen, whole=True)[1]


def response_report(b, a, freq_mhz: float = 40.0,
                    worN: int = 4096) -> dict:
    """dB-crossing report like the reference's plot helpers
    (ld_utils.py:17-77): -10/-3/+3 dB crossing frequencies and the peak."""
    w, h = sps.freqz(b, a, worN=worN)
    f = np.linspace(0, freq_mhz / 2, len(h))
    db = todb(h)
    out = {'crossings_m3': [], 'crossings_m10': [], 'crossings_p3': [],
           'peak_freq': float(f[np.argmax(db)]), 'peak_db': float(db.max())}
    for i in range(1, len(f)):
        if db[i] >= -3 > db[i - 1] or db[i] < -3 <= db[i - 1]:
            out['crossings_m3'].append(float(f[i]))
        if db[i] >= -10 > db[i - 1] or db[i] < -10 <= db[i - 1]:
            out['crossings_m10'].append(float(f[i]))
        if db[i] >= 3 > db[i - 1]:
            out['crossings_p3'].append(float(f[i]))
    return out


def capture_spectrum(samples: np.ndarray, freq_mhz: float = 40.0,
                     nfft: int = 65536) -> Tuple[np.ndarray, np.ndarray]:
    """Averaged power spectrum of a raw capture (reference fft8.py)."""
    samples = np.asarray(samples, np.float64)
    n = (len(samples) // nfft) * nfft
    if n == 0:
        raise ValueError('capture too short for nfft')
    blocks = samples[:n].reshape(-1, nfft)
    blocks = blocks - blocks.mean(axis=1, keepdims=True)
    spec = np.abs(np.fft.rfft(blocks * np.hanning(nfft)))
    psd = (spec ** 2).mean(axis=0)
    freqs = np.fft.rfftfreq(nfft, d=1.0 / freq_mhz)
    return freqs, psd


def peak_to_background_db(samples: np.ndarray, freq_mhz: float = 40.0,
                          band: Tuple[float, float] = (7.0, 10.0)) -> float:
    """Carrier peak vs background level in dB (capture QA, reference
    fft8.py's peak-to-background readout)."""
    freqs, psd = capture_spectrum(samples, freq_mhz)
    sel = (freqs >= band[0]) & (freqs <= band[1])
    peak = psd[sel].max()
    bg = np.median(psd[(freqs > 1.0) & (freqs < freq_mhz / 2 - 1.0)])
    return float(10 * np.log10(peak / bg))


def plot_filter(b, a, freq_mhz: float = 40.0, whole: bool = False,
                zero_base: bool = False, ax=None):
    """Amplitude/phase plot (reference ld_utils.py:69-77 doplot)."""
    import matplotlib.pyplot as plt
    w, h = sps.freqz(b, a, whole=whole, worN=4096)
    f = np.linspace(0, freq_mhz if whole else freq_mhz / 2, len(h))
    if ax is None:
        _, ax = plt.subplots()
    ax.plot(f, todb(h, zero_base), 'b')
    ax.set_xlabel('Frequency [MHz]')
    ax.set_ylabel('Amplitude [dB]', color='b')
    ax2 = ax.twinx()
    ax2.plot(f, np.unwrap(np.angle(h)), 'g')
    ax2.set_ylabel('Angle (radians)', color='g')
    ax.grid(True)
    return ax
