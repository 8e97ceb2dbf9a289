"""Frequency-Domain Least Squares IIR filter design (Berchin's FDLS).

The PyTorch port's copy of ld_decode_tpu/utils/fdls.py (the port imports
nothing of the JAX package); tests/test_torch_hostcopies.py holds the two
equal.

Equivalent of the reference's filter-design toolchain component
(reference fdls.py:71-148), used there to tune the de-emphasis response
against measured targets (reference README:22-24).  Implemented from the
published FDLS method: each target frequency contributes one row of a
linear regression relating the desired steady-state sinusoidal output to
lagged outputs/inputs; least squares yields the IIR (b, a).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import scipy.signal as sps


def fdls(w: np.ndarray, am: np.ndarray, th: np.ndarray,
         n_poles: int, n_zeros: int) -> Tuple[np.ndarray, np.ndarray]:
    """Design an IIR filter hitting amplitude `am` and phase `th` (radians)
    at normalized frequencies `w` (radians/sample, 0..pi).

    Returns (b, a) with len(b) = n_zeros+1, len(a) = n_poles+1, a[0] = 1.
    """
    w = np.asarray(w, np.float64)
    am = np.asarray(am, np.float64)
    th = np.asarray(th, np.float64)
    m = len(w)
    cols = n_poles + n_zeros + 1
    X = np.zeros((m, cols))
    y = am * np.cos(th)
    for k in range(1, n_poles + 1):
        X[:, k - 1] = -am * np.cos(th - k * w)      # -y(n-k)
    for k in range(0, n_zeros + 1):
        X[:, n_poles + k] = np.cos(-k * w)          # u(n-k)
    coef, *_ = np.linalg.lstsq(X, y, rcond=None)
    a = np.concatenate([[1.0], coef[:n_poles]])
    b = coef[n_poles:]
    return b, a


def fdls_from_response(freqs: np.ndarray, response: np.ndarray,
                       n_poles: int, n_zeros: int,
                       phase_mult: float = 1.0, phase_shift: float = 0.0):
    """Re-fit a measured/complex response (like the reference's
    FDLS_fromfilt, fdls.py:142-148): optionally scale/offset the phase
    target before fitting."""
    am = np.abs(response)
    th = np.unwrap(np.angle(response)) * phase_mult + phase_shift
    return fdls(np.asarray(freqs), am, th, n_poles, n_zeros)


def fdls_from_filter(b, a, n_poles: int, n_zeros: int, npoints: int = 512,
                     phase_mult: float = 1.0, phase_shift: float = 0.0):
    """Fit a lower/different-order IIR to an existing filter's response."""
    w, h = sps.freqz(b, a, worN=npoints)
    return fdls_from_response(w, h, n_poles, n_zeros, phase_mult,
                              phase_shift)
