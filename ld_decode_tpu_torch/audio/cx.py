"""CX noise-reduction expander (torch port of ld_decode_tpu/audio/cx.py;
reference cx-expander.cxx).

The PyTorch port's copy of the JAX package's host path (numpy/scipy; the
port imports nothing of the JAX package): tests/test_torch_hostcopies.py
holds the two equal.  The chain feeds one frame of audio at a time (about
1,600 samples), which runs the host loop.  The JAX package's block-parallel
device evaluation for file-level inputs (`envelope_followers_blocked`) is
not ported: inputs of CX_HOST_MAX samples or more raise.

Per-sample chain on 48 kHz stereo:
  * 500 Hz 4-pole butter HPF per channel feeds the envelope detector
    (filters a500_48k / a40h_48k from reference filtermaker.py:233-246)
  * dual-speed rectified envelope followers (cx-expander.cxx:53-60):
      fast' = fast*.9998;        if m > fast': fast' = min(m, fast' + m*.040)
      slow' = slow*.999985;      if m > slow': slow' = min(m, slow' + m*.0020)
  * gain 1 + val/(factor*m14db) with val = max(fast, slow) - factor*m14db,
    m14db = -14 dB, factor 6500 (cx-expander.cxx:62-75)
  * 40 Hz DC-block, x0.4 headroom (cx-expander.cxx:77-84)
"""

from __future__ import annotations

import numpy as np
import scipy.signal as sps

M14DB = 0.199526231496888
FACTOR = 6500.0
CX_HOST_MAX = 32768
FILE_CX_TODO = ('file-level CX expansion (inputs of 32768 samples or more: '
                'the block-parallel envelopes) is not ported (ROADMAP.md '
                'Queue 1, item P8)')


def _filters():
    b5, a5 = sps.butter(4, 500.0 / 24000.0, btype='highpass')
    b40, a40 = sps.butter(4, 40.0 / 24000.0, btype='highpass')
    return (np.asarray(b5), np.asarray(a5)), (np.asarray(b40), np.asarray(a40))


F500, F40 = _filters()


def envelope_followers(maxenv: np.ndarray, fast0: float = 0.0,
                       slow0: float = 0.0):
    """The dual-speed envelope recurrences as a host loop, for inputs under
    CX_HOST_MAX samples (a frame's worth of audio is ~1600)."""
    if len(maxenv) >= CX_HOST_MAX:
        raise NotImplementedError(FILE_CX_TODO)
    fast, slow = float(fast0), float(slow0)
    out_f = np.empty(len(maxenv))
    out_s = np.empty(len(maxenv))
    for i, m in enumerate(np.asarray(maxenv, np.float64)):
        fast *= .9998
        if m > fast:
            fast = min(m, fast + m * .040)
        slow *= .999985
        if m > slow:
            slow = min(m, slow + m * .0020)
        out_f[i] = fast
        out_s[i] = slow
    return out_f, out_s


class CXExpander:
    """Streaming CX expansion with carried filter/envelope state
    (bit-stream compatible with `cx <in.pcm >out.pcm`)."""

    def __init__(self):
        self.zi500_l = sps.lfilter_zi(*F500) * 0.0
        self.zi500_r = self.zi500_l.copy()
        self.zi40_l = sps.lfilter_zi(*F40) * 0.0
        self.zi40_r = self.zi40_l.copy()
        self.fast = 0.0
        self.slow = 0.0

    def process(self, pcm: np.ndarray) -> np.ndarray:
        """pcm: interleaved uint16 (offset-32768) or int16 stereo samples.
        Returns expanded interleaved uint16 like the reference tool."""
        pcm = np.asarray(pcm)
        if pcm.dtype == np.int16:
            left = pcm[0::2].astype(np.float64)
            right = pcm[1::2].astype(np.float64)
        else:
            left = pcm[0::2].astype(np.float64) - 32768.0
            right = pcm[1::2].astype(np.float64) - 32768.0

        fl, self.zi500_l = sps.lfilter(*F500, left, zi=self.zi500_l)
        frr, self.zi500_r = sps.lfilter(*F500, right, zi=self.zi500_r)
        menv = np.maximum(np.abs(fl), np.abs(frr))

        fast, slow = envelope_followers(menv, self.fast, self.slow)
        if len(fast):
            self.fast = float(fast[-1])
            self.slow = float(slow[-1])

        val = np.maximum(fast, slow) - (FACTOR * M14DB)
        val = np.maximum(val, 0.0)
        gain = M14DB * (1.0 + val / (FACTOR * M14DB))

        ol = left * gain
        orr = right * gain
        ol, self.zi40_l = sps.lfilter(*F40, ol, zi=self.zi40_l)
        orr, self.zi40_r = sps.lfilter(*F40, orr, zi=self.zi40_r)
        ol *= .4
        orr *= .4

        out = np.empty(len(ol) * 2, np.float64)
        out[0::2] = ol
        out[1::2] = orr
        return np.clip(out + 32768.0, 0, 65535).astype(np.uint16)
