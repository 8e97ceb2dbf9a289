"""48 kHz audio chase resampler, wow-corrected against the TBC line clock
(host copy of ld_decode_tpu/audio/downscale.py: the port imports nothing
of the JAX package; tests/test_torch_hostcopies.py holds the two equal).

Vectorized-numpy equivalent of reference lddecode_core.py:431-484
(`downscale_audio`): each 48 kHz output tick is mapped through the field's
line-location table to a fractional input sample position; the demodulated
carrier frequency at that position is wow-corrected by the local line-length
ratio, offset by the carrier frequency, and scaled to int16 (+-150 kHz full
scale).  Runs on the host — it is O(ticks-per-field) ~ 800 samples.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from ld_decode_tpu_torch.utils.params import DecoderConfig


def downscale_audio(audio: Dict[str, np.ndarray], lineinfo: np.ndarray,
                    cfg: DecoderConfig, linecount: int,
                    timeoffset: float = 0.0, freq: float = 48000.0,
                    scale: int = 64) -> Tuple[np.ndarray, float]:
    """Returns (interleaved int16 L/R samples, carry-over time offset)."""
    sp = cfg.sys
    frametime = (sp.line_period * linecount) / 1e6
    soundgap = 1.0 / freq

    ticks = np.arange(timeoffset, frametime + soundgap, soundgap,
                      dtype=np.float64)
    lineinfo = np.asarray(lineinfo, dtype=np.float64)

    linenum = ((ticks * 1e6) / sp.line_period) + 1
    li = linenum.astype(np.int64)
    li = np.clip(li, 0, len(lineinfo) - 1)
    cur = lineinfo[li]
    nxt = np.where(li + 1 < len(lineinfo), lineinfo[np.minimum(li + 1, len(lineinfo) - 1)],
                   cur + cfg.linelen)
    sampleloc = cur + (nxt - cur) * (linenum - np.floor(linenum))
    swow = (nxt - cur) / cfg.linelen
    locs = (sampleloc / scale)

    nout = len(ticks) - 1
    idx = np.clip(locs[:nout].astype(np.int64), 0,
                  len(audio['audio_left']) - 1)
    left = np.asarray(audio['audio_left'], np.float64)[idx] * swow[:nout] \
        - sp.audio_lfreq
    right = np.asarray(audio['audio_right'], np.float64)[idx] * swow[:nout] \
        - sp.audio_rfreq

    out = np.empty(nout * 2, dtype=np.int64)
    out[0::2] = np.round(left * 32767 / 150000).astype(np.int64)
    out[1::2] = np.round(right * 32767 / 150000).astype(np.int64)
    out16 = np.clip(out, -32766, 32766).astype(np.int16)

    return out16, float(ticks[-1] - frametime)
