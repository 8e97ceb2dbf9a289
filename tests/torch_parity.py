"""Shared budgets for the PyTorch port's parity tests against the JAX
package (tests/test_torch_*.py)."""

import numpy as np

LOC_TOL = 0.02             # line locations, px (README.md accuracy budget)
AUDIO_RMS = 0.6            # audio, LSB rms (README.md accuracy budget)
PIC_P999, PIC_MAX = 2, 4   # picture rows >= 24, u16 LSB (test_pipeline.py,
                           # drive_verify.py)
# The 48 kHz chase resampler takes the stage-2 sample nearest below each
# tick (a 1.6 us grid).  The JAX package's compiled graph rounds a tick's
# line number differently from float32-by-float32 evaluation (its fused
# multiply-adds and reciprocals move a tick by ~0.04 samples), so a tick
# within that distance of a grid boundary can take the neighbouring
# sample: a jump of up to a few hundred LSB on a 3 kHz test tone, where
# float rounding alone moves a value by at most an LSB.  Such ticks are
# counted, not averaged in.
AUDIO_PICK_LSB = 8
AUDIO_PICK_MAX = 0.005     # at most 0.5% of the ticks


def assert_audio_close(got: np.ndarray, want: np.ndarray):
    assert got.shape == want.shape and got.size > 0
    d = np.abs(got.astype(np.float64) - want)
    picks = d > AUDIO_PICK_LSB
    assert picks.mean() <= AUDIO_PICK_MAX, int(picks.sum())
    assert np.sqrt(np.mean(d[~picks] ** 2)) <= AUDIO_RMS


def assert_picture_close(got: np.ndarray, want: np.ndarray):
    """Pictures as (..., lines, width); rows 24+ of each field/frame."""
    d = np.abs(got[..., 24:, :].astype(np.int64)
               - want[..., 24:, :].astype(np.int64))
    assert np.percentile(d, 99.9) <= PIC_P999
    assert d.max() <= PIC_MAX


# PAL on `palbars`: the tail gap sanitizer of `_hsync_refine` (JAX and port
# alike) rewrites the last 10 lines of a field as a running sum that reaches
# 25,600 samples, where one float32 step is 2^-9 px, so an input difference
# of 4e-5 px can move such a line by one step; on the full-amplitude
# subcarrier (as steep as 10^4 LSB a pixel) that is up to 8 LSB.
TAIL_ROWS = 11         # picture rows that read a tail-sanitized line
TAIL_MAX = 16          # LSB, on those rows (8 found)


def assert_pal_picture(got, want, rows=312, per_row=1):
    """Pictures (..., rows*per_row, 1135): the budget of torch_parity on
    the rows before the tail-sanitized ones, TAIL_MAX on those."""
    cut = (rows - TAIL_ROWS) * per_row
    assert_picture_close(got[..., :cut, :], want[..., :cut, :])
    d = np.abs(got[..., cut:rows * per_row, :].astype(np.int64)
               - want[..., cut:rows * per_row, :].astype(np.int64))
    assert d.max() <= TAIL_MAX
