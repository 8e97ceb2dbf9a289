"""PyTorch port: the chain's comb and CX expander against the benchmark's
plain float64 reference (ldbench/reference/comb.py), and that reference
against the JAX package's comb, on the CPU.

The frames are seeded 525 x 910 .tbc frames made here: a luma ramp with a
smooth texture and eight colour bars, the subcarrier at 4 fsc inverting
every line and every frame, column 0 each line's burst phase flag and
column 1 its burst level, noise on every sample.  The still picture keeps
the K-map gate on its still branch (k2 = 1 almost everywhere); the picture
moving 3 px a frame takes it to its moving branch (k2 < 1 over most of
the picture, 0 in places).  The port runs as ldchain_torch.py -F runs it:
NTSCCombBatch(dim 3, no flow) through CombWindows (windows of 8 frames, 3
in flight) across three windows, so that the AGC carry and the two pending
frames cross a window.

Tolerances:
  * RGB within 1 LSB, and at most 1 % of the values off at all: the RGB
    is truncated to an integer, so a float32 value on the other side of an
    integer from the float64 one is 1 LSB off; any other difference is
    another computation;
  * the AGC carry within a relative 1e-5: the port's EMA runs in float32,
    whose update by 1 % of the difference stalls up to 50 ulps (6e-6)
    from the float64 level;
  * CX within 1 LSB (the output is truncated to 16 bits), at most 1 % of
    the samples off.
The bfloat16 control misses each of these by far.
"""

import numpy as np
import pytest
import torch
from scipy.ndimage import gaussian_filter

from ldbench.reference import comb as RC
from ld_decode_tpu_torch.audio.cx import CXExpander
from ld_decode_tpu_torch.comb import batch as TB
from ld_decode_tpu_torch.comb import comb_ntsc as TC

torch.set_num_threads(2)

IN_Y, IN_X = 525, 910
IRE = 358.4
RGB_LSB = 1
RGB_OFF_SHARE = 0.01
CARRY_REL = 1e-5
CX_LSB = 1


def make_frames(n: int, shift: int, seed: int) -> np.ndarray:
    """n frames (module docstring), the picture moving `shift` px a
    frame."""
    rng = np.random.default_rng(seed)
    wide = IN_X + 512
    tex = gaussian_filter(rng.normal(0, 1, (IN_Y, wide)), 3.0)
    tex = tex / np.abs(tex).max() * 3000
    amp = rng.uniform(8, 30, 8) * IRE
    theta = rng.uniform(0, 2 * np.pi, 8)
    h = np.arange(IN_X)
    line = np.arange(IN_Y)[:, None]
    out = []
    for f in range(n):
        pos = h - shift * f + 256
        bar = np.clip((pos - 336) // 90, 0, 7)
        luma = (1024 + (60 + 60 * (pos - 256) / IN_X) * IRE)[None, :] \
            + tex[:, np.clip(pos, 0, wide - 1)]
        odd = (line + IN_Y * f) % 2
        chroma = amp[bar][None, :] * np.cos(
            np.pi / 2 * h[None, :] + theta[bar][None, :] + np.pi * odd)
        pic = luma + chroma + rng.normal(0, 60, (IN_Y, IN_X))
        pic[:, 0] = np.where(odd[:, 0] == 0, 16384, 32768)
        pic[:, 1] = 20 * IRE + rng.normal(0, 30, IN_Y)
        out.append(np.clip(np.round(pic), 0, 65535).astype(np.uint16))
    return np.stack(out)


PICTURES = {'still': 0, 'moving': 3}


@pytest.fixture(scope='module')
def frames():
    return {k: make_frames(18, s, 20 + s) for k, s in PICTURES.items()}


@pytest.fixture(scope='module')
def ref():
    return RC.CombReference('cpu')


def _reference_rgb(ref, fr, first: int, last: int, carry: float = -1.0):
    """The reference's RGB of frames first..last-1 of `fr`, the AGC carried
    from `carry` entering `first`: (the frames, the carry after them)."""
    out = []
    for e in range(first, last):
        levels, carry = ref.agc(fr[e][:, 1], carry)
        out.append(ref.frame(fr[e - 1], fr[e], fr[e + 1], levels))
    return out, carry


def _within(got, want):
    d = np.abs(np.asarray(got).astype(np.int64) - want.astype(np.int64))
    return int(d.max()), float((d > 0).mean()), float(np.percentile(d, 99))


def _port_chain(fr, window: int = 8, depth: int = 3):
    """The port's -F comb through the chain's window loop: (RGB frames,
    their words, the AGC carry entering each window)."""
    comb = TB.NTSCCombBatch(TC.CombConfig(dim=3, opticalflow=False),
                            device='cpu', graphs=False)
    carries = []
    feed = comb.feed

    def logged(frames):
        carries.append(comb.aburstlev)
        return feed(frames)

    comb.feed = logged
    got, words = [], []
    loop = TB.CombWindows(comb, window, depth,
                          lambda rgb, w: (got.append(rgb), words.append(w)))
    for f in fr:
        loop.push(f)
    loop.drain()
    return got, words, carries


@pytest.mark.parametrize('picture', sorted(PICTURES))
def test_port_chain_comb_against_the_reference(frames, ref, picture):
    fr = frames[picture]
    got, words, carries = _port_chain(fr)
    # the ring: frame 0 is never emitted, frames 1..16 are
    assert len(got) == len(fr) - 2
    for g, w, f in zip(got, words, fr[1:]):
        assert g.dtype == np.uint16 and g.shape == (480, 744, 3)
        np.testing.assert_array_equal(w, f[0, :16])
    want, _ = _reference_rgb(ref, fr, 1, len(fr) - 1)
    for k, (g, w) in enumerate(zip(got, want)):
        big, share, _ = _within(g, w)
        assert big <= RGB_LSB and share <= RGB_OFF_SHARE, (k, big, share)
    # the windows combed frames 1-6, 7-14 and 15-16: the carry entering
    # each is the reference's after the frames before it
    into, carry = {}, -1.0
    for e in range(1, len(fr) - 1):
        into[e] = carry
        _, carry = ref.agc(fr[e][:, 1], carry)
    assert len(carries) == 3
    for c, e in zip(carries, (1, 7, 15)):
        assert c == pytest.approx(into[e], rel=CARRY_REL)


@pytest.mark.parametrize('picture', sorted(PICTURES))
def test_the_gate_takes_its_branch(frames, ref, picture):
    fr = frames[picture]
    k2 = ref.gate(fr[4], fr[6])[36:, 4:840]
    if picture == 'still':
        assert (k2 == 1).mean() > 0.99
    else:
        assert (k2 < 1).mean() > 0.5 and (k2 == 0).mean() > 0.05


@pytest.mark.parametrize('picture', sorted(PICTURES))
def test_reference_against_the_jax_comb(frames, ref, picture):
    """ld-decode's semantics: the JAX package's batched -F comb, two
    windows of 4 and 2 frames, against the reference."""
    import jax
    from ld_decode_tpu.comb import batch as JB
    from ld_decode_tpu.comb import comb_ntsc as JC
    fr = frames[picture][:6]
    comb = JB.NTSCCombBatch(JC.CombConfig(dim=3, opticalflow=False),
                            codec=False)
    got = []
    with jax.enable_x64(False):
        for w in (fr[:4], fr[4:]):
            got += comb.collect(comb.feed(w.reshape(len(w), -1)))[0]
    want, carry = _reference_rgb(ref, fr, 1, 5)
    assert len(got) == 4
    for g, w in zip(got, want):
        big, share, _ = _within(g, w)
        assert big <= RGB_LSB and share <= RGB_OFF_SHARE, (big, share)
    assert float(comb.aburstlev) == pytest.approx(carry, rel=CARRY_REL)


def test_the_bfloat16_control_fails_the_tolerances(frames, ref):
    fr = frames['moving']
    want, _ = _reference_rgb(ref, fr, 1, 3)
    got, _ = _reference_rgb(RC.CombReference('cpu', 'bfloat16'), fr, 1, 3)
    for g, w in zip(got, want):
        big, share, p99 = _within(g, w)
        assert big > 64 * RGB_LSB and share > 10 * RGB_OFF_SHARE
        assert p99 > 16 * RGB_LSB
    # and its AGC drifts from the float64 chain
    levels, _ = RC.CombReference('cpu', 'bfloat16').agc(fr[1][:, 1], -1.0)
    exact, _ = ref.agc(fr[1][:, 1], -1.0)
    assert np.abs(levels / exact - 1).max() > 100 * CARRY_REL


def _audio(frames: int, seed: int):
    """Stereo tones with a wobble and noise, cut into per-frame blocks of
    interleaved int16 (1601 or 1602 samples a channel, as the chain's
    frames carry)."""
    rng = np.random.default_rng(seed)
    n = frames * 1602
    t = np.arange(n) / 48000
    sig = np.stack([8000 * np.sin(2 * np.pi * 1000 * t)
                    * (1 + 0.5 * np.sin(2 * np.pi * 3 * t)),
                    6000 * np.sin(2 * np.pi * 3000 * t)], -1)
    pcm = (sig + rng.normal(0, 50, sig.shape)).astype(np.int16)
    cuts = np.cumsum([1601 + k % 2 for k in range(frames)])[:-1]
    return [b.reshape(-1) for b in np.split(pcm, cuts)]


@pytest.mark.parametrize('precision', ['float64', 'bfloat16'])
def test_reference_cx_against_the_port(precision):
    """The port's CXExpander over 30 frames of audio, its state carried,
    against the reference's: within 1 LSB in float64, far off in the
    bfloat16 control."""
    blocks = _audio(30, 8)
    port, cx = CXExpander(device='cpu'), RC.CXReference(precision)
    got, want = [], []
    for b in blocks:
        got.append(port.process(b))
        want.append(cx.process(b))
        assert len(want[-1]) == len(b) == len(got[-1])
    d = np.abs(np.concatenate(got).astype(np.int64)
               - np.concatenate(want).astype(np.int64))
    if precision == 'float64':
        assert d.max() <= CX_LSB and (d > 0).mean() <= 0.01
        assert (cx.fast, cx.slow) == pytest.approx((port.fast, port.slow),
                                                   rel=1e-12)
    else:
        assert np.percentile(d, 99) > 64 * CX_LSB
