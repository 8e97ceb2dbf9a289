"""PyTorch port, the NTSC comb (comb/comb_ntsc.py, comb/batch.py) against
the JAX package's, stage by stage and through the batched driver.

Inputs are the JAX-decoded frames of tests/test_comb.py::tbc_frames, varied
as tests/test_comb_batch.py varies them, so both combs see identical
frames; the JAX side runs under jax.enable_x64(False).  Budgets: stages
within 1e-6 of their output's peak (float32 sums in another order: the FIR
is a conv1d, the one-pole IIR a Toeplitz matmul); RGB of dims 1, 2 and 3
`-F` within 1 LSB (tests/test_comb_batch.py:14-19: the u16 quantisation
boundary); emission counts and line-0 words exact.

Dim 3 with optical flow: JAX's own budget between two JAX graphs is
p99.9 <= 2 LSB and max <= 16 (tests/test_comb_batch.py:82-83).  It does not
hold between the two packages, and cannot: the comb's luma is zero right
of column ~838 and above row 36, and the synthetic bars are flat within
each bar (the 1-IRE luma coring removes the +-200 noise), so Farnebäck's
2x2 systems there are near-singular and their solutions are float32
rounding noise amplified by up to 1/1e-9; any other summation order gives
other noise.  Measured (tests/torch_flow_report.py) on the noise-varied
bars: max 32,884 LSB, p99.9 14,539, up to 22% of values off by more than
2 LSB (the flow carry spreads the noise).  On frames with a smooth
texture over the picture the pixels off by more than 2 LSB stay under
0.5% (measured up to 0.14%) and p99.9 under 8 LSB (measured 5, max 125);
those are this file's flow-mode budgets, with emission counts and words
exact on both inputs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.ndimage import gaussian_filter

from ld_decode_tpu.comb import batch as JB
from ld_decode_tpu.comb import comb_ntsc as JC
from ld_decode_tpu_torch.comb import batch as TB
from ld_decode_tpu_torch.comb import comb_ntsc as TC
from tests.test_comb import tbc_frames  # noqa: F401 (fixture)

torch.set_num_threads(2)

STAGE_TOL = 1e-6


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, tol=STAGE_TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    peak = max(float(np.abs(want).max()), 1.0)
    assert np.abs(got - want).max() <= tol * peak, \
        (np.abs(got - want).max(), peak)


def _lsb(got, want):
    return np.abs(np.asarray(got).astype(np.int64)
                  - np.asarray(want).astype(np.int64))


@pytest.fixture(scope='module')
def frames6(tbc_frames):  # noqa: F811
    """tests/test_comb_batch.py::_frames6: the decoded frames plus noisy
    repeats (+-200 counts on lines 40 and up)."""
    frames = list(tbc_frames)
    rng = np.random.default_rng(7)
    while len(frames) < 6:
        base = frames[len(frames) % len(tbc_frames)].copy().reshape(525, 910)
        noise = rng.integers(-200, 200, base.shape)
        pic = base.astype(np.int64)
        pic[40:, :] = np.clip(pic[40:, :] + noise[40:, :], 0, 65535)
        frames.append(pic.astype(np.uint16).reshape(-1))
    return np.stack(frames)


@pytest.fixture(scope='module')
def textured(tbc_frames):  # noqa: F811
    """The decoded frame with a smooth texture (up to +-4000 counts, from
    line 20 and column 60 on) moving 1 px a frame sideways and 1 line
    every other frame: content on which the flow is well posed."""
    base = np.asarray(tbc_frames[0]).reshape(525, 910)
    rng = np.random.default_rng(11)
    tex = gaussian_filter(rng.normal(0, 1, (560, 960)), 2.0)
    tex = tex / np.abs(tex).max() * 4000
    out = []
    for k in range(6):
        f = base.astype(np.int64)
        t = np.roll(tex, (k // 2, k), axis=(0, 1))[:525, :910]
        f[20:, 60:] = np.clip(f[20:, 60:] + t[20:, 60:], 0, 65535)
        out.append(f.astype(np.uint16).reshape(-1))
    return np.stack(out)


@pytest.fixture(scope='module')
def planes(frames6):
    """A decoded frame as float32, plus random chroma-sized planes."""
    raw = frames6[1].reshape(525, 910).astype(np.float32)
    rng = np.random.default_rng(1)
    x = rng.normal(0, 3000, (3, 525, 910)).astype(np.float32)
    return raw, x


# ---------------------------------------------------------------------------
# stages

@pytest.mark.parametrize('name,start', [('nr', 40), ('nrc', 60),
                                        ('lp3d', 13)])
def test_causal_fir(planes, name, start):
    """jnp.convolve (a convolution) vs F.conv1d (a correlation) with the
    taps flipped: 25 (nr), 17 (nrc) and 17 (lp3d) taps."""
    x = planes[1][0]
    with jax.enable_x64(False):
        want = JC._causal_fir(jnp.asarray(x), JC.FILTERS[name], start)
    _close(TC._causal_fir(_t(x), TC.FILTERS[name], start), want)


@pytest.mark.parametrize('name', ['lpi', 'lpq'])
def test_iir1_scan(planes, name):
    """The associative scan vs the Toeplitz matmul over 453 half-columns."""
    b, a = JC.FILTERS[name]
    x = planes[1][1][:, 4::2]
    with jax.enable_x64(False):
        want = JC._iir1_scan(jnp.asarray(x), b, a)
    _close(TC._iir1_scan(_t(x), b, a), want)


def test_split_stages(planes):
    raw, x = planes
    inv = raw[:, 0] == 16384
    with jax.enable_x64(False):
        j0 = JC.split1d(jnp.asarray(raw))
        jf = JC.split1d_filtered(jnp.asarray(raw), j0, jnp.asarray(inv))
        j2 = JC.split2d(jf, jnp.asarray(np.abs(x[0]) / 3e4), True)
        j3 = JC.split3d(jnp.asarray(raw), jnp.asarray(raw + x[1] / 10),
                        jnp.asarray(raw - x[2] / 10), JC.CombConfig(dim=3))
    t0 = TC.split1d(_t(raw))
    _close(t0, j0)
    tf = TC.split1d_filtered(_t(raw), t0, _t(inv))
    _close(tf, jf)
    for g, w in zip(TC.split2d(_t(np.asarray(jf)),
                               _t(np.abs(x[0]) / 3e4), True), j2):
        _close(g, w)
    for g, w in zip(TC.split3d(_t(raw), _t(raw + x[1] / 10),
                               _t(raw - x[2] / 10), TC.CombConfig(dim=3)),
                    j3):
        _close(g, w)


def test_filter_iq_and_coring(planes):
    _, x = planes
    cfg, tcfg = JC.CombConfig(nr_c=2.0), TC.CombConfig(nr_c=2.0)
    with jax.enable_x64(False):
        ji, jq = JC.filter_iq(jnp.asarray(x[0]), jnp.asarray(x[1]), cfg)
        jy = JC.do_ynr(jnp.asarray(x[2] + 20000), cfg)
        jci, jcq = JC.do_cnr(jnp.asarray(x[0]), jnp.asarray(x[1]), cfg)
    ti, tq = TC.filter_iq(_t(x[0]), _t(x[1]), tcfg)
    _close(ti, ji)
    _close(tq, jq)
    _close(TC.do_ynr(_t(x[2] + 20000), tcfg), jy)
    tci, tcq = TC.do_cnr(_t(x[0]), _t(x[1]), tcfg)
    _close(tci, jci)
    _close(tcq, jcq)


def test_flow_luma_batched(frames6):
    win = frames6[1:4].reshape(3, 525, 910)
    cfg = JC.CombConfig(dim=3)
    with jax.enable_x64(False):
        want = jax.vmap(lambda f: JC.flow_luma(f, cfg))(jnp.asarray(win))
    got = TC.flow_luma(_t(win.astype(np.int32)), TC.CombConfig(dim=3))
    _close(got, want)


def test_field_pics_truncate_like_uint16():
    """clip + astype(uint16) truncates toward zero; so does the port's
    clamp + int32 cast, also just below an integer."""
    lum = np.zeros((525, 910), np.float32)
    lum[23, 70:75] = [2.9999998, 3.0, -0.5, 65535.9, 70000.0]
    with jax.enable_x64(False):
        want = np.asarray(JB._field_pics(jnp.asarray(lum)))
    got = TC.field_pics(_t(lum)).numpy()
    np.testing.assert_array_equal(got, want.astype(np.float32))
    np.testing.assert_array_equal(got[0, 0, :5], [2, 3, 0, 65535, 65535])


def test_to_rgb_agc_carried_across_frames(planes):
    """The burst AGC EMA runs over lines and frames (a lax.scan in JAX,
    `agc_levels` on the host here): three frames chained from the
    unseeded carry, with lines under the 3-IRE gate."""
    raw, x = planes
    cfg, tcfg = JC.CombConfig(), TC.CombConfig()
    rng = np.random.default_rng(6)
    raws = []
    for k in range(3):
        r = raw.copy()
        r[:, 1] = rng.uniform(0, 12 * 358.4, 525).astype(np.int64)
        raws.append(r)
    yiq = [(raw + 100 * k, x[0] / (k + 1), x[1]) for k in range(3)]
    want, ab = [], jnp.float32(-1.0)
    with jax.enable_x64(False):
        for r, (y, i, q) in zip(raws, yiq):
            rgb, ab = JC.to_rgb(jnp.asarray(y), jnp.asarray(i),
                                jnp.asarray(q), jnp.asarray(r), ab, cfg)
            want.append(np.asarray(rgb))
    levels, tab = TC.agc_levels(np.stack(raws)[:, :, 1], -1.0, tcfg)
    assert tab == pytest.approx(float(ab), rel=1e-6)
    for k, (y, i, q) in enumerate(yiq):
        got = TC.to_rgb(_t(y), _t(i), _t(q), _t(levels[k]), tcfg)
        assert _lsb(got, want[k]).max() <= 1


# ---------------------------------------------------------------------------
# the batched driver

def _run_port(cfg, windows, out8=False):
    comb = TB.NTSCCombBatch(cfg, out8=out8, device='cpu')
    rgbs, words = [], []
    for w in windows:
        r, wd = comb.collect(comb.feed(w))
        rgbs += r
        words += wd
    return comb, rgbs, words


def _run_jax(cfg, windows, out8=False):
    comb = JB.NTSCCombBatch(cfg, codec=False, out8=out8)
    rgbs, words = [], []
    with jax.enable_x64(False):
        for w in windows:
            r, wd = comb.collect(comb.feed(w))
            rgbs += r
            words += wd
    return comb, rgbs, words


@pytest.mark.parametrize('dim,of,split', [(1, False, 4), (2, False, 4),
                                          (3, False, 4)])
def test_batch_within_one_lsb(frames6, dim, of, split):
    """Dims 1, 2 on one window; dim 3 -F (K-map gate) across two windows
    (the ring carry)."""
    windows = [frames6[:split]] + ([frames6[split:]] if dim == 3 else [])
    _, want, wwords = _run_jax(JC.CombConfig(dim=dim, opticalflow=of),
                               windows)
    _, got, gwords = _run_port(TC.CombConfig(dim=dim, opticalflow=of),
                               windows)
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert g.dtype == np.uint16 and g.shape == (480, 744, 3)
        assert _lsb(g, w).max() <= 1
    for g, w in zip(gwords, wwords):
        np.testing.assert_array_equal(g, w)


def test_batch_flow_emissions_and_words(frames6):
    """Dim 3 with flow across two windows on the noise-varied bars: frame 0
    never emits, one frame stays pending, the line-0 words come back
    exactly.  (The RGB is not compared here: see the module docstring.)"""
    windows = [frames6[:4], frames6[4:]]
    _, want, wwords = _run_jax(JC.CombConfig(dim=3), windows)
    _, got, gwords = _run_port(TC.CombConfig(dim=3), windows)
    assert len(got) == len(want) == 4
    for g, w, f in zip(gwords, wwords, frames6[1:5]):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, f.reshape(525, 910)[0, :16])


def test_batch_flow_textured_two_windows(textured):
    """Dim 3 with flow on textured frames across two windows: the flow
    and AGC carries cross the window boundary."""
    windows = [textured[:4], textured[4:]]
    jcomb, want, wwords = _run_jax(JC.CombConfig(dim=3), windows)
    tcomb, got, gwords = _run_port(TC.CombConfig(dim=3), windows)
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        d = _lsb(g, w)
        assert (d > 2).mean() <= 0.005, (d > 2).mean()
        assert np.percentile(d, 99.9) <= 8, np.percentile(d, 99.9)
    for g, w in zip(gwords, wwords):
        np.testing.assert_array_equal(g, w)
    assert tcomb.aburstlev == pytest.approx(float(jcomb.aburstlev),
                                            rel=1e-6)
    d = np.abs(tcomb._flow.numpy() - np.asarray(jcomb._flow))
    assert np.median(d) <= 1e-3


def test_batch_out8(frames6):
    """comb -8: top byte only."""
    _, want, _ = _run_jax(JC.CombConfig(dim=2), [frames6[:3]], out8=True)
    _, got, _ = _run_port(TC.CombConfig(dim=2), [frames6[:3]], out8=True)
    assert len(got) == 3
    for g, w in zip(got, want):
        assert g.dtype == np.uint8
        assert _lsb(g, w).max() <= 1


def test_batch_pending_until_enough_frames(frames6):
    """Flow mode: frame 0 dropped, one pending -- two frames emit
    nothing, the third emits one."""
    comb = TB.NTSCCombBatch(TC.CombConfig(dim=3), device='cpu')
    assert comb.feed(frames6[:2]) is None
    rgbs, _ = comb.collect(comb.feed(frames6[2:3]))
    assert len(rgbs) == 1


def test_comb_windows_loop_depth_and_order(frames6):
    """The chain's window loop (CombWindows, ldchain_tpu.py:193-233):
    frames pushed one at a time, a window fed every 2 frames, one window
    left in flight until the next is fed or the loop drains; what it emits
    equals JAX's driver fed the same windows, in order."""
    windows = [frames6[:2], frames6[2:4], frames6[4:5]]
    _, want, wwords = _run_jax(JC.CombConfig(dim=2), windows)
    got, gwords = [], []
    loop = TB.CombWindows(
        TB.NTSCCombBatch(TC.CombConfig(dim=2), device='cpu'), 2, 1,
        lambda rgb, words: (got.append(rgb), gwords.append(words)))
    for k, f in enumerate(frames6[:5]):
        loop.push(f.reshape(525, 910))
        assert len(got) == (2 if k >= 3 else 0)
    loop.drain()
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        assert _lsb(g, w).max() <= 1
    for g, w in zip(gwords, wwords):
        np.testing.assert_array_equal(g, w)


def test_debug_surfaces_raise():
    """The batched comb refuses the debug surfaces with the JAX package's
    ValueError (ld_decode_tpu/comb/batch.py:454): they need the streaming
    NTSCComb (tests/test_torch_comb_stream.py)."""
    for kw in (dict(debug2d=True), dict(showk=True), dict(debugline=5)):
        with pytest.raises(ValueError, match='streaming NTSCComb'):
            TB.NTSCCombBatch(TC.CombConfig(**kw), device='cpu')

