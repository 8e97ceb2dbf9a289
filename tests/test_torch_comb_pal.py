"""PyTorch port, the PAL comb (comb/comb_pal.py, comb/batch.py::
PALCombBatch) against the JAX package: every function on a seeded u16
frame and on decoded `palbars` frames, the whole comb at dims 1-3, the
emission protocol of the batched comb, and the hue and luma/chroma
separation checks of tests/test_comb_pal.py on the port's own output.

Budgets: the float stages within 1e-3 of a u16 LSB (relative 1e-6 where a
value is large; the notch's two FFTs of an odd length are what is found:
NOTCH_TOL), burst angles within 0.01 degrees on lines that carry burst,
RGB within 1 LSB (u16).

The V-switch vote is a tie by construction.  Its score pairs rows l and
l+2, which every one of the four candidate row patterns treats oppositely,
so each term is -(v[l]u[l+2] + u[l]v[l+2]) whichever row is reflected: the
four scores are equal, in the port bit for bit, and the first candidate
wins.  The JAX package decides the same way on the default configuration
(its compiled graph rounds the four sums alike), which the whole-frame
tests below pin; with `colorlpf_hq=False` its fused graph rounds them
apart and rounding noise picks candidate 1 on these frames, so that option
is held at the function level (`filter_uv`) only."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ld_decode_tpu.comb import batch as JB
from ld_decode_tpu.comb import comb_pal as JP
from ld_decode_tpu.models import encode as E
from ld_decode_tpu.utils.params import DecoderConfig
from ld_decode_tpu_torch.comb import batch as TB
from ld_decode_tpu_torch.comb import comb_pal as TP
from ld_decode_tpu_torch.ops import filters as TF
from ld_decode_tpu_torch.tbc import framer as TFR
from ld_decode_tpu_torch.utils.params import DecoderConfig as TConfig

torch.set_num_threads(2)

START = 2560 * 14
PAL_Y, PAL_X = 625, 1135
STAGE_TOL = 1e-3       # u16 LSB, the comb's float stages
NOTCH_TOL = 0.1        # u16 LSB, rfft/irfft over 1135 = 5 x 227 columns
                       # (0.066 found: 17 float32 steps at 65535)


def T(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope='module')
def frames():
    """Four `palbars` frames decoded by the port on the CPU, and two more
    made from them (a luma step, a level shift) so that every frame of a
    stream differs from the others."""
    cfg = TConfig(system='PAL', freq_mhz=40.0)
    cap = E.encode_frames(DecoderConfig(system='PAL', freq_mhz=40.0), 5,
                          E.EncodeSpec(pattern='palbars',
                                       cav_start_frame=900))
    bank = TF.make_demod_bank(cfg, np.complex64, device='cpu')
    fr = TFR.Framer(cfg, bank, capture=cap, batch=8, nblocks=56,
                    device='cpu')
    out, s = [], START
    for i in range(4):
        rv = fr.readframe(None, s, i == 0)
        assert rv[0] is not None
        out.append(rv[0].reshape(PAL_Y, PAL_X))
        s = rv[2]
    a = out[1].astype(np.int32)
    a[100:200, 400:700] += 5600                       # ~30 IRE luma step
    b = out[2].astype(np.int32)
    b[24:] = b[24:] * 7 // 8 + 500
    out += [np.clip(a, 0, 65535).astype(np.uint16),
            np.clip(b, 0, 65535).astype(np.uint16)]
    return out


@pytest.fixture(scope='module')
def seeded():
    rng = np.random.default_rng(77)
    return [rng.integers(0, 65536, (PAL_Y, PAL_X)).astype(np.uint16)
            for _ in range(3)]


@pytest.fixture(params=['seeded', 'palbars'])
def trio(request, frames, seeded):
    """(prev, cur, next) as float32 arrays."""
    src = seeded if request.param == 'seeded' else frames[:3]
    return [f.astype(np.float32) for f in src]


def _close(got, want, tol=STAGE_TOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    d = np.abs(got.astype(np.float64) - want)
    assert (d <= tol + 1e-6 * np.abs(want)).all(), float(d.max())


def J(fn, *args, **kw):
    with jax.enable_x64(False):
        out = fn(*[jnp.asarray(a) if isinstance(a, np.ndarray) else a
                   for a in args], **kw)
        return jax.tree_util.tree_map(np.asarray, out)


# --------------------------------------------------------------------------
# the tables carried across

def test_config_and_notch_profile_equal():
    assert dataclasses.asdict(TP.CombPALConfig()) \
        == dataclasses.asdict(JP.CombPALConfig())
    kw = dict(dim=3, bw=True, colorlpf=True, pilot_notch=False,
              p_3dcore=2.0, brightness=200.0)
    assert dataclasses.asdict(TP.CombPALConfig(**kw)) \
        == dataclasses.asdict(JP.CombPALConfig(**kw))
    assert TP._PILOT_PROF.dtype == np.float32
    np.testing.assert_array_equal(TP._PILOT_PROF, JP._PILOT_PROF)
    assert (TP.PAL_Y, TP.PAL_X, TP.IRESCALE, TP.IREBASE, TP.VSYNC_IRE) \
        == (JP.PAL_Y, JP.PAL_X, JP.IRESCALE, JP.IREBASE, JP.VSYNC_IRE)


# --------------------------------------------------------------------------
# function by function

def test_notch_pilot(trio):
    want = J(lambda r: jnp.fft.irfft(jnp.fft.rfft(r, axis=1)
                                     * jnp.asarray(JP._PILOT_PROF),
                                     n=PAL_X, axis=1), trio[1])
    got = TP.notch_pilot(T(trio[1].astype(np.int32)))
    assert got.dtype == torch.float32 and got.shape == (PAL_Y, PAL_X)
    d = np.abs(got.numpy().astype(np.float64) - want)
    assert d.max() <= NOTCH_TOL
    # batched over a window: each frame as alone
    win = T(np.stack(trio).astype(np.int32))
    np.testing.assert_allclose(TP.notch_pilot(win)[1].numpy(), got.numpy(),
                               rtol=0, atol=NOTCH_TOL)


def test_split1d_split2d(trio):
    raw = trio[1]
    clp0 = J(JP.split1d_pal, raw)
    _close(TP.split1d_pal(T(raw)), clp0)
    for adaptive in (True, False):
        want = J(JP.split2d_pal, clp0, adaptive=adaptive)
        got = TP.split2d_pal(T(clp0), adaptive)
        for g, w in zip(got, want):
            _close(g.expand(PAL_Y, PAL_X), w)


def test_split3d(trio):
    prev, cur, nxt = trio
    cfg = JP.CombPALConfig(dim=3)
    want = J(lambda c, p, n: JP.split3d_pal(c, p, n, cfg), cur, prev, nxt)
    got = TP.split3d_pal(T(cur), T(prev), T(nxt), TP.CombPALConfig(dim=3))
    _close(got[0], want[0])
    _close(got[1], want[1], tol=1e-5)                  # a gate in 0..1


def test_split_uv_adjust_y_filter_uv(trio):
    raw = trio[1]
    clp0 = J(JP.split1d_pal, raw)
    clp1, k1, k0 = J(JP.split2d_pal, clp0, adaptive=True)
    want = J(lambda r, a, b, c, d: JP.split_uv(r, (a, b), (c, d)),
             raw, clp1, clp0, k1, k0)
    got = TP.split_uv(T(raw), (T(clp1), T(clp0)), (T(k1), T(k0)))
    for g, w in zip(got, want):
        _close(g, w)
    # outside the mask everything is exactly zero (the output's y == 0)
    assert not got[0][:24].any() and not got[0][:, :4].any()
    y, u, v = want
    want2 = J(JP.adjust_y_pal, y, u, v)
    got2 = TP.adjust_y_pal(T(y), T(u), T(v))
    for g, w in zip(got2, want2):
        _close(g, w)
    for hq in (True, False):
        jc = JP.CombPALConfig(colorlpf=True, colorlpf_hq=hq)
        tc = TP.CombPALConfig(colorlpf=True, colorlpf_hq=hq)
        want3 = J(lambda a, b: JP.filter_uv(a, b, jc), want2[1], want2[2])
        got3 = TP.filter_uv(T(want2[1]), T(want2[2]), tc)
        for g, w in zip(got3, want3):
            _close(g, w, tol=2e-3)


def test_split_functions_take_a_batch(frames):
    """A leading batch of frames gives each frame's own result."""
    win = T(np.stack(frames[:3]).astype(np.float32))
    one = TP.split2d_pal(TP.split1d_pal(win[1]), True)
    many = TP.split2d_pal(TP.split1d_pal(win), True)
    for a, b in zip(one, many):
        np.testing.assert_array_equal(
            a.expand(PAL_Y, PAL_X).numpy(),
            b.expand(3, PAL_Y, PAL_X)[1].numpy())


# --------------------------------------------------------------------------
# the whole comb

def _j_frame(cur, cfg, prev=None, nxt=None):
    with jax.enable_x64(False):
        rgb, ang = JP.comb_pal_frame(
            jnp.asarray(cur), cfg,
            None if prev is None else jnp.asarray(prev),
            None if nxt is None else jnp.asarray(nxt))
        return np.asarray(rgb), np.asarray(ang)


def _t_frame(cur, cfg, prev=None, nxt=None):
    i32 = lambda a: None if a is None else T(a.astype(np.int32))
    rgb, ang = TP.comb_pal_frame(i32(cur), cfg, i32(prev), i32(nxt))
    assert rgb.dtype == torch.int32
    return rgb.numpy(), ang.numpy()


def _rgb_close(got, want):
    assert got.shape == want.shape == (576, PAL_X, 3)
    assert got.min() >= 0 and got.max() <= 65535
    d = np.abs(got.astype(np.int64) - want.astype(np.int64))
    assert d.max() <= 1, int(d.max())


BURST_ROWS = slice(30, 300)       # rows that carry burst in both fields


@pytest.mark.parametrize('dim', [1, 2, 3])
def test_comb_frame_dims_match_jax(frames, dim):
    prev, cur, nxt = frames[0], frames[1], frames[2]
    kw = dict(prev=prev, nxt=nxt) if dim == 3 else {}
    want, wang = _j_frame(cur, JP.CombPALConfig(dim=dim), **kw)
    got, gang = _t_frame(cur, TP.CombPALConfig(dim=dim), **kw)
    _rgb_close(got, want)
    # burst angles on the lines that carry burst (elsewhere the sums are
    # ~0 and atan2 turns on rounding)
    d = np.abs(gang - wang)[BURST_ROWS]
    d = np.minimum(d, 360 - d)
    assert d.max() <= 0.01, float(d.max())
    assert want.max() > 30000                          # a real picture


def test_comb_frame_noisy_dim3(frames):
    """Decoded frames under seeded noise of +-300 LSB: the adaptive gates
    (2D k, 3D motion) sit between their ends."""
    rng = np.random.default_rng(78)
    noisy = [np.clip(f.astype(np.int32) + rng.integers(-300, 301, f.shape),
                     0, 65535).astype(np.uint16) for f in frames[:3]]
    want, _ = _j_frame(noisy[1], JP.CombPALConfig(dim=3), noisy[0],
                       noisy[2])
    got, _ = _t_frame(noisy[1], TP.CombPALConfig(dim=3), noisy[0],
                      noisy[2])
    _rgb_close(got, want)


@pytest.mark.parametrize('kw', [dict(colorlpf=True), dict(bw=True),
                                dict(pilot_notch=False)],
                         ids=['colorlpf', 'bw', 'no-notch'])
def test_comb_frame_options_match_jax(frames, kw):
    """With bw every burst sum is exactly 0: atan2(0, 0) and its sign of
    zero decide a rotation of a chroma whose magnitude is 0, so the angles
    are not compared, only the RGB."""
    want, _ = _j_frame(frames[1], JP.CombPALConfig(dim=2, **kw))
    got, _ = _t_frame(frames[1], TP.CombPALConfig(dim=2, **kw))
    _rgb_close(got, want)
    if kw.get('bw'):
        assert np.ptp(got.astype(np.int64), axis=-1).max() == 0   # grey


def _vswitch_walk(u2, v2):
    """The JAX package's choice, in float64: four candidates phase-major,
    polarity-minor, strict `>` from -inf, so the first maximum wins."""
    l = np.arange(PAL_Y)[:, None]
    best, k_best, k = -np.inf, None, 0
    for phase in range(2):
        for pol in range(2):
            flip = (((l + phase) % 4) // 2) == pol
            uc = np.where(flip, -v2, u2)[24:PAL_Y - 2, 64:PAL_X - 16:4]
            vc = np.where(flip, -u2, v2)[24:PAL_Y - 2, 64:PAL_X - 16:4]
            score = float(np.sum(uc[:-2] * uc[2:] + vc[:-2] * vc[2:]))
            if score > best:
                best, k_best = score, k
            k += 1
    return k_best


def test_vswitch_choice(frames):
    """The vote as one (4,) tensor, first maximum winning: on decoded
    frames the four scores tie (see the module docstring) and candidate 0
    wins, as the float64 walk says; a grey frame ties at exactly 0; a
    batch decides each frame as alone."""
    picked = []
    for f in frames[:3]:
        raw = TP.notch_pilot(T(f.astype(np.int32)))
        clp0 = TP.split1d_pal(raw)
        clp1, k1, k0 = TP.split2d_pal(clp0, True)
        y, u, v = TP.adjust_y_pal(*TP.split_uv(raw, (clp1, clp0), (k1, k0)))
        k = int(TP.vswitch_choice(u, v))
        assert k == 0 == _vswitch_walk(u.numpy().astype(np.float64),
                                       v.numpy().astype(np.float64))
        picked.append((u, v))
    z = torch.zeros(2, PAL_Y, PAL_X)
    assert TP.vswitch_choice(z, z).tolist() == [0, 0]
    ub = torch.stack([p[0] for p in picked])
    vb = torch.stack([p[1] for p in picked])
    assert TP.vswitch_choice(ub, vb).tolist() == [0, 0, 0]
    # first_true semantics on scores that do differ
    from ld_decode_tpu_torch.tbc.sync import first_true
    sc = torch.tensor([[1., 3., 3., 2.], [5., 5., 1., 5.], [0., 1., 2., 7.]])
    assert first_true(sc == sc.amax(-1, keepdim=True)).tolist() == [1, 0, 3]


# --------------------------------------------------------------------------
# the port is right, not only equal (tests/test_comb_pal.py:42,164)

def _bar_means(rgb):
    rows = rgb[80:400].astype(np.float64)
    a0, a1 = 90, rows.shape[1] - 40
    bw = (a1 - a0) / 7
    return [rows[:, int(a0 + k * bw + bw * 0.25):
                 int(a0 + k * bw + bw * 0.75)].mean(axis=(0, 1))
            for k in range(7)]


def test_port_hues_and_line_stability(frames):
    rgb = TP.PALComb(TP.CombPALConfig(dim=2), device='cpu').process(
        frames[0])
    assert rgb.shape == (576, PAL_X, 3) and rgb.dtype == np.uint16
    bars = _bar_means(rgb)
    assert bars[0].mean() > bars[4].mean() > bars[6].mean()
    for k in (0, 4, 6):
        r, g, b = bars[k]
        assert abs(r - b) < 0.12 * bars[k].mean(), (k, bars[k])
    assert bars[1][2] - bars[1][0] > 0.2 * bars[1].mean(), bars[1]   # +U
    assert bars[2][0] - bars[2][2] > 0.15 * bars[2].mean(), bars[2]  # +V
    assert bars[5][2] > bars[5][0], bars[5]                          # +U,-V
    # no Hanover bars: the hue does not alternate row to row
    band = rgb.astype(np.float64)[100:160, 300:340]
    per_row = (band[..., 2] - band[..., 0]).mean(axis=1)
    even, odd = per_row[0::2].mean(), per_row[1::2].mean()
    assert np.sign(even) == np.sign(odd)
    assert abs(even - odd) < 0.4 * abs(per_row.mean()), (even, odd)


def test_port_luma_chroma_separation(frames):
    """Saturated-colour interiors come out flat (adjust_y_pal subtracts
    the remodulated chroma; with the other sign the interior windows
    measure 3000-8000)."""
    rgb = TP.PALComb(TP.CombPALConfig(dim=2), device='cpu').process(
        frames[0]).astype(np.int64)
    g = rgb[120:400, :, 1]
    stds = [float(g[:, lo:lo + 40].astype(np.float64).std(axis=1).mean())
            for lo in range(100, 1020, 20)]
    assert float(np.percentile(stds, 25)) < 1200, sorted(stds)[:8]


def test_port_3d_motion_gate(frames):
    """A luma step between frames drives the 3D confidence to ~0 where it
    moved and leaves it high elsewhere."""
    f32 = lambda a: T(a.astype(np.float32))
    cfg = TP.CombPALConfig()
    _, k_static = TP.split3d_pal(f32(frames[1]), f32(frames[0]),
                                 f32(frames[2]), cfg)
    nxt = frames[2].astype(np.float32)
    nxt[100:200, 400:700] += 30 * 376.32 / 2
    _, k_moved = TP.split3d_pal(f32(frames[1]), f32(frames[0]), T(nxt), cfg)
    assert k_static[120:180, 450:650].mean() > 0.9
    assert k_moved[120:180, 450:650].mean() < 0.1
    assert k_moved[300:400, 450:650].mean() > 0.9


# --------------------------------------------------------------------------
# the batched comb

def _stream(comb, frames):
    out = [comb.process(f) for f in frames]
    return [o for o in out if o is not None], comb.flush()


def _batched(comb, frames, split):
    out = []
    for k in range(0, len(frames), split):
        rgbs, words = comb.collect(comb.feed(np.stack(frames[k:k + split])))
        assert words == [None] * len(rgbs)
        out += rgbs
    return out, comb.flush()


@pytest.mark.parametrize('dim', [2, 3])
@pytest.mark.parametrize('split', [1, 3, 8])
def test_pal_comb_batch_matches_streaming(frames, dim, split):
    """PALCombBatch against the port's own PALComb: the same frames in
    the same order, the flush tail included, for every window split."""
    cfg = TP.CombPALConfig(dim=dim)
    want, wtail = _stream(TP.PALComb(cfg, device='cpu'), frames)
    got, gtail = _batched(TB.PALCombBatch(cfg, device='cpu'), frames, split)
    n = len(frames)
    assert len(want) == len(got) == (n if dim < 3 else n - 1)
    assert (wtail is None) == (gtail is None) == (dim < 3)
    for a, b in zip(got + ([gtail] if dim == 3 else []),
                    want + ([wtail] if dim == 3 else [])):
        assert a.dtype == np.uint16 and a.shape == (576, PAL_X, 3)
        assert np.abs(a.astype(np.int64) - b.astype(np.int64)).max() <= 1
    # the frames differ, so an emission out of order would show
    assert np.abs(got[1].astype(np.int64) - got[2].astype(np.int64)
                  ).max() > 1000


@pytest.mark.parametrize('dim', [2, 3])
def test_pal_comb_batch_matches_jax(frames, dim):
    """Against the JAX PALCombBatch (raw fetch, no codec): emission counts
    per feed, order and the flush tail exact, RGB within 1 LSB."""
    with jax.enable_x64(False):
        jc = JB.PALCombBatch(JP.CombPALConfig(dim=dim), codec=False)
        want, wn = [], []
        for k in range(0, len(frames), 3):
            rgbs, _ = jc.collect(jc.feed(np.stack(frames[k:k + 3])))
            want += rgbs
            wn.append(len(rgbs))
        wtail = jc.flush()
    tc = TB.PALCombBatch(TP.CombPALConfig(dim=dim), device='cpu')
    got, gn = [], []
    for k in range(0, len(frames), 3):
        rgbs, _ = tc.collect(tc.feed(np.stack(frames[k:k + 3])))
        got += rgbs
        gn.append(len(rgbs))
    gtail = tc.flush()
    assert gn == wn == ([3, 3] if dim < 3 else [2, 3])
    assert (wtail is None) == (gtail is None)
    if wtail is not None:
        want, got = want + [np.asarray(wtail)], got + [gtail]
    for a, b in zip(got, want):
        _rgb_close(a, np.asarray(b))


def test_pal_comb_batch_out8_and_device_default(frames):
    c8 = TB.PALCombBatch(TP.CombPALConfig(dim=3), out8=True, device='cpu')
    c16 = TB.PALCombBatch(TP.CombPALConfig(dim=3), device='cpu')
    r8, _ = c8.collect(c8.feed(np.stack(frames[:3])))
    r16, _ = c16.collect(c16.feed(np.stack(frames[:3])))
    assert len(r8) == 2 and r8[0].dtype == np.uint8
    np.testing.assert_array_equal(r8[1], (r16[1] >> 8).astype(np.uint8))
    t8, t16 = c8.flush(), c16.flush()
    np.testing.assert_array_equal(t8, (t16 >> 8).astype(np.uint8))
    assert c8.collect(c8.feed(np.zeros((0, PAL_Y, PAL_X), np.uint16))) \
        == ([], [])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            TB.PALCombBatch()
        with pytest.raises(RuntimeError, match="device='cpu'"):
            TP.PALComb()


def test_comb_windows_emits_the_flush_tail(frames):
    """CombWindows.drain ends the stream with the comb's flush tail, words
    None (ldchain_tpu.py:234-239); every frame comes out once, in order."""
    cfg = TP.CombPALConfig(dim=3)
    want, wtail = _stream(TP.PALComb(cfg, device='cpu'), frames[:5])
    got = []
    win = TB.CombWindows(TB.PALCombBatch(cfg, device='cpu'), 2, 1,
                         lambda rgb, words: got.append((rgb, words)))
    for f in frames[:5]:
        win.push(torch.from_numpy(f.astype(np.int32)))
    win.drain()
    assert len(got) == 5 and all(w is None for _, w in got)
    for (a, _), b in zip(got, want + [wtail]):
        assert np.abs(a.astype(np.int64) - b.astype(np.int64)).max() <= 1
