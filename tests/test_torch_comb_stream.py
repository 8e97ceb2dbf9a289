"""PyTorch port, the streaming NTSC comb (comb/comb_ntsc.py::NTSCComb, the
comb of ldexport and ldview) against the JAX package's NTSCComb, and its
debug surfaces.

Inputs are tests/test_torch_comb.py's frames (the JAX-decoded `bars`
frames, varied with noise, and the same frame under a moving texture); the
JAX side runs under jax.enable_x64(False).  Budgets, as for the batched
comb (tests/test_torch_comb.py): emission counts and line-0 words exact;
RGB of dims 1, 2 and 3 `-F` within 1 LSB; dim 3 with optical flow, on
textured frames, at most 0.5% of values off by more than 2 LSB and p99.9
<= 8 LSB (PERF.md section 2: the flow's near-singular systems on flat
content make any other summation order give other noise).  -D's per-line
and total MSE/ME within 1e-4 relative (float32 sums in another order); -k
and -l frames within 1 LSB, -l's exposed YIQ row within 1e-6 of its peak.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ld_decode_tpu.comb import comb_ntsc as JC
from ld_decode_tpu_torch.comb import batch as TB
from ld_decode_tpu_torch.comb import comb_ntsc as TC
from ld_decode_tpu_torch.ops import cuda_gather as CG
from tests.test_comb import tbc_frames  # noqa: F401 (fixture)
from tests.test_torch_comb import frames6, textured  # noqa: F401 (fixtures)

torch.set_num_threads(2)


def _lsb(got, want):
    return np.abs(np.asarray(got).astype(np.int64)
                  - np.asarray(want).astype(np.int64))


def _stream(comb, frames):
    outs, words = [], []
    for f in frames:
        o = comb.process(f)
        if o is not None:
            outs.append(o)
            words.append(np.array(comb.last_frame_words))
    return outs, words


def _run_both(frames, **kw):
    with jax.enable_x64(False):
        jc = JC.NTSCComb(JC.CombConfig(**kw))
        jo, jw = _stream(jc, frames)
    tc = TC.NTSCComb(TC.CombConfig(**kw), device='cpu')
    to, tw = _stream(tc, frames)
    assert len(to) == len(jo) >= 1
    for a, b in zip(tw, jw):
        np.testing.assert_array_equal(a, b)
    return jc, tc, jo, to


@pytest.mark.parametrize('dim,of', [(1, True), (2, True), (3, False)])
def test_stream_dims_within_one_lsb(frames6, dim, of):
    """Dims 1 and 2 (every frame emits) and dim 3 -F (the 3-frame ring:
    two frames pending)."""
    _, _, want, got = _run_both(frames6, dim=dim, opticalflow=of)
    assert len(got) == (6 if dim < 3 else 4)
    for g, w in zip(got, want):
        assert g.dtype == np.uint16 and g.shape == (480, 744, 3)
        assert _lsb(g, w).max() <= 1


def test_stream_flow_textured(textured):
    """Dim 3 with the Farnebäck flow on frames where it is well posed: the
    flow carry from frame to frame, frame 0 never emitted (its ring slot is
    the unused oldest input), one frame pending; K2 is the plain version
    on the CPU."""
    launches = CG.take_along_axis.launches
    _, tc, want, got = _run_both(textured[:5], dim=3)
    assert len(got) == 3
    assert CG.take_along_axis.launches == launches
    assert tc._of_count == 4 and set(tc._of_flows) == {0, 1}
    for g, w in zip(got, want):
        d = _lsb(g, w)
        assert (d > 2).mean() <= 0.005
        assert np.percentile(d, 99.9) <= 8


def test_stream_against_batch(frames6):
    """The frame-at-a-time comb writes the batched comb's stream (the
    shape of tests/test_robustness.py:309-317): -d 2 within 1 LSB, words
    equal; and dim 3 -F across windows."""
    for kw, windows in ((dict(dim=2), [frames6[:2], frames6[2:5]]),
                        (dict(dim=3, opticalflow=False),
                         [frames6[:3], frames6[3:]])):
        got, gw = _stream(TC.NTSCComb(TC.CombConfig(**kw), device='cpu'),
                          frames6[:5] if kw['dim'] == 2 else frames6)
        comb = TB.NTSCCombBatch(TC.CombConfig(**kw), device='cpu')
        want, ww = [], []
        for w in windows:
            r, wd = comb.collect(comb.feed(w))
            want += r
            ww += wd
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert _lsb(g, w).max() <= 1
        for a, b in zip(gw, ww):
            np.testing.assert_array_equal(a, b)


@pytest.fixture(scope='module')
def dbg_frames(frames6):  # noqa: F811
    """tests/test_comb_debug.py's sequence: two distinct frames in turn,
    so the 2D and 3D estimates differ."""
    f0, f1 = frames6[0], frames6[1]
    return [f0, f1, f0, f1]


def test_debug2d(dbg_frames):
    """-D (forced to dim 3 by the CLIs; flow on, as ldexport runs it):
    the 2D-3D chroma over 50-IRE gray, per-line and total MSE/ME."""
    jc, tc, want, got = _run_both(dbg_frames, dim=3, debug2d=True)
    for g, w in zip(got, want):
        assert _lsb(g, w).max() <= 1
    jd, td = jc.last_debug2d, tc.last_debug2d
    for k in ('mse_line', 'me_line'):
        assert td[k].shape == jd[k].shape == (525,)
        np.testing.assert_allclose(td[k], jd[k], rtol=1e-4,
                                   atol=1e-4 * float(np.abs(jd[k]).max()))
    assert td['mse'] == pytest.approx(jd['mse'], rel=1e-4)
    assert td['me'] == pytest.approx(jd['me'], rel=1e-4)
    assert jd['mse'] > 0


def test_debug2d_stats_stage(dbg_frames):
    rng = np.random.default_rng(5)
    a, b = rng.normal(0, 3000, (2, 525, 910)).astype(np.float32)
    with jax.enable_x64(False):
        want = JC.debug2d_stats(jnp.asarray(a), jnp.asarray(b))
    got = TC.debug2d_stats(torch.from_numpy(a), torch.from_numpy(b))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4)


@pytest.mark.parametrize('dim', [2, 3])
def test_showk(dbg_frames, dim):
    """-k: the active K-map (combk1 for dim 2, combk2 for dim 3 -F) as
    grayscale, chroma off."""
    _, _, want, got = _run_both(dbg_frames, dim=dim, opticalflow=False,
                                showk=True)
    for g, w in zip(got, want):
        assert _lsb(g, w).max() <= 1
        assert (g[..., 0] == g[..., 1]).all()           # gray


def test_debugline(dbg_frames):
    """-l: TBC line N+25 exposed before the AGC and blacked out in the
    output."""
    jc, tc, want, got = _run_both(dbg_frames[:2], dim=2, debugline=100)
    row = 100 + 25 - 38
    for g, w in zip(got, want):
        assert (g[row] == 0).all() and (w[row] == 0).all()
        assert _lsb(g, w).max() <= 1
    for k in ('y', 'i', 'q'):
        a, b = tc.last_debugline[k], jc.last_debugline[k]
        assert a.shape == b.shape == (910,)
        assert np.abs(a - b).max() <= 1e-6 * max(float(np.abs(b).max()), 1.)


def test_pulldown_through_the_stream(frames6):
    """-p: PulldownAssembler keyed by the streaming comb's
    last_frame_words, CAV and white-flag parities set in the frames'
    line-0 words: the same film frames and codes as JAX."""
    frames = frames6.copy()
    for k, fl in enumerate([0x4, 0x8, 0x0, 0x200, 0x100, 0x4]):
        frames[k, 13], frames[k, 14], frames[k, 15] = fl, 0, 900 + k
    out = []
    for mod, dev in ((JC, None), (TC, 'cpu')):
        cfg = mod.CombConfig(dim=2)
        comb = mod.NTSCComb(cfg) if dev is None else mod.NTSCComb(
            cfg, device=dev)
        pull = mod.PulldownAssembler()
        films = []
        with jax.enable_x64(False):
            for f in frames:
                rgb = comb.process(f)
                films += pull.process(rgb, comb.last_frame_words)
        out.append(films)
    (jf, tf) = out
    assert len(tf) == len(jf) >= 3
    for (a, ca), (b, cb) in zip(tf, jf):
        assert ca == cb
        assert _lsb(a, b).max() <= 1


def _luma_pair(textured):
    with jax.enable_x64(False):
        return [np.asarray(JC.flow_luma(jnp.asarray(
            f.reshape(525, 910)), JC.CombConfig(dim=3))) for f in
            textured[:3]]


def test_farneback_combk2_engines(textured):
    """The flow confidence map of both engines, three frames through the
    carries: 'cv2' calls the same OpenCV function as JAX's engine (equal
    to float32 rounding of the magnitude); 'native' runs both fields in one
    batched Farnebäck call.  Held where the flow is well posed: the comb's
    luma is flat right of column ~838 and above row 36 (ROADMAP.md Queue
    3, the rule on near-singular flow), where two implementations' flows are different
    rounding noise; inside, p99 within 0.01."""
    pytest.importorskip('cv2')
    lum = _luma_pair(textured)
    for engine in ('cv2', 'native'):
        jp, jf, tp, tf = {}, {}, {}, {}
        for k, y in enumerate(lum):
            with jax.enable_x64(False):
                want = JC.farneback_combk2(y, jp, jf, k, engine=engine)
            got = TC.farneback_combk2(torch.from_numpy(y.copy()), tp, tf, k,
                                      engine=engine).numpy()
            assert got.shape == want.shape == (525, 910)
            d = np.abs(got - want)[40:500, 80:830]
            assert np.percentile(d, 99) <= 0.01, (engine, k)
            if engine == 'cv2':
                assert d.max() <= 1e-6
            if k == 0:
                assert (got == 0).all()
        assert set(tf) == {0, 1}


def test_batch_refuses_debug_configs():
    """As the JAX package's (ld_decode_tpu/comb/batch.py:454), the batched
    comb refuses the debug surfaces, which need the streaming comb."""
    for kw in (dict(debug2d=True), dict(showk=True), dict(debugline=5)):
        with pytest.raises(ValueError, match='streaming NTSCComb'):
            TB.NTSCCombBatch(TC.CombConfig(**kw), device='cpu')
        TC.NTSCComb(TC.CombConfig(**kw), device='cpu')
