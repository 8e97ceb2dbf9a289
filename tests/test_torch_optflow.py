"""PyTorch port, the Farnebäck optical flow (comb/optflow.py) against the JAX
package's, stage by stage and whole.

Inputs: a smooth random texture (scipy, from a numpy seed) and the same
texture shifted by (1, -2) px, quantised to 16 bits, at the comb's field
size 252 x 840.  Each stage of the port is fed JAX's output of the stage
before it.  Budgets: every stage within 1e-5 of its output's peak
magnitude (float32 sums taken in another order: the port's correlations
are matmuls of unfolded windows, its box blur sums in float64, the resize
is two matmuls); the gather bit-exact; the whole flow p99 |d| <= 0.01 px
and max <= 0.05 px, the comb's confidence 1 - clip(|flow|/0.5) mean |d|
<= 1e-3.  The JAX side runs under jax.enable_x64(False)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.ndimage import gaussian_filter, shift as nd_shift

from ld_decode_tpu.comb import optflow as JO
from ld_decode_tpu_torch.comb import optflow as TO
from ld_decode_tpu_torch.ops import gather as G

torch.set_num_threads(2)

H, W = 252, 840
STAGE_TOL = 1e-5


def _t(a):
    return torch.from_numpy(np.array(a))[None]


def _close(got, want, tol=STAGE_TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    peak = float(np.abs(want).max())
    assert np.abs(got - want).max() <= tol * peak, \
        (np.abs(got - want).max(), peak)


@pytest.fixture(scope='module')
def pair():
    rng = np.random.default_rng(0)
    base = gaussian_filter(rng.normal(0, 1, (H + 40, W + 40)), 3)
    base = (base - base.min()) / np.ptp(base) * 50000 + 5000
    a = base[20:20 + H, 20:20 + W]
    b = nd_shift(base, (-2, 1), order=3)[20:20 + H, 20:20 + W]
    q = lambda x: np.floor(x).astype(np.float32)
    return q(a), q(b)


@pytest.fixture(scope='module')
def stages(pair):
    """JAX's stage outputs at the full level, from a zero initial flow."""
    a, b = pair
    with jax.enable_x64(False):
        R0 = JO.poly_expansion(jnp.asarray(a), 7, 1.5)
        R1 = JO.poly_expansion(jnp.asarray(b), 7, 1.5)
        R1q = JO._quad_expand(R1)
        bscale = jnp.asarray(JO._border_scale(H, W))
        flow = jnp.asarray(np.random.default_rng(3).normal(
            0, 1.5, (H, W, 2)).astype(np.float32))
        M = JO._update_matrices(R0, R1q, flow, bscale)
        Mb = JO._box_blur(M, 60)
        out = dict(R0=R0, R1=R1, R1q=R1q, bscale=bscale, flow=flow, M=M,
                   Mb=Mb, F=JO._solve_flow(Mb))
        return {k: np.asarray(v) for k, v in out.items()}


def test_poly_expansion(pair, stages):
    _close(TO.poly_expansion(_t(pair[0]), 7, 1.5)[0], stages['R0'])


def test_quad_expand_exact(stages):
    np.testing.assert_array_equal(TO._quad_expand(_t(stages['R1']))[0],
                                  stages['R1q'])


def test_bilinear_gather_quad_exact(stages):
    """Warp sampling through K2's plain version: the same float32 ops in
    the same order as JAX, so bit-equal."""
    yy, xx = np.meshgrid(np.arange(H, dtype=np.float32),
                         np.arange(W, dtype=np.float32), indexing='ij')
    fx = xx + stages['flow'][..., 0]
    fy = yy + stages['flow'][..., 1]
    with jax.enable_x64(False):
        want = np.asarray(JO._bilinear_gather_quad(
            jnp.asarray(stages['R1q']), H, W, 5, jnp.asarray(fx),
            jnp.asarray(fy)))
    got = TO._bilinear_gather_quad(_t(stages['R1q']), H, W, 5, _t(fx),
                                   _t(fy))[0].numpy()
    np.testing.assert_array_equal(got, want)


def test_bilinear_gather_quad_two_fields_one_gather(stages, monkeypatch):
    """Both fields sample in one take_along_axis call (one K2 launch on
    the card), each from its own rows: bit-equal to JAX field by field."""
    yy, xx = np.meshgrid(np.arange(H, dtype=np.float32),
                         np.arange(W, dtype=np.float32), indexing='ij')
    flows = [stages['flow'], -stages['flow'][::-1]]
    Rqs = [stages['R1q'], stages['R1q'][::-1] * 0.5]
    fx = np.stack([xx + f[..., 0] for f in flows])
    fy = np.stack([yy + f[..., 1] for f in flows])
    with jax.enable_x64(False):
        want = [np.asarray(JO._bilinear_gather_quad(
            jnp.asarray(np.ascontiguousarray(Rq)), H, W, 5,
            jnp.asarray(fx[b]), jnp.asarray(fy[b])))
            for b, Rq in enumerate(Rqs)]
    calls = []

    def counted(*args):
        calls.append(args)
        return G.take_along_axis(*args)

    monkeypatch.setattr(TO, 'take_along_axis', counted)
    got = TO._bilinear_gather_quad(
        torch.from_numpy(np.stack(Rqs).copy()), H, W, 5,
        torch.from_numpy(fx), torch.from_numpy(fy)).numpy()
    assert len(calls) == 1
    for b in range(2):
        np.testing.assert_array_equal(got[b], want[b])


def test_update_matrices(stages):
    got = TO._update_matrices(_t(stages['R0']), _t(stages['R1q']),
                              _t(stages['flow']),
                              torch.from_numpy(stages['bscale']))[0]
    _close(got, stages['M'])


def test_box_blur_61_taps_over_3600(stages):
    """2*(60//2)+1 = 61 taps per axis divided by 60**2, as JAX (and OpenCV)
    do; the port's float64 running sums stay within the budget of JAX's
    float32 ones."""
    got = TO._box_blur(_t(stages['M']), 60)[0]
    _close(got, stages['Mb'])
    one = TO._box_blur(torch.ones((1, 70, 80, 1)), 60)
    assert torch.allclose(one, torch.full_like(one, 61 * 61 / 3600))


def test_solve_flow(stages):
    _close(TO._solve_flow(_t(stages['Mb']))[0], stages['F'])


@pytest.mark.parametrize('sizes', [(252, 126, 63), (840, 420, 210),
                                   (63, 126, 252), (210, 420, 840)])
def test_resize_weights_match_jax_image_resize(sizes):
    """jax.image.resize(..., 'linear') antialiases when it downsamples;
    the port's separable weights reproduce it down the pyramid (252 -> 126
    -> 63, 840 -> 420 -> 210) and back up for the flow."""
    rng = np.random.default_rng(9)
    x = rng.normal(0, 1000, (sizes[0], 7)).astype(np.float32)
    for m, n in zip(sizes, sizes[1:]):
        with jax.enable_x64(False):
            want = np.asarray(jax.image.resize(jnp.asarray(x), (n, 7),
                                               'linear'))
        got = (torch.from_numpy(TO.resize_weights(m, n)).T
               @ torch.from_numpy(x)).numpy()
        assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()
        x = want


def test_resize_linear_flow_field(stages):
    """The (B, H, W, 2) flow resize of the pyramid, both directions."""
    f = stages['flow']
    for shape in ((126, 420), (63, 210)):
        with jax.enable_x64(False):
            want = np.asarray(jax.image.resize(jnp.asarray(f),
                                               shape + (2,), 'linear'))
        got = TO.resize_linear(_t(f), *shape)[0].numpy()
        assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()
        with jax.enable_x64(False):
            back = np.asarray(jax.image.resize(jnp.asarray(want),
                                               (H, W, 2), 'linear'))
        got_back = TO.resize_linear(_t(want), H, W)[0].numpy()
        assert np.abs(got_back - back).max() <= 1e-6 * np.abs(back).max()


def test_farneback_whole(pair):
    """The comb's call (levels 2, winsize 60, 3 iterations, poly 7/1.5)
    with an initial flow, both fields of a batch in one call."""
    a, b = pair
    flow0 = np.random.default_rng(4).normal(0, 0.5, (H, W, 2)).astype(
        np.float32)
    with jax.enable_x64(False):
        want = np.asarray(JO._farneback_jit(
            jnp.asarray(b), jnp.asarray(a), jnp.asarray(flow0), 0.5, 2, 60,
            3, 7, 1.5, True))
        want_a = np.asarray(JO._farneback_jit(
            jnp.asarray(a), jnp.asarray(b), jnp.asarray(flow0), 0.5, 2, 60,
            3, 7, 1.5, True))
    got = TO.farneback(torch.from_numpy(np.stack([b, a])),
                       torch.from_numpy(np.stack([a, b])),
                       torch.from_numpy(np.stack([flow0, flow0])), 0.5, 2,
                       60, 3, 7, 1.5, True).numpy()
    # the texture moved by (+1, -2) px from a to b
    assert np.allclose(np.median(want_a.reshape(-1, 2), 0), [1, -2],
                       atol=0.05)
    for g, w in ((got[0], want), (got[1], want_a)):
        d = np.abs(g - w)
        assert np.percentile(d, 99) <= 0.01 and d.max() <= 0.05, \
            (np.percentile(d, 99), d.max())
        conf = lambda f: 1 - np.clip(
            np.sqrt(f[..., 1] ** 2 + (2 * f[..., 0]) ** 2) / 0.5, 0, 1)
        assert np.abs(conf(g) - conf(w)).mean() <= 1e-3


def test_calc_optical_flow_farneback_levels_cap(pair):
    """The cv2-style entry point caps the pyramid so both dims stay >= 32
    px (252 rows: 4 levels -> 2) and takes the CPU only when asked."""
    a, b = pair
    with jax.enable_x64(False):
        want = np.asarray(JO.calc_optical_flow_farneback(
            a[:126, :200], b[:126, :200], None, 0.5, 4, 60, 3, 7, 1.5))
    got = TO.calc_optical_flow_farneback(
        a[:126, :200], b[:126, :200], None, 0.5, 4, 60, 3, 7, 1.5,
        device='cpu').numpy()
    assert np.percentile(np.abs(got - want), 99) <= 0.01
