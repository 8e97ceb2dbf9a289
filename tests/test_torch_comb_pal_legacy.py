"""PyTorch port: the legacy-geometry PAL comb (comb/comb_pal_legacy.py)
against the JAX package's, on the seeded synthetic 1052x610 frames of
tests/test_comb_pal_legacy.py::synth_frame (seeds 0 and 1), at dims 1, 2
and 3.  The JAX module's own oracle test needs the reference's attic
binary; this one needs only the JAX module.

Budget (RGB48 LSB, every pixel of the cropped 974 x 576 output): max <= 2,
99.9th percentile <= 1; the 4-line phase vote equal; the dim-3 primer
frame all zero in both.  Found on the CPU: max 1 LSB, on ~0.3% of the
values (float32 reductions and atan2/cos/sin rounding before the
truncation to 16 bits)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ld_decode_tpu.comb import comb_pal_legacy as J
from ld_decode_tpu_torch.comb import comb_pal_legacy as T

from test_comb_pal_legacy import synth_frame

torch.set_num_threads(2)

MAX_LSB, P999_LSB = 2, 1


@pytest.fixture(scope='module')
def frames():
    return [synth_frame(seed=i) for i in range(2)]


def test_constants_and_config_equal():
    for name in ('L_Y', 'L_X', 'IRESCALE', 'IRE_OFFSET', 'LINEOFFSET',
                 'LINESOUT', 'CROP_X0', 'CROP_W'):
        assert getattr(T, name) == getattr(J, name), name
    assert T.LegacyPALConfig().__dict__ == J.LegacyPALConfig().__dict__


def _vote(u, v):
    """The 4-line phase vote of _to_rgb, from the demodulated burst."""
    bu, bv = u[:, 25:55].sum(1), v[:, 25:55].sum(1)
    ang = np.degrees(np.arctan2(bv, bu))
    ls = np.arange(20, J.L_Y - 4, 4)
    return int((np.abs(ang[ls + 1] - ang[ls]) < 20).sum())


def test_stages_and_phase_vote(frames):
    """Split1D/2D, SplitIQ, AdjustY and DoYNR stage by stage, and the
    phase vote from each side's own demodulated burst."""
    for f in frames:
        with jax.enable_x64(False):
            raw = jnp.asarray(f).astype(jnp.float32)
            inv = jnp.asarray(f)[:, 0] == 16384
            c0 = J._split1d(raw)
            c1, k1, k0 = J._split2d(c0, True)
            y, i, q = J._adjust_y(*J._split_iq(raw, (c1, c0), (k1, k0), inv),
                                  inv)
            yn = J._do_ynr(y, 1.0)
            jax_side = [np.asarray(a) for a in (c0, c1, k1, k0, y, i, q, yn)]
        rt = torch.from_numpy(f.astype(np.int32))
        raw_t = rt.float()
        inv_t = rt[:, 0] == 16384
        c0 = T._split1d(raw_t)
        c1, k1, k0 = T._split2d(c0, True)
        y, i, q = T._adjust_y(*T._split_iq(raw_t, (c1, c0), (k1, k0), inv_t),
                              inv_t)
        yn = T._do_ynr(y, 1.0)
        port = [a.numpy() for a in (c0, c1, k1, k0, y, i, q, yn)]
        for name, a, b in zip(('clp0', 'clp1', 'k1', 'k0', 'y', 'i', 'q'),
                              port, jax_side):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-6 * max(
                1.0, np.abs(b).max()), err_msg=name)
        # the coring filter: float32 convolutions in another order
        assert np.abs(port[-1] - jax_side[-1]).max() <= 1e-6 * np.abs(
            jax_side[-1]).max()
        assert _vote(port[5], port[6]) == _vote(jax_side[5], jax_side[6])


@pytest.mark.parametrize('dim', [1, 2, 3])
def test_legacy_comb_against_jax(frames, dim):
    with jax.enable_x64(False):
        jc = J.LegacyPALComb(J.LegacyPALConfig(dim=dim))
        want = [jc.process(f) for f in frames]
    tc = T.LegacyPALComb(T.LegacyPALConfig(dim=dim), device='cpu')
    got = [tc.process(f) for f in frames]
    for g, w in zip(got, want):
        assert g.dtype == np.uint16 and g.shape == w.shape == (576, 974, 3)
        d = np.abs(g.astype(np.int64) - w)
        assert d.max() <= MAX_LSB and np.percentile(d, 99.9) <= P999_LSB, \
            (d.max(), np.percentile(d, 99.9))
    if dim == 3:
        # the one-frame-old slot: the primer frame is black, then frame 0
        assert got[0].max() == want[0].max() == 0
        assert got[1].max() > 0


def test_legacy_comb_wide_and_device_default(frames):
    tc = T.LegacyPALComb(T.LegacyPALConfig(wide=True), device='cpu')
    assert tc.process(frames[0]).shape == (576, 1052, 3)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='no CUDA device'):
            T.LegacyPALComb()
