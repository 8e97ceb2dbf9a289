"""PyTorch port: filter bank and FM demod against the JAX package."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ld_decode_tpu.models import encode as E
from ld_decode_tpu.ops import demod as JD
from ld_decode_tpu.ops import filters as JF
from ld_decode_tpu.utils.params import DecoderConfig
from ld_decode_tpu_torch.ops import demod as TD
from ld_decode_tpu_torch.ops import filters as TF
from ld_decode_tpu_torch.utils.params import DecoderConfig as TConfig

torch.set_num_threads(2)

NBLOCKS = 20
F32_TOL = 1e-3    # max|d| per demod tap, as a fraction of its peak-to-peak
F64_TOL = 1e-9    # the same at float64


@pytest.fixture(scope='module')
def cfg():
    return DecoderConfig(system='NTSC', freq_mhz=40.0)


@pytest.fixture(scope='module')
def tcfg():
    return TConfig(system='NTSC', freq_mhz=40.0)


@pytest.fixture(scope='module')
def capture(cfg):
    cap = E.encode_frames(cfg, 1, E.EncodeSpec(pattern='ramp',
                                               cav_start_frame=900))
    return cap[:JD.stream_len(cfg, NBLOCKS)]


def _jax_leaves(jbank):
    arrays = {n: (None if getattr(jbank, n) is None
                  else np.asarray(getattr(jbank, n)))
              for n in TF.FILTER_NAMES}
    static = {n: getattr(jbank, n) for n in TF.STATIC_NAMES}
    return arrays, static


def _assert_bank_equal(tbank, arrays):
    for name, a in arrays.items():
        t = getattr(tbank, name)
        if a is None:
            assert t is None, name
            continue
        t = t.numpy()
        assert t.real.dtype == a.dtype, name
        np.testing.assert_array_equal(t.real, a[..., 0], err_msg=name)
        np.testing.assert_array_equal(t.imag, a[..., 1], err_msg=name)


@pytest.mark.parametrize('dtype', [np.complex64, np.complex128])
def test_bank_bit_exact(cfg, tcfg, dtype):
    """The port's design + one-sided bank equals the JAX bank bit for bit."""
    with jax.enable_x64(dtype == np.complex128):
        arrays, static = _jax_leaves(JF.make_demod_bank(cfg, dtype))
    tbank = TF.make_demod_bank(tcfg, dtype, device='cpu')
    _assert_bank_equal(tbank, arrays)
    for n in TF.STATIC_NAMES:
        assert getattr(tbank, n) == static[n], n


@pytest.mark.parametrize('dtype', [np.complex64, np.complex128])
def test_bank_from_numpy(cfg, tcfg, dtype):
    """bank_from_numpy turns the JAX bank's leaves into the port's bank."""
    with jax.enable_x64(dtype == np.complex128):
        arrays, static = _jax_leaves(JF.make_demod_bank(cfg, dtype))
    tbank = TF.bank_from_numpy(arrays, static, device='cpu')
    _assert_bank_equal(tbank, arrays)
    ref = TF.make_demod_bank(tcfg, dtype, device='cpu')
    for n in TF.FILTER_NAMES:
        a, b = getattr(tbank, n), getattr(ref, n)
        assert (a is None) == (b is None), n
        if a is not None:
            assert torch.equal(a, b), n


@pytest.mark.parametrize('mtf_level', [0.0, 1.0])
@pytest.mark.parametrize('dtype', [np.complex64, np.complex128])
def test_demod_stream_matches_jax(cfg, tcfg, capture, dtype, mtf_level):
    wide = dtype == np.complex128
    with jax.enable_x64(wide):
        jbank = JF.make_demod_bank(cfg, dtype)
        rdt = jnp.float64 if wide else jnp.float32
        jv, ja = JD.demod_stream(jnp.asarray(capture), jbank, cfg, NBLOCKS,
                                 jnp.asarray(mtf_level, rdt))
        jv = {k: np.asarray(v) for k, v in jv.items()}
        ja = {k: np.asarray(v) for k, v in ja.items()}
    tbank = TF.make_demod_bank(tcfg, dtype, device='cpu')
    tv, ta = TD.demod_stream(
        torch.from_numpy(capture.astype(np.float64 if wide else np.float32)),
        tbank, tcfg, NBLOCKS, mtf_level)
    tol = F64_TOL if wide else F32_TOL
    for ref, got in ((jv, tv), (ja, ta)):
        assert set(ref) == set(got)
        for k in ref:
            g = got[k].numpy()
            assert g.dtype == ref[k].dtype and g.shape == ref[k].shape, k
            assert np.abs(g - ref[k]).max() <= tol * np.ptp(ref[k]), k


def test_demod_stream_rejects_wrong_length(tcfg, capture):
    tbank = TF.make_demod_bank(tcfg, device='cpu')
    with pytest.raises(ValueError, match='need exactly'):
        TD.demod_stream(torch.from_numpy(capture[:-1].astype(np.float32)),
                        tbank, tcfg, NBLOCKS, 1.0)


def test_pal_bank_bit_exact_and_pilot_tap():
    """The PAL bank (with its pilot filters) equals the JAX bank bit for
    bit, and the PAL demod's taps, the pilot tap's source `demod_05`
    among them, match JAX."""
    cfg = DecoderConfig(system='PAL', freq_mhz=40.0)
    tcfg = TConfig(system='PAL', freq_mhz=40.0)
    with jax.enable_x64(False):
        jbank = JF.make_demod_bank(cfg, np.complex64)
        arrays, static = _jax_leaves(jbank)
    tbank = TF.make_demod_bank(tcfg, np.complex64, device='cpu')
    _assert_bank_equal(tbank, arrays)
    for n in TF.STATIC_NAMES:
        assert getattr(tbank, n) == static[n], n
    pilot = [n for n in TF.FILTER_NAMES if 'pilot' in n]
    assert pilot and all(arrays[n] is not None for n in pilot), pilot

    cap = E.encode_frames(cfg, 1, E.EncodeSpec(pattern='palbars',
                                               cav_start_frame=900))
    cap = cap[2560 * 14:2560 * 14 + JD.stream_len(cfg, NBLOCKS)]
    with jax.enable_x64(False):
        jv, _ = JD.demod_stream(jnp.asarray(cap), jbank, cfg, NBLOCKS,
                                jnp.float32(1.0))
        jv = {k: np.asarray(v) for k, v in jv.items()}
    tv, _ = TD.demod_stream(torch.from_numpy(cap.astype(np.float32)), tbank,
                            tcfg, NBLOCKS, 1.0)
    assert set(jv) == set(tv) and 'demod_05' in tv
    for k in jv:
        assert np.abs(tv[k].numpy() - jv[k]).max() <= F32_TOL * np.ptp(jv[k]), k
