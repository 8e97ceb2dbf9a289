"""PyTorch port, the VHS tape decode (tape/vhs.py) against the JAX
package's: the five cases of tests/test_vhs.py, each on both packages.

Both decode the same synthetic 8*fsc tape capture (flat 50 IRE); the JAX
side runs under jax.enable_x64(False) with a complex64 bank.  Budgets:
demod within 1e-3 of its peak-to-peak per tap (the demod's own budget,
tests/test_torch_filters_demod.py); luma within 1 LSB (a float32 value
that lands on a rounding boundary may round either way); audio carriers
within 1e-3 of their peak-to-peak; sync peaks equal; the recovered
color-under chroma within 1e-4 of its peak (two float32 FFT filter
passes), and the physical checks of tests/test_vhs.py on the port's own
output."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.signal as sps
import torch

from ld_decode_tpu.models import encode as JE
from ld_decode_tpu.ops import demod as JD
from ld_decode_tpu.tape import vhs as JV
from ld_decode_tpu.tbc import sync as JS
from ld_decode_tpu_torch.ops import demod as D
from ld_decode_tpu_torch.tape import vhs as V
from ld_decode_tpu_torch.tbc import sync as S
from ld_decode_tpu_torch.utils.params import vhs_rf_params

torch.set_num_threads(2)

NBLOCKS = 24
DEMOD_TOL = 1e-3
CU_TOL = 1e-4


def test_vhs_deemp_matches_attic_coefficients():
    """The port's (25, 600) deemp constants reproduce the attic's final
    f_deemp (vhs-decoder.py:184-186) at its 8*fsc rate, and its tape
    configuration is the JAX package's."""
    cfg = V.vhs_config()
    jcfg = JV.vhs_config()
    assert (cfg.freq_hz, cfg.freq_hz_half, cfg.linelen) == \
        (jcfg.freq_hz, jcfg.freq_hz_half, jcfg.linelen)
    d0, d1 = vhs_rf_params().video_deemp
    tf_b, tf_a = sps.zpk2tf(-d1 * 1e-10, -d0 * 1e-10, d0 / d1)
    b, a = sps.bilinear(tf_b, tf_a, 1.0 / cfg.freq_hz_half)
    np.testing.assert_allclose(
        b, [5.851707135547494e-02, -2.335100939622290e-02], rtol=1e-9)
    np.testing.assert_allclose(
        a, [1.0, -9.648339380407480e-01], rtol=1e-9)
    assert V.color_under_freq(cfg) == JV.color_under_freq(jcfg)
    assert (V.MIN_IRE, V.MAX_IRE, V.OUT_SCALE) == (JV.MIN_IRE, JV.MAX_IRE,
                                                   JV.OUT_SCALE)


@pytest.fixture(scope='module')
def vhs_decode():
    """One decode_vhs window of the flat-50 tape capture, both packages."""
    jcfg = JV.vhs_config()
    n = JD.stream_len(jcfg, NBLOCKS)
    nfields = int(np.ceil(n / (jcfg.linelen_float * 262.5))) + 1
    samples = JE.encode_frames(jcfg, (nfields + 2) // 2,
                               JE.EncodeSpec(pattern='flat50'))
    x = samples[:n].astype(np.float32)
    with jax.enable_x64(False):
        jv, ja = JV.decode_vhs(jnp.asarray(x), JV.make_vhs_bank(jcfg), jcfg,
                               NBLOCKS)
        jv = {k: np.asarray(v) for k, v in jv.items()}
        ja = {k: np.asarray(v) for k, v in ja.items()}
    cfg = V.vhs_config()
    assert D.stream_len(cfg, NBLOCKS) == n
    tv, ta = V.decode_vhs(torch.from_numpy(x),
                          V.make_vhs_bank(cfg, device='cpu'), cfg, NBLOCKS)
    return cfg, tv, ta, jv, ja


def test_vhs_decode_against_jax(vhs_decode):
    """Every video and audio tap of decode_vhs against the JAX package's."""
    cfg, tv, ta, jv, ja = vhs_decode
    assert sorted(tv) == sorted(jv) and sorted(ta) == sorted(ja)
    for k, want in jv.items():
        got = tv[k].numpy()
        assert got.shape == want.shape, k
        if k == 'luma':
            assert tv[k].dtype == torch.int32 and want.dtype == np.uint16
            d = np.abs(got.astype(np.int64) - want.astype(np.int64))
            assert d.max() <= 1, (k, d.max())
            continue
        ptp = float(np.ptp(want))
        assert np.abs(got - want).max() <= DEMOD_TOL * ptp, k
    for k, want in ja.items():
        got = ta[k].numpy()
        assert got.shape == want.shape
        assert np.abs(got - want).max() <= DEMOD_TOL * float(np.ptp(want)), k


def test_vhs_levels(vhs_decode):
    """Flat-50 pattern decodes to 50 IRE, sync tips to -40 IRE, on the
    tape carrier map (0 IRE = 5.4 MHz, 16 kHz/IRE); the luma scale
    (tests/test_vhs.py::test_vhs_levels on the port's output)."""
    cfg, tv, ta, _, _ = vhs_decode
    ire = cfg.hztoire(tv['demod'].numpy().astype(np.float64))[2048:]
    tips = ire[ire < -25]
    assert tips.size > 3000                # 4.7 us pulses at 28.6 MSa/s
    assert abs(np.percentile(tips, 10) - (-40.0)) < 1.0
    assert -40.5 < np.median(tips) < -30.0, np.median(tips)
    flat = ire[(ire > 25) & (ire < 75)]
    assert abs(np.median(flat) - 50.0) < 1.0, np.median(flat)

    luma = tv['luma'].numpy().astype(np.float64)[2048:]
    got_ire = luma / V.OUT_SCALE + V.MIN_IRE
    m = (ire > 25) & (ire < 75)
    np.testing.assert_allclose(got_ire[m], ire[m], atol=0.01)


def test_vhs_audio_carriers(vhs_decode):
    """The attic decoder's 2.301/2.812 MHz audio pair, recovered by the
    stage-1 demod (tests/test_vhs.py::test_vhs_audio_carriers)."""
    cfg, tv, ta, _, _ = vhs_decode
    assert 'audio_left' in ta
    l = np.median(ta['audio_left'].numpy().astype(np.float64))
    r = np.median(ta['audio_right'].numpy().astype(np.float64))
    assert abs(l - cfg.sys.audio_lfreq) < 1e4, (l, cfg.sys.audio_lfreq)
    assert abs(r - cfg.sys.audio_rfreq) < 1e4, (r, cfg.sys.audio_rfreq)


def test_vhs_sync_channel_locks(vhs_decode):
    """The port's sync machinery sees tape sync pulses at the NTSC line
    pitch, at the same peaks as the JAX package's on its own decode."""
    cfg, tv, ta, jv, _ = vhs_decode
    window = max(int(cfg.linelen * 0.4), 2)
    idx, _ = S.find_sync_peaks(tv['demod_sync'][None], window)
    idx = idx[0].numpy()
    idx = idx[idx >= 0]
    with jax.enable_x64(False):
        jidx, _ = JS.find_sync_peaks(jnp.asarray(jv['demod_sync']), window)
    jidx = np.asarray(jidx)
    np.testing.assert_array_equal(idx, jidx[jidx >= 0])
    assert idx.size > 100
    gaps = np.diff(idx)
    line_gaps = gaps[(gaps > cfg.linelen * 0.9) & (gaps < cfg.linelen * 1.1)]
    assert line_gaps.size > 0.7 * gaps.size
    assert abs(np.median(line_gaps) - cfg.linelen_float) < 2.0


def test_vhs_color_under_roundtrip():
    """An fsc-band chroma signal written at 629 kHz next to the luma FM
    carrier is recovered at fsc with its amplitude and phase
    (tests/test_vhs.py::test_vhs_color_under_roundtrip), and the port's
    recovery equals the JAX package's."""
    cfg = V.vhs_config()
    fs = cfg.freq_hz
    fsc = cfg.sys.fsc_mhz * 1e6
    n = 1 << 19
    t = np.arange(n, dtype=np.float64) / fs
    amp = 1.0 + 0.3 * np.sin(2 * np.pi * 500.0 * t)
    phi = 0.6 * np.sin(2 * np.pi * 300.0 * t)
    chroma = amp * np.cos(2 * np.pi * fsc * t + phi)
    hz = np.full(n, cfg.iretohz(50.0))
    rf = np.cos(np.cumsum(hz) * (2 * np.pi / fs))
    cu = V.encode_color_under(cfg, chroma)
    np.testing.assert_array_equal(cu, JV.encode_color_under(
        JV.vhs_config(), chroma))
    tape = (rf * 350.0 + 0.25 * 350.0 * cu + 512.0).astype(np.float32)

    got = V.recover_color_under(torch.from_numpy(tape), cfg)
    assert got.dtype == torch.float32 and got.shape == (n,)
    got = got.numpy()
    with jax.enable_x64(False):
        want = np.asarray(JV.recover_color_under(jnp.asarray(tape),
                                                 JV.vhs_config()))
    assert np.abs(got - want).max() <= CU_TOL * np.abs(want).max()

    out = got.astype(np.float64)[n // 8:-n // 8] / (0.25 * 350.0)
    ref = chroma[n // 8:-n // 8]
    corr = np.dot(ref, out) / np.sqrt(np.dot(ref, ref) * np.dot(out, out))
    assert corr > 0.98, corr
    assert abs(np.sqrt(np.mean(out ** 2) / np.mean(ref ** 2)) - 1) < 0.10


def test_vhs_bank_on_the_card_by_default():
    """make_vhs_bank builds on the card unless asked for the CPU, and the
    laserdisc TBC refuses the tape profile (as the JAX package's does)."""
    from ld_decode_tpu_torch.tbc import framer as FR
    cfg = V.vhs_config()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='no CUDA device'):
            V.make_vhs_bank(cfg)
    bank = V.make_vhs_bank(cfg, device='cpu')
    with pytest.raises(ValueError, match='demod-only'):
        FR.Framer(cfg, bank, capture=np.zeros(10_000, np.uint16),
                  device='cpu')
