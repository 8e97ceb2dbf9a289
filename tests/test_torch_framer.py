"""PyTorch port, the slice as a whole: the port's Framer against the JAX
Framer (raw-picture mode) over the same synthetic capture."""

import jax
import numpy as np
import pytest
import torch

from ld_decode_tpu.models import encode as JE
from ld_decode_tpu.ops import filters as JF
from ld_decode_tpu.tbc import framer as JFR
from ld_decode_tpu.utils.params import DecoderConfig
from ld_decode_tpu_torch.ops import filters as TF
from ld_decode_tpu_torch.tbc import field as TFD
from ld_decode_tpu_torch.tbc import framer as TFR
from ld_decode_tpu_torch.utils.params import DecoderConfig as TConfig

from torch_parity import assert_audio_close, assert_picture_close

torch.set_num_threads(2)


def _frames(framer, n=3):
    out, s = [], 33046
    for i in range(n):
        rv = framer.readframe(None, s, i == 0)
        if rv[0] is None:
            break
        out.append(rv)
        s = rv[2]
    return out


@pytest.fixture(scope='module')
def pair():
    cap = JE.encode_frames(DecoderConfig(), 4, JE.EncodeSpec(
        pattern='ramp', cav_start_frame=900))
    with jax.enable_x64(False):
        jcfg = DecoderConfig(system='NTSC', freq_mhz=40.0)
        jf = JFR.Framer(jcfg, JF.make_demod_bank(jcfg, np.complex64),
                        capture=cap, batch=6, pic_mode='raw')
        jframes = _frames(jf)
    tcfg = TConfig(system='NTSC', freq_mhz=40.0)
    tf = TFR.Framer(tcfg,
                    TF.make_demod_bank(tcfg, np.complex64, device='cpu'),
                    capture=cap, batch=6, device='cpu')
    tframes = _frames(tf)
    return jf, tf, jframes, tframes


def test_framer_frames_and_positions(pair):
    jf, tf, jframes, tframes = pair
    assert len(tframes) == len(jframes) >= 2
    for a, b in zip(jframes, tframes):
        assert a[2] == b[2]                      # next sample: exact
        assert a[0].shape == b[0].shape == (525 * 910,)
        assert b[0].dtype == np.uint16
    # the first field came through the sequential fallback
    assert tf.prefetcher.stats['seq_fallback'] >= 1
    assert tf.prefetcher.stats['hits'] >= 3


def test_framer_picture(pair):
    _, _, jframes, tframes = pair
    for a, b in zip(jframes, tframes):
        assert_picture_close(b[0].reshape(525, 910), a[0].reshape(525, 910))


def test_framer_vbi_and_metadata(pair):
    jf, tf, jframes, tframes = pair
    assert tf.vbi['framenr'] == jf.vbi['framenr'] is not None
    for a, b in zip(jframes, tframes):
        assert [f.vbi['framenr'] for f in a[3]] \
            == [f.vbi['framenr'] for f in b[3]]
        # the 16 line-0 metadata words: exact
        np.testing.assert_array_equal(a[0][:16], b[0][:16])


def test_framer_audio(pair):
    _, _, jframes, tframes = pair
    for a, b in zip(jframes, tframes):
        assert_audio_close(b[1], a[1])


def test_framer_rejects_unported_modes():
    """batch=1 is the sequential decode (held to JAX in
    tests/test_torch_field_seq.py): no prefetcher, the capture resident;
    the tape systems have no laserdisc TBC and raise, as in the JAX
    package."""
    tcfg = TConfig(system='NTSC')
    bank = TF.make_demod_bank(tcfg, device='cpu')
    fr = TFR.Framer(tcfg, bank, capture=np.zeros(10, np.uint16), batch=1,
                    device='cpu')
    assert fr.prefetcher is None and fr.capture_dev.shape == (10,)
    with pytest.raises(ValueError, match='exactly one'):
        TFR.Framer(tcfg, bank, batch=1, device='cpu')
    # the tape systems have no laserdisc TBC (tape/vhs.py decodes them)
    vcfg = TConfig(system='VHS')
    with pytest.raises(ValueError, match='demod-only'):
        TFR.Framer(vcfg, bank, capture=np.zeros(10, np.uint16), batch=8,
                   device='cpu')


def test_framer_takes_pal():
    """PAL builds on the same Framer (the decode itself is held to JAX in
    tests/test_torch_pal.py): 625 x 1135 frames, 25 fps CLV numbering,
    800,000-sample field pitch, the default 66-block window."""
    pcfg = TConfig(system='PAL')
    fr = TFR.Framer(pcfg, TF.make_demod_bank(pcfg, device='cpu'),
                    capture=np.zeros(10, np.uint16), batch=8, device='cpu')
    assert (fr.outlines, fr.outwidth, fr.clvfps) == (625, 1135, 25)
    assert fr.prefetcher.field_pitch == 800000 and fr.nblocks == 66


def test_entry_points_default_to_the_card():
    """The bank, FieldDecoder and Framer run on the card unless the caller
    asks for the CPU: without a CUDA device the defaults raise."""
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present: the defaults would run')
    tcfg = TConfig(system='NTSC')
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TF.make_demod_bank(tcfg)
    bank = TF.make_demod_bank(tcfg, device='cpu')
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TFR.Framer(tcfg, bank, capture=np.zeros(10, np.uint16), batch=8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TFD.FieldDecoder(tcfg, bank)
