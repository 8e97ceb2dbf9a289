"""PyTorch port, the slice as a whole: the port's Framer against the JAX
Framer (raw-picture mode) over the same synthetic capture, at batch 6
and, for every batch the port may run, against that same reference."""

import jax
import numpy as np
import pytest
import torch

from ld_decode_tpu.models import encode as JE
from ld_decode_tpu.ops import filters as JF
from ld_decode_tpu.tbc import framer as JFR
from ld_decode_tpu.utils.params import DecoderConfig
import lddecode_torch
from ld_decode_tpu_torch.ops import filters as TF
from ld_decode_tpu_torch.tbc import field as TFD
from ld_decode_tpu_torch.tbc import framer as TFR
from ld_decode_tpu_torch.utils.params import DecoderConfig as TConfig

from torch_parity import (assert_audio_close, assert_pal_picture,
                          assert_picture_close)

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
def cap():
    return JE.encode_frames(DecoderConfig(), 4, JE.EncodeSpec(
        pattern='ramp', cav_start_frame=900))


@pytest.fixture(scope='module')
def pair(cap):
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


@pytest.fixture(scope='module')
def pal_ref():
    """The JAX PAL Framer at batch 6 on a `palbars` capture."""
    cfg = DecoderConfig(system='PAL', freq_mhz=40.0)
    cap = JE.encode_frames(cfg, 4, JE.EncodeSpec(pattern='palbars',
                                                 cav_start_frame=900))
    with jax.enable_x64(False):
        jf = JFR.Framer(cfg, JF.make_demod_bank(cfg, np.complex64),
                        capture=cap, batch=6, pic_mode='raw')
        return cap, _frames(jf)


@pytest.mark.parametrize('system', ['NTSC', 'PAL'])
@pytest.mark.parametrize('batch', [2, 3, 4, 8, 16])
def test_framer_batch_against_jax(cap, pair, pal_ref, system, batch):
    """The port's Framer at `batch` against the JAX Framer's frames at
    batch 6: next positions, frame numbers and line-0 words exact, the
    picture within its budget.  A batch moves the windows a refill chains
    (the JAX package's own pictures at batches 2-4 differ from batch 6's
    by up to 4 LSB), the queue's hops and the in-flight flushes; the
    frames the Framer makes of them must not move.  The audio is not
    compared: its carry depends on the batch in both packages, and
    test_torch_prefetch_resync.py holds it field by field at batch 2,
    test_framer_audio at batch 6.  (The JAX Framer at each batch would
    cost an XLA compile of about 20 s a batch and system on the CPU.)"""
    if system == 'NTSC':
        want, shape, check = pair[2], (525, 910), assert_picture_close
    else:
        cap, want = pal_ref
        shape = (625, 1135)

        def check(got, ref):
            assert_pal_picture(got, ref, per_row=2)
    cfg = TConfig(system=system, freq_mhz=40.0)
    fr = TFR.Framer(cfg, TF.make_demod_bank(cfg, np.complex64, device='cpu'),
                    capture=cap, batch=batch, device='cpu')
    got = _frames(fr)
    assert fr.prefetcher.batch == batch
    assert len(got) == len(want) >= 2
    for a, b in zip(want, got):
        assert a[2] == b[2]
        assert [f.vbi['framenr'] for f in a[3]] \
            == [f.vbi['framenr'] for f in b[3]]
        np.testing.assert_array_equal(a[0][:16], b[0][:16])
        check(b[0].reshape(shape), a[0].reshape(shape))


def test_pic_mode_auto_equals_raw(cap, pair):
    """pic_mode stays only for the benchmark's traffic file: 'auto' (the
    default, `pair`'s) and 'raw' both take the raw copy."""
    _, tf, _, auto = pair
    cfg = TConfig(system='NTSC', freq_mhz=40.0)
    raw = _frames(TFR.Framer(cfg, tf.bank, capture=cap, batch=6,
                             device='cpu', pic_mode='raw'))
    assert len(raw) == len(auto) >= 2
    for a, b in zip(auto, raw):
        assert a[2] == b[2]
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])


def test_pic_mode_codec_refused():
    cfg = TConfig(system='NTSC')
    bank = TF.make_demod_bank(cfg, device='cpu')
    for mode in ('codec', 'fast'):
        with pytest.raises(ValueError, match='codec was removed'):
            TFR.Framer(cfg, bank, capture=np.zeros(10, np.uint16), batch=8,
                       device='cpu', pic_mode=mode)


def test_cli_has_no_pic_mode(capsys):
    """lddecode_torch.py takes no --pic-mode: argparse exits 2."""
    with pytest.raises(SystemExit) as e:
        lddecode_torch.parse_args(['in.lds', 'out', '--pic-mode', 'raw'])
    assert e.value.code == 2
    assert '--pic-mode' in capsys.readouterr().err


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
