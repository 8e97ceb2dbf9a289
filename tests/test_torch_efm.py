"""PyTorch port: its host copies of the EFM digital-audio chain
(audio/efm.py, circ.py, subcode.py: numpy only) give what the originals
give on seeded inputs, and `--efm` on both CLIs writes the files that
lddecode_tpu.py / ldchain_tpu.py write."""

import shutil

import jax
import numpy as np
import pytest
import torch

import ldchain_torch
import lddecode_torch
import lddecode_tpu
from ld_decode_tpu.audio import circ as JC
from ld_decode_tpu.audio import efm as JE
from ld_decode_tpu.audio import subcode as JS
from ld_decode_tpu.io import loaders as JL
from ld_decode_tpu.models import encode as JM
from ld_decode_tpu.utils.params import DecoderConfig
from ld_decode_tpu_torch.audio import circ as TC
from ld_decode_tpu_torch.audio import efm as TE
from ld_decode_tpu_torch.audio import subcode as TS

torch.set_num_threads(2)

RATE = 28.8e6


def test_efm_tables_equal():
    assert TE.EFM_CODES == JE.EFM_CODES and len(set(TE.EFM_CODES)) == 256
    np.testing.assert_array_equal(TE.EFM_DECODE, JE.EFM_DECODE)
    assert (TE.F3_CHANNEL_BITS, TE.EFM_CLOCK_HZ) \
        == (JE.F3_CHANNEL_BITS, JE.EFM_CLOCK_HZ)
    for b in (0, 1, 127, 255):
        assert TE.EFM_DECODE[TE.EFM_CODES[b]] == b


def test_f3_frame_round_trip_equal():
    rng = np.random.default_rng(0)
    frames = [(int(rng.integers(0, 256)),
               rng.integers(0, 256, 32).astype(np.int16)) for _ in range(4)]
    bits_t = np.concatenate([TE.encode_f3_frame(c, p) for c, p in frames])
    bits_j = np.concatenate([JE.encode_f3_frame(c, p) for c, p in frames])
    np.testing.assert_array_equal(bits_t, bits_j)
    wave = JE.nrzi_waveform(bits_j, RATE)
    np.testing.assert_array_equal(TE.nrzi_waveform(bits_t, RATE), wave)
    wave = wave + np.random.default_rng(1).normal(0, 0.05, len(wave))
    got_t = TE.channel_bits_from_rf(wave, RATE)
    np.testing.assert_array_equal(got_t, JE.channel_bits_from_rf(wave, RATE))
    dt, dj = TE.decode_frames(got_t), JE.decode_frames(got_t)
    assert len(dt) == len(dj) > 0
    for (pa, ca, ya), (pb, cb, yb) in zip(dt, dj):
        assert (pa, ca) == (pb, cb)
        np.testing.assert_array_equal(ya, yb)
    # and the payloads that come back are the ones that went in
    payloads = {tuple(p.tolist()) for _, p in frames}
    assert sum(tuple(np.asarray(y).tolist()) in payloads
               for _, _, y in dt) >= 2


def test_scrambler_equal():
    rng = np.random.default_rng(2)
    data = rng.integers(0, 256, 2340).astype(np.uint8)
    once = TE.descramble_sector(data)
    np.testing.assert_array_equal(once, JE.descramble_sector(data))
    np.testing.assert_array_equal(TE.descramble_sector(once), data)
    assert not np.array_equal(once, data)


def _pcm_frames(nf, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(-30000, 30000, (nf * 6, 2)).astype(np.int16)


def test_rs_and_circ_equal_with_errors_and_erasures():
    rng = np.random.default_rng(3)
    pcm = _pcm_frames(140, 4)
    audio_t, audio_j = TC.samples_to_audio(pcm), JC.samples_to_audio(pcm)
    np.testing.assert_array_equal(audio_t, audio_j)
    chan = JC.circ_encode(audio_j)
    np.testing.assert_array_equal(TC.circ_encode(audio_t), chan)

    # random byte errors (C1 corrects up to two a frame)
    bad = chan.copy()
    for f in rng.choice(len(bad), 30, replace=False):
        bad[f, rng.choice(32, 2, replace=False)] ^= rng.integers(
            1, 256, 2).astype(bad.dtype)
    # a burst of known-bad symbols: erasures for C1, and for C2 across
    # the interleave
    erase = np.zeros(bad.shape, bool)
    erase[60:63] = True
    bad[60:63] = 0
    for frames, er in ((chan, None), (bad, None), (bad, erase)):
        dt = TC.circ_decode(frames, bad_mask=er)
        dj = JC.circ_decode(frames, bad_mask=er)
        assert dt.keys() == dj.keys()
        for k in dj:
            np.testing.assert_array_equal(np.asarray(dt[k]),
                                          np.asarray(dj[k]), err_msg=k)
    assert np.asarray(dj['c1_corrected']).sum() > 0
    got = TC.audio_to_samples(dt['audio'])
    np.testing.assert_array_equal(got, JC.audio_to_samples(dj['audio']))


def test_q_packets_equal():
    rng = np.random.default_rng(5)
    for kw in (dict(tno=3, index=1, rel_frames=4711, abs_frames=90210),
               dict(tno=TS.LEADOUT_TNO, index=1, rel_frames=0,
                    abs_frames=300000, control=4)):
        qt, qj = TS.encode_q_position(**kw), JS.encode_q_position(**kw)
        np.testing.assert_array_equal(qt, qj)
        assert repr(TS.decode_q(qt)) == repr(JS.decode_q(qj)) != 'None'
        broken = qt.copy()
        broken[5] ^= 0x10                              # the CRC rejects it
        assert TS.decode_q(broken) is None and JS.decode_q(broken) is None
    bits = rng.integers(0, 2, 80)
    assert TS.crc16_q(bits) == JS.crc16_q(bits)
    q = JS.encode_q_position(2, 1, 77, 1234)
    sym_t = TS.subcode_symbols_for_section(q)
    assert sym_t == JS.subcode_symbols_for_section(q)
    stream = np.array(sym_t * 3 + [0] * 5)
    stream[98 + 40] = -1                   # an EFM-invalid symbol inside
    assert repr(TS.decode_subcode(stream)) == repr(JS.decode_subcode(stream))
    assert len(TS.decode_subcode(stream)) == 2


def test_full_chain_equal():
    """samples -> CIRC -> EFM/F3 -> NRZI RF -> decode: the copy's dict
    equals the original's, and the PCM comes back."""
    pcm = _pcm_frames(150, 9)
    wave = JE.encode_digital_audio(pcm, RATE)
    np.testing.assert_array_equal(TE.encode_digital_audio(pcm, RATE), wave)
    dt, dj = TE.decode_digital_audio(wave, RATE), JE.decode_digital_audio(
        wave, RATE)
    assert dt.keys() == dj.keys()
    for k in ('samples', 'controls', 'c1_ok', 'c2_ok'):
        np.testing.assert_array_equal(dt[k], dj[k], err_msg=k)
    assert repr(dt['q']) == repr(dj['q'])
    n = (150 - 1) * 6
    np.testing.assert_array_equal(dt['samples'][:n], pcm[6:6 + n])


@pytest.fixture(scope='module')
def efm_lds(tmp_path_factory):
    """The capture of tests/test_efm.py:143-153: known PCM as EFM under a
    3-frame NTSC `bars` capture."""
    pcm = _pcm_frames(240, 11)
    cfg = DecoderConfig(system='NTSC', freq_mhz=40.0)
    wave = JE.encode_digital_audio(pcm, cfg.freq_hz)
    rf = JM.encode_frames(
        cfg, 3, JM.EncodeSpec(pattern='bars', cav_start_frame=900,
                              noise_rms=0.01), extra_baseband=0.25 * wave)
    path = tmp_path_factory.mktemp('efm') / 'cap.lds'
    path.write_bytes(JL.pack_data_4_40(rf).tobytes())
    return path, pcm


def test_cli_efm_against_jax(efm_lds, tmp_path):
    """`lddecode_torch.py --efm` writes the .efm.pcm and .subcode.log that
    `lddecode_tpu.py --efm` writes, byte for byte, and the known PCM is in
    them; the video of the same run is whole."""
    lds, pcm = efm_lds
    out_j, out_t = str(tmp_path / 'jax'), str(tmp_path / 'torch')
    with jax.enable_x64(False):
        assert lddecode_tpu.main([str(lds), out_j, '-n', '--efm', '-l',
                                  '1']) == 0
    assert lddecode_torch.main([str(lds), out_t, '-n', '--efm', '-l', '1',
                                '--device', 'cpu', '-q']) == 0
    for ext in ('.efm.pcm', '.subcode.log'):
        assert open(out_t + ext, 'rb').read() == open(out_j + ext,
                                                      'rb').read(), ext
    got = np.fromfile(out_t + '.efm.pcm', '<i2').reshape(-1, 2)
    n = (240 - 1) * 6
    np.testing.assert_array_equal(got[:n], pcm[6:6 + n])
    assert np.fromfile(out_t + '.tbc', np.uint16).size == 910 * 525


def test_chain_cli_efm(efm_lds, tmp_path, monkeypatch):
    """`ldchain_torch.py --efm` (NTSC): the same digital audio beside the
    RGB stream."""
    monkeypatch.setattr(shutil, 'which', lambda *_: None)
    lds, pcm = efm_lds
    out = str(tmp_path / 'chain')
    assert ldchain_torch.main([str(lds), out, '--device', 'cpu', '-d', '2',
                               '-l', '1', '--batch', '4', '--efm', '--raw',
                               '-q']) == 0
    got = np.fromfile(out + '.efm.pcm', '<i2').reshape(-1, 2)
    n = (240 - 1) * 6
    np.testing.assert_array_equal(got[:n], pcm[6:6 + n])
    assert open(out + '.subcode.log').read().startswith('# frames=')
    assert np.fromfile(out + '.rgb', np.uint16).size == 480 * 744 * 3
