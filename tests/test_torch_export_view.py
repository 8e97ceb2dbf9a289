"""PyTorch port, the two-step CLIs: ldexport_torch.py against ldexport_tpu.py
on the same .tbc/.pcm, and ldview_torch.py against ldview_tpu.py.

The .tbc files are the port's own decode (lddecode_torch.py on the CPU) of
synthetic captures (NTSC `ramp`, PAL `palbars`, CAV from frame 900): both
exporters read the same file.  Budgets: RGB within 1 LSB (of 16 bits, or of
8 bits with -8), frame counts equal; CX audio within 1 LSB.  With ffmpeg
patched away both write raw .rgb streams.  The CX test runs a small block
geometry in both packages (core 4096, warm 40000, so the 40,000-sample
.pcm is one exact block); tests/test_torch_cx_file.py holds the production
geometry.  The PAL comb's V-switch vote ties by construction
(tests/test_torch_comb_pal.py): a PAL frame off the budget must be inside
it under a forced candidate, as tests/test_torch_chain.py allows."""

import shutil

import jax
import numpy as np
import pytest
import torch

import lddecode_torch
import ldexport_torch
import ldexport_tpu
import ldview_torch
import ldview_tpu
from ld_decode_tpu.audio import cx as JCX
from ld_decode_tpu.io import loaders as JL
from ld_decode_tpu.models import encode as JE
from ld_decode_tpu.utils.params import DecoderConfig
from ld_decode_tpu_torch.audio import cx as TCX

torch.set_num_threads(2)

FRAME_RGB = 480 * 744 * 3
FRAME_PAL = 576 * 1135 * 3


@pytest.fixture(scope='module')
def ntsc(tmp_path_factory):
    """A 5-frame NTSC .r16 capture and its decode (3 frames of .tbc)."""
    d = tmp_path_factory.mktemp('export')
    cfg = DecoderConfig(system='NTSC', freq_mhz=40.0)
    cap = JE.encode_frames(cfg, 5, JE.EncodeSpec(pattern='ramp',
                                                 cav_start_frame=900))
    r16 = d / 'cap.r16'
    (cap.astype(np.int32) - 32768).astype('<i2').tofile(r16)
    assert lddecode_torch.main([str(r16), str(d / 'dec'), '-q',
                                '--device', 'cpu']) == 0
    return d, r16


def _export(tmp_path, tbc, flags):
    out_j, out_t = str(tmp_path / 'jax'), str(tmp_path / 'torch')
    with jax.enable_x64(False):
        assert ldexport_tpu.main([str(tbc), out_j] + flags) == 0
    assert ldexport_torch.main([str(tbc), out_t, '--device', 'cpu']
                               + flags) == 0
    return out_j, out_t


def _lsb(a, b):
    return np.abs(a.astype(np.int64) - b.astype(np.int64))


@pytest.mark.parametrize('flags', [
    ['-d', '2'], ['-d', '3', '-F'], ['-d', '3', '-F', '--comb-batch', '2'],
    ['-d', '2', '--comb-batch', '2'], ['-D'], ['-d', '3', '-F', '-k'],
    ['-d', '2', '--debug-line', '100']])
def test_export_against_jax(ntsc, tmp_path, monkeypatch, flags):
    """RGB48 streams: the frame-at-a-time comb (dims 2 and 3 -F, and the
    debug surfaces -D, -k, --debug-line) and the windowed feed/collect
    loop (--comb-batch 2)."""
    monkeypatch.setattr(shutil, 'which', lambda *_: None)
    d, _ = ntsc
    out_j, out_t = _export(tmp_path, d / 'dec.tbc', flags)
    rj, rt = (np.fromfile(o + '.rgb', '<u2') for o in (out_j, out_t))
    assert rj.size == rt.size and rj.size >= FRAME_RGB
    assert rj.size % FRAME_RGB == 0
    assert _lsb(rt, rj).max() <= 1


def test_export_8bit_vbi_images(ntsc, tmp_path, monkeypatch):
    """-8 -v -L -I 0 -n 2 --write-images: 8-bit frames of the full field
    height (525 lines, the VBI area included), one .rgb image a frame."""
    monkeypatch.setattr(shutil, 'which', lambda *_: None)
    d, _ = ntsc
    out_j, out_t = _export(tmp_path, d / 'dec.tbc',
                           ['-8', '-v', '-L', '-I', '0', '-n', '2',
                            '--write-images', '-d', '2'])
    for k in range(3):
        a, b = (np.fromfile(f'{o}_{k}.rgb', np.uint8) for o in (out_j,
                                                                 out_t))
        assert a.size == b.size == 525 * 744 * 3
        assert _lsb(b, a).max() <= 1


def _programme_pcm(path, n):
    rng = np.random.default_rng(21)
    t = np.arange(n) / 48000.0
    env = np.repeat(rng.choice([0.05, 0.3, 0.9], -(-n // 8000)), 8000)[:n]
    pcm = np.empty(2 * n, '<i2')
    pcm[0::2] = (20000 * env * np.sin(2 * np.pi * 997 * t)).astype('<i2')
    pcm[1::2] = (15000 * env * np.sin(2 * np.pi * 1501 * t)).astype('<i2')
    pcm.tofile(path)


def test_export_audio_cx(ntsc, tmp_path, monkeypatch):
    """-a on a .pcm of 40,000 stereo samples (one chunk of at least 32,768,
    so the block-parallel envelopes run), with and without --no-cx."""
    monkeypatch.setattr(shutil, 'which', lambda *_: None)
    geo = (0.0, 0.0, 4096, 40000, 0.05)
    monkeypatch.setattr(JCX.envelope_followers_blocked, '__defaults__', geo)
    monkeypatch.setattr(TCX.envelope_followers_blocked, '__defaults__',
                        geo + ('cuda',))
    d, _ = ntsc
    pcm = tmp_path / 'in.pcm'
    _programme_pcm(pcm, 40000)
    for extra in ([], ['--no-cx']):
        out_j, out_t = _export(tmp_path, d / 'dec.tbc',
                               ['-d', '2', '-l', '1', '-a', str(pcm)] + extra)
        aj, at = (np.fromfile(o + '.audio.pcm', '<i2') for o in (out_j,
                                                                  out_t))
        assert aj.size == at.size == 80000
        assert _lsb(at, aj).max() <= 1
        # -l stops the video, not the audio (ldexport_tpu.py's behaviour)
        assert np.fromfile(out_t + '.rgb', '<u2').size == FRAME_RGB


def test_export_training_raises(ntsc, tmp_path, monkeypatch):
    """-t (NN-comb training mode) on the decoded .tbc: the same per-frame
    images as ldexport_tpu.py -t within 1 LSB, and the same training pairs
    (the inputs equal, the clp targets within 1e-5 of their peak)."""
    monkeypatch.setattr(shutil, 'which', lambda *_: None)
    d, _ = ntsc
    out_j, out_t = _export(tmp_path, d / 'dec.tbc', ['-t', '-F'])
    tj, tt = np.load(out_j + '.train.npz'), np.load(out_t + '.train.npz')
    assert tt['inputs'].shape == tj['inputs'].shape == (1, 525, 910, 3)
    np.testing.assert_array_equal(tt['inputs'], tj['inputs'])
    assert np.abs(tt['clp'] - tj['clp']).max() \
        <= 1e-5 * np.abs(tj['clp']).max()
    names = sorted(p.name[len('torch'):] for p in tmp_path.glob('torch_*'))
    assert names and names == sorted(p.name[len('jax'):]
                                     for p in tmp_path.glob('jax_*'))
    for n in names:
        a = np.fromfile(out_j + n, '<u2')
        b = np.fromfile(out_t + n, '<u2')
        assert _lsb(b, a).max() <= 1


@pytest.fixture(scope='module')
def pal_tbc(tmp_path_factory):
    d = tmp_path_factory.mktemp('export_pal')
    cfg = DecoderConfig(system='PAL', freq_mhz=40.0)
    cap = JE.encode_frames(cfg, 4, JE.EncodeSpec(pattern='palbars',
                                                 cav_start_frame=900))
    lds = d / 'cap.lds'
    lds.write_bytes(JL.pack_data_4_40(cap).tobytes())
    assert lddecode_torch.main([str(lds), str(d / 'dec'), '-p', '-q',
                                '--device', 'cpu']) == 0
    return d / 'dec.tbc'


def _pal_off(rj, rt):
    off = []
    for k in range(rj.size // FRAME_PAL):
        sl = slice(k * FRAME_PAL, (k + 1) * FRAME_PAL)
        if _lsb(rt[sl], rj[sl]).max() > 1:
            off.append(k)
    return off


def test_export_pal(pal_tbc, tmp_path, monkeypatch):
    """--pal -d 3: the streaming PALComb (frame 0 2D at once, then the
    3-frame ring, the final frame from flush()), 1135 x 576 RGB48."""
    from ld_decode_tpu_torch.comb import comb_pal as TP
    monkeypatch.setattr(shutil, 'which', lambda *_: None)
    flags = ['--pal', '-d', '3']
    out_j, out_t = _export(tmp_path, pal_tbc, flags)
    rj, rt = (np.fromfile(o + '.rgb', '<u2') for o in (out_j, out_t))
    assert rj.size == rt.size and rj.size >= 2 * FRAME_PAL
    assert rj.size % FRAME_PAL == 0
    off = _pal_off(rj, rt)
    assert len(off) < rj.size // FRAME_PAL
    for k in (1, 2, 3):
        if not off:
            break
        monkeypatch.setattr(
            TP, 'vswitch_choice',
            lambda u, v, k=k: torch.full(u.shape[:-2], k, dtype=torch.long))
        out_k = str(tmp_path / f'torch{k}')
        assert ldexport_torch.main([str(pal_tbc), out_k, '--device', 'cpu']
                                   + flags) == 0
        still = set(_pal_off(rj, np.fromfile(out_k + '.rgb', '<u2')))
        off = [f for f in off if f in still]
    assert not off, off


def test_view_against_jax(ntsc, tmp_path):
    """ldview seeks CAV frame 902 with findframe, decodes it through the
    sequential Framer and combs it with a static ring: the same 744 x 480
    image as ldview_tpu.py, within 1 LSB of 8 bits."""
    _, r16 = ntsc
    out_j, out_t = str(tmp_path / 'j.png'), str(tmp_path / 't.png')
    with jax.enable_x64(False):
        assert ldview_tpu.main([str(r16), '902', out_j, '-d', '2']) == 0
    assert ldview_torch.main([str(r16), '902', out_t, '-d', '2',
                              '--device', 'cpu']) == 0
    from PIL import Image
    a, b = (np.asarray(Image.open(o)) for o in (out_j, out_t))
    assert a.shape == b.shape == (480, 744, 3)
    assert _lsb(b, a).max() <= 1
    assert b.max() > 100
