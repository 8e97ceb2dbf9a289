"""PyTorch port, the Framer's and lddecode's options and failure paths
against the JAX package's, in the shape of tests/test_robustness.py: rot
and dropouts, a noise lead-in and resync, despackle and its rot level, the
field flip (-f), bottom-field-first pairing (-m), freeze-frame (-z),
audio only (-A), cut mode (-c), the cxADC 28.8 MSa/s field decode, the
VHS refusal, ldexport -t, and one whole decode with a complex128 bank
(--f64).

One 6-frame NTSC `flat50` capture (CAV from frame 900) serves every option
test.  The JAX side runs under jax.enable_x64(False) with a complex64 bank
(the --f64 test: both at float64).  Budgets (tests/torch_parity.py):
integer outputs exact (line counts, parities, next samples, CAV numbers,
line-0 words), line locations <= 0.02 px, pictures rows >= 24 p99.9 <= 2
and max <= 4 LSB, audio <= 0.6 LSB rms; at float64 the line locations
within 1e-6 px and the pictures within 1 LSB (float64 sums in another
order move a u16 value only at a rounding boundary).  On the rotted
capture the picture rows that read a rot event (RF noise, which the demod
clips to 65535) are held to the line structure only."""

import os
import shutil
import types

import jax
import numpy as np
import pytest
import torch

import ldexport_torch
import ldexport_tpu
import lddecode_torch
import lddecode_tpu
from ld_decode_tpu.io import loaders as JL
from ld_decode_tpu.models import encode as JE
from ld_decode_tpu.ops import filters as JF
from ld_decode_tpu.tbc import framer as JFR
from ld_decode_tpu.utils.params import DecoderConfig
from ld_decode_tpu_torch.comb import comb_ntsc as CN
from ld_decode_tpu_torch.io import loaders as TL
from ld_decode_tpu_torch.models import nn_comb as NC
from ld_decode_tpu_torch.ops import filters as TF
from ld_decode_tpu_torch.tape import vhs as V
from ld_decode_tpu_torch.tbc import framer as TFR
from ld_decode_tpu_torch.tbc.despackle import despackle as t_despackle
from ld_decode_tpu_torch.utils.params import DecoderConfig as TConfig

from torch_parity import LOC_TOL, assert_audio_close, assert_picture_close

torch.set_num_threads(2)

START = 33046
FRAME = 525 * 910
W = 910


@pytest.fixture(scope='module')
def flat(tmp_path_factory):
    """The shared capture, both packages' configurations and banks, and
    the capture as an .lds file."""
    cfg = DecoderConfig(system='NTSC', freq_mhz=40.0)
    cap = JE.encode_frames(cfg, 6, JE.EncodeSpec(pattern='flat50',
                                                 cav_start_frame=900))
    lds = tmp_path_factory.mktemp('robust') / 'cap.lds'
    lds.write_bytes(JL.pack_data_4_40(cap).tobytes())
    tcfg = TConfig(system='NTSC', freq_mhz=40.0)
    return types.SimpleNamespace(
        cfg=cfg, tcfg=tcfg, cap=cap, lds=lds,
        jbank=JF.make_demod_bank(cfg, np.complex64),
        tbank=TF.make_demod_bank(tcfg, np.complex64, device='cpu'))


def _frames(fr, n, start=START):
    out, s = [], start
    for i in range(n):
        rv = fr.readframe(None, s, i == 0)
        if rv[0] is None:
            break
        out.append(rv)
        s = rv[2]
    return out


def _both(flat, capture, n, **kw):
    """n frames from the same start on both packages' sequential Framers
    (batch 1, the JAX package's default)."""
    with jax.enable_x64(False):
        jf = JFR.Framer(flat.cfg, flat.jbank, capture=capture, batch=1, **kw)
        jout = _frames(jf, n)
    tf = TFR.Framer(flat.tcfg, flat.tbank, capture=capture, batch=1,
                    device='cpu', **kw)
    return jout, _frames(tf, n), jf, tf


def _rf_noise_rows(frame) -> np.ndarray:
    """Rows of a flat-50 frame that read a rot event: the FM demod of RF
    noise clips to 65535, a value the flat-50 frame never takes."""
    return (np.asarray(frame).reshape(525, W) == 65535).any(axis=1)


def _assert_same_frames(tout, jout, noise_rows=None):
    """Frames equal to the budgets; rows that read RF noise (noise_rows:
    one mask a frame) are held to the line structure only: there float32
    rounding of the demod is amplified without bound."""
    assert len(tout) == len(jout) >= 1
    for k, (a, b) in enumerate(zip(jout, tout)):
        assert b[2] == a[2]
        np.testing.assert_array_equal(b[0][:16], np.asarray(a[0])[:16])
        keep = ~noise_rows[k] if noise_rows is not None else slice(None)
        assert_picture_close(b[0].reshape(525, W)[keep],
                             np.asarray(a[0]).reshape(525, W)[keep])
        for fa, fb in zip(a[3], b[3]):
            assert (fb.valid, fb.istop, fb.linecount, fb.linecode) \
                == (fa.valid, fa.istop, fa.linecount, fa.linecode)
            assert np.abs(fb.linelocs - fa.linelocs).max() <= LOC_TOL
        assert_audio_close(b[1], a[1])


@pytest.fixture(scope='module')
def rotted(flat):
    """12 rot events of ~8 us in the second frame
    (tests/test_robustness.py::test_dropout_rot_recovery)."""
    rng = np.random.default_rng(0)
    corrupted = np.array(flat.cap)
    for _ in range(12):
        p = 1500000 + int(rng.integers(0, 1200000))
        corrupted[p:p + 320] = rng.integers(0, 1024, 320)
    return corrupted


@pytest.fixture(scope='module')
def rot_decodes(flat, rotted):
    """Two frames of the rotted capture on both packages, and the rows of
    each that read a rot event (in either package's frame)."""
    jout, tout, _, _ = _both(flat, rotted, 2)
    noise = [_rf_noise_rows(a[0]) | _rf_noise_rows(b[0])
             for a, b in zip(jout, tout)]
    return jout, tout, noise


def test_dropout_rot_recovery(flat, rot_decodes):
    """The decoder keeps the field structure through rot and repairs the
    affected line locations, as the JAX package's does."""
    jout, tout, noise = rot_decodes
    assert 0 < sum(int(m.sum()) for m in noise) < 40
    _assert_same_frames(tout, jout, noise)
    for f in tout[1][3]:
        assert f.valid and f.linecount in (262, 263)
        d = np.diff(f.linelocs[12:-12])
        assert np.abs(d - flat.cfg.linelen).max() < flat.cfg.freq_mhz * 2


def test_garbage_then_signal_resync(flat):
    """A small noise lead-in is ridden through; a window-filling one
    triggers the second-scale resync jumps, which on a short capture end
    at EOF without an exception: both packages land on the same sample."""
    rng = np.random.default_rng(1)
    lead = rng.integers(400, 600, 60_000).astype(np.uint16)
    jout, tout, jf, tf = _both(flat, np.concatenate([lead, flat.cap]), 1)
    _assert_same_frames(tout, jout)
    assert tf.vbi['framenr'] == jf.vbi['framenr'] is not None

    big = rng.integers(400, 600, 2_000_000).astype(np.uint16)
    cap = np.concatenate([big, flat.cap])
    with jax.enable_x64(False):
        jrv = JFR.Framer(flat.cfg, flat.jbank, capture=cap).readframe(
            None, START, True)
    tf2 = TFR.Framer(flat.tcfg, flat.tbank, capture=cap, batch=1,
                     device='cpu')
    trv = tf2.readframe(None, START, True)
    assert (trv[0] is None) == (jrv[0] is None)
    assert trv[0] is None or tf2.vbi['framenr'] is not None
    assert trv[2] == jrv[2]


@pytest.mark.parametrize('rot_level', [40.0, 100.0])
def test_despackle(flat, rotted, rot_decodes, rot_level):
    """--despackle and -r: the Framer conceals rot with the .tbc scale and
    its rot level (the frame equals despackle() of the plain decode), and
    matches the JAX package's despackled frame outside the rows that read
    a rot event."""
    _, plain, noise = rot_decodes
    jout, tout, _, _ = _both(flat, rotted, 2, despackle=True,
                             rot_level=rot_level)
    _assert_same_frames(tout, jout, noise)
    scale = (0xc800 - 0x0400) / (100 - flat.cfg.sys.vsync_ire)
    for p, t in zip(plain, tout):
        want = t_despackle(p[0].copy(), W, scale, 1024,
                           flat.cfg.sys.vsync_ire, rot_level=rot_level)
        np.testing.assert_array_equal(t[0], want)
    changed = [int((p[0] != t[0]).sum()) for p, t in zip(plain, tout)]
    if rot_level == 40.0:
        assert changed[1] > 0            # the rot in frame 2 was concealed


def test_despackle_rot_level():
    """The rot-level window on a synthetic frame
    (tests/test_robustness.py::test_despackle_rot_level)."""
    pic = np.full((525, 910), 20000, np.uint16)
    pic[100, 200] = 5                    # ~-42.8 IRE on the .tbc scale
    out = t_despackle(pic.copy(), rot_level=40.0).reshape(525, 910)
    assert abs(int(out[100, 200]) - 20000) < 4
    out2 = t_despackle(pic.copy(), rot_level=100.0).reshape(525, 910)
    assert out2[100, 200] == 5


def test_flip_fields_weave(flat):
    """-f swaps which field lands on the even output rows, on the host
    weave and on the device weave of the chain mode, as in the JAX
    package."""
    half = 262
    fa = types.SimpleNamespace(dspicture=np.full(half * W, 111, np.uint16),
                               linecount=half, dev_picture=None)
    fb = types.SimpleNamespace(dspicture=np.full((half + 1) * W, 222,
                                                 np.uint16),
                               linecount=half + 1, dev_picture=None)
    pics = torch.stack([torch.full((263, W), 111, dtype=torch.int32),
                        torch.full((263, W), 222, dtype=torch.int32)])
    for flip in (False, True):
        jfr = JFR.Framer(flat.cfg, flat.jbank, flip_fields=flip)
        want = jfr.formatoutput([fa, fb]).reshape(-1, W)
        tfr = TFR.Framer(flat.tcfg, flat.tbank, capture=np.zeros(10),
                         batch=1, flip_fields=flip, device='cpu')
        got = tfr.formatoutput([fa, fb]).reshape(-1, W)
        np.testing.assert_array_equal(got, want)
        assert (got[0, 0], got[1, 0]) == ((222, 111) if flip else (111, 222))
        dev = [types.SimpleNamespace(dspicture=None, dev_picture=(pics, k),
                                     linecount=f.linecount)
               for k, f in enumerate((fa, fb))]
        woven = tfr.formatoutput(dev).reshape(-1, W).numpy()
        np.testing.assert_array_equal(woven, want)


def test_bff_pairing(flat):
    """-m pairs frames bottom field first: the batched port's decode order
    (tests/test_robustness.py::test_bff_pairing), and the sequential
    frames against the JAX package's."""
    for bff in (False, True):
        fr = TFR.Framer(flat.tcfg, flat.tbank, capture=flat.cap, batch=4,
                        bff=bff, device='cpu')
        rv = fr.readframe(None, START, True)
        top, bot = rv[3]
        assert top.istop and not bot.istop
        assert (bot.readsample < top.readsample) == bff
    jout, tout, jf, tf = _both(flat, flat.cap, 1, bff=True)
    _assert_same_frames(tout, jout)
    assert tf.vbi == jf.vbi


def _cli(tmp_path, lds, flags, name):
    out_j, out_t = str(tmp_path / f'j{name}'), str(tmp_path / f't{name}')
    with jax.enable_x64(False):
        assert lddecode_tpu.main([str(lds), out_j, '--pic-mode', 'raw', '-q']
                                 + flags) == 0
    assert lddecode_torch.main([str(lds), out_t, '-q', '--device', 'cpu']
                               + flags) == 0
    return out_j, out_t


def test_cli_freeze_frame(flat, tmp_path):
    """-z: one decoded frame repeats for the requested length."""
    out_j, out_t = _cli(tmp_path, flat.lds, ['-l', '3', '-z'], 'z')
    tj, tt = (np.fromfile(o + '.tbc', '<u2') for o in (out_j, out_t))
    assert tj.size == tt.size == 3 * FRAME
    frames = tt.reshape(3, -1)
    assert np.array_equal(frames[0], frames[1])
    assert np.array_equal(frames[0], frames[2])
    np.testing.assert_array_equal(frames[0][:16], tj[:16])
    assert_picture_close(frames[0].reshape(525, W), tj[:FRAME].reshape(525, W))


def test_cli_audio_only(flat, tmp_path):
    """-A: the decode runs and writes the .pcm, no .tbc."""
    out_j, out_t = _cli(tmp_path, flat.lds, ['-l', '1', '-A'], 'a')
    assert not os.path.exists(out_t + '.tbc')
    pj, pt = (np.fromfile(o + '.pcm', '<i2') for o in (out_j, out_t))
    assert pt.size > 3000
    assert_audio_close(pt, pj)


def test_cli_cut_mode(flat, tmp_path):
    """-c re-encodes a frame range to .r16 (the same bytes as the JAX
    package's cut), which itself decodes to those frames."""
    out_j, out_t = _cli(tmp_path, flat.lds, ['-S', '902', '-E', '904', '-c'],
                        'c')
    rj, rt = (np.fromfile(o + '.r16', '<i2') for o in (out_j, out_t))
    spf = int(flat.cfg.freq_hz / flat.cfg.sys.fps)
    assert spf < rt.size < 4 * spf
    np.testing.assert_array_equal(rt, rj)
    out = str(tmp_path / 'recut')
    assert lddecode_torch.main([out_t + '.r16', out, '-l', '1', '-q',
                                '--device', 'cpu']) == 0
    tbc = np.fromfile(out + '.tbc', np.uint16)
    assert tbc.size == FRAME
    assert 901 <= ((int(tbc[14]) << 16) | int(tbc[15])) <= 904


def test_cxadc_rate_field_decode():
    """The cxADC 28.8 MSa/s capture rate: a field and a frame at batch 4
    and nblocks 50 against the JAX package's, and the flat-50 picture at
    its 50-IRE output level."""
    cfg = DecoderConfig(system='NTSC', freq_mhz=28.8)
    tcfg = TConfig(system='NTSC', freq_mhz=28.8)
    cap = JE.encode_frames(cfg, 3, JE.EncodeSpec(pattern='flat50',
                                                 cav_start_frame=7))
    with jax.enable_x64(False):
        jf = JFR.Framer(cfg, JF.make_demod_bank(cfg, np.complex64),
                        capture=cap, batch=4, nblocks=50)
        jf0, jrs0, _ = jf.readfield(None, 20000)
        jrv = jf.readframe(None, jrs0, True)
    tf = TFR.Framer(tcfg, TF.make_demod_bank(tcfg, device='cpu'),
                    capture=cap, batch=4, nblocks=50, device='cpu')
    f0, rs0, _ = tf.readfield(None, 20000)
    assert f0 is not None and f0.valid and rs0 == jrs0
    frame, audio, nxt, fields = tf.readframe(None, rs0, True)
    assert frame is not None and nxt == jrv[2]
    assert fields[0].linecount in (cfg.sys.frame_lines // 2,
                                   cfg.sys.frame_lines // 2 + 1)
    wo = cfg.sys.outlinelen
    np.testing.assert_array_equal(frame[:16], np.asarray(jrv[0])[:16])
    assert_picture_close(frame.reshape(-1, wo),
                         np.asarray(jrv[0]).reshape(-1, wo))
    pic = frame.reshape(-1, wo)
    mid = pic[60:200, wo // 4:wo // 2].astype(np.float64)
    out_scale = float(0xc800 - 0x0400) / (100 - cfg.sys.vsync_ire)
    ire = (mid - 1024) / out_scale + cfg.sys.vsync_ire
    assert abs(np.median(ire) - 50.0) < 1.5, np.median(ire)


def test_vhs_profile_rejected_by_tbc():
    """The VHS profile is demod-only (tape/vhs.py): the TBC refuses it
    with the JAX package's error."""
    cfg = V.vhs_config()
    bank = TF.make_demod_bank(cfg, np.complex64, device='cpu')
    with pytest.raises(ValueError, match='demod-only'):
        TFR.Framer(cfg, bank, capture=np.zeros(10_000_000, np.uint16),
                   device='cpu')


def test_cli_ldexport_training_mode(tmp_path, monkeypatch):
    """ldexport -t: forces dim 3 and per-frame images and writes
    <out>.train.npz, from the streaming and from the windowed comb alike;
    its pairs equal the JAX tool's on the same .tbc (the inputs exactly,
    the clp targets within 1e-5 of their peak)."""
    monkeypatch.setattr(shutil, 'which', lambda *_: None)
    inp, *_ = NC.synth_batch(torch.Generator().manual_seed(4), 4, CN.IN_Y,
                             CN.IN_X)
    frames = np.clip((inp[..., 0].numpy() + 1.0) * 32768.0,
                     0, 65535).astype(np.uint16)
    frames[..., 0] = np.where(inp[:, :, 0, 1].numpy() > 0, 16384, 32768)
    tbc = tmp_path / 'cap.tbc'
    tbc.write_bytes(frames.tobytes())

    assert ldexport_torch.main([str(tbc), str(tmp_path / 'mov'), '-t', '-F',
                                '--device', 'cpu']) == 0
    d = np.load(tmp_path / 'mov.train.npz')
    assert d['inputs'].shape == (2, CN.IN_Y, CN.IN_X, 3)
    assert d['clp'].shape == (2, CN.IN_Y, CN.IN_X)
    assert (tmp_path / 'mov_0.rgb').exists()
    # the windowed comb collects the same frames
    assert ldexport_torch.main([str(tbc), str(tmp_path / 'win'), '-t', '-F',
                                '--comb-batch', '3', '--device', 'cpu']) == 0
    w = np.load(tmp_path / 'win.train.npz')
    np.testing.assert_array_equal(w['inputs'], d['inputs'])
    np.testing.assert_array_equal(w['clp'], d['clp'])

    with jax.enable_x64(False):
        assert ldexport_tpu.main([str(tbc), str(tmp_path / 'jmov'), '-t',
                                  '-F']) == 0
    j = np.load(tmp_path / 'jmov.train.npz')
    np.testing.assert_array_equal(d['inputs'], j['inputs'])
    peak = np.abs(j['clp']).max()
    assert np.abs(d['clp'] - j['clp']).max() <= 1e-5 * peak
    imgs = sorted(p.name for p in tmp_path.glob('mov_*.rgb'))
    assert imgs == sorted(p.name[1:] for p in tmp_path.glob('jmov_*.rgb'))


def test_f64_whole_decode():
    """--f64: a whole decode with a complex128 bank, at batch 1 on a
    loader's window and batched on the resident capture, against the JAX
    package's float64 decode: line locations within 1e-6 px, pictures
    within 1 LSB, audio within the audio budget."""
    cfg = DecoderConfig(system='NTSC', freq_mhz=40.0)
    tcfg = TConfig(system='NTSC', freq_mhz=40.0)
    cap = JE.encode_frames(cfg, 3, JE.EncodeSpec(pattern='ramp',
                                                 cav_start_frame=900))
    with jax.enable_x64(True):
        jf = JFR.Framer(cfg, JF.make_demod_bank(cfg, np.complex128),
                        loader=JL.make_array_loader(cap))
        jrv = jf.readframe(None, START, True)
    bank = TF.make_demod_bank(tcfg, np.complex128, device='cpu')
    assert bank.rdtype == torch.float64
    seq = TFR.Framer(tcfg, bank, TL.make_array_loader(cap), batch=1,
                     device='cpu').readframe(None, START, True)
    assert seq[2] == jrv[2]
    np.testing.assert_array_equal(seq[0][:16], jrv[0][:16])
    d = np.abs(seq[0].astype(np.int64) - jrv[0].astype(np.int64))
    assert d.reshape(525, W)[24:].max() <= 1
    for fa, fb in zip(jrv[3], seq[3]):
        assert (fb.istop, fb.linecount, fb.linecode) == (fa.istop,
                                                         fa.linecount,
                                                         fa.linecode)
        assert np.abs(fb.linelocs - fa.linelocs).max() <= 1e-6
    assert_audio_close(seq[1], jrv[1])
    # the batched path at float64: the same frame as the sequential one
    # to the budgets of tests/test_torch_field_seq.py::test_batch1_against_
    # batch8 (structure exact, pictures p99.9 <= 2, max <= 64 LSB)
    bat = TFR.Framer(tcfg, bank, capture=cap, batch=4,
                     device='cpu').readframe(None, START, True)
    assert bat[2] == seq[2]
    for fa, fb in zip(seq[3], bat[3]):
        assert (fa.istop, fa.linecount, fa.vbi) == (fb.istop, fb.linecount,
                                                    fb.vbi)
    d = np.abs(bat[0].astype(np.int64) - seq[0].astype(np.int64))
    assert np.percentile(d, 99.9) <= 2 and d.max() <= 64
