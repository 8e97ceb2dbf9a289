"""PyTorch port, the sequential `--batch 1` decode: FieldDecoder.process and
Framer(loader=..., batch=1) against the JAX package's on the same synthetic
captures (NTSC `ramp`, PAL `palbars`, CAV from frame 900), the port's
sequential frame against its batched one, and lddecode_torch.py --batch 1
against lddecode_tpu.py --batch 1.

Budgets (tests/torch_parity.py): integer outputs exact (line counts,
parities, next-field offsets, peak and vsync counts, Philips codes, line-0
words); line locations <= 0.02 px; picture rows >= 24 p99.9 <= 2 and max
<= 4 LSB (PAL's tail-sanitized rows to 16); audio <= 0.6 LSB rms.  The
port's every resample goes through K1's dispatcher at B=1, whose wow factor
is the float32 step length over the nominal line (the JAX package's
sequential path divides a float64 diff): burst levels agree to 1e-5 of
their size.  The port's sequential frame against its batched one: the
tolerances of tests/test_fused.py for the JAX package's two paths."""

import jax
import numpy as np
import pytest
import torch

import lddecode_torch
import lddecode_tpu
from ld_decode_tpu.io import loaders as JL
from ld_decode_tpu.models import encode as JE
from ld_decode_tpu.ops import filters as JF
from ld_decode_tpu.tbc import framer as JFR
from ld_decode_tpu.utils.params import DecoderConfig
from ld_decode_tpu_torch.io import loaders as TL
from ld_decode_tpu_torch.ops import filters as TF
from ld_decode_tpu_torch.tbc import cuda_resample as CR
from ld_decode_tpu_torch.tbc import field as TFD
from ld_decode_tpu_torch.tbc import framer as TFR
from ld_decode_tpu_torch.utils.params import DecoderConfig as TConfig

from torch_parity import (LOC_TOL, TAIL_ROWS, assert_audio_close,
                          assert_pal_picture, assert_picture_close)

torch.set_num_threads(2)

SYSTEMS = {'NTSC': dict(pattern='ramp', start=33046),
           'PAL': dict(pattern='palbars', start=2560 * 14)}


def _frames(framer, start, n=2):
    out, s = [], start
    for i in range(n):
        rv = framer.readframe(None, s, i == 0)
        if rv[0] is None:
            break
        out.append(rv)
        s = rv[2]
    return out


@pytest.fixture(scope='module', params=list(SYSTEMS))
def seq(request):
    """Both packages' sequential framers over the same 3-frame capture."""
    system = request.param
    p = SYSTEMS[system]
    cfg = DecoderConfig(system=system, freq_mhz=40.0)
    cap = JE.encode_frames(cfg, 3, JE.EncodeSpec(pattern=p['pattern'],
                                                 cav_start_frame=900))
    with jax.enable_x64(False):
        jf = JFR.Framer(cfg, JF.make_demod_bank(cfg, np.complex64),
                        loader=JL.make_array_loader(cap))
        jframes = _frames(jf, p['start'])
    tcfg = TConfig(system=system, freq_mhz=40.0)
    tbank = TF.make_demod_bank(tcfg, np.complex64, device='cpu')
    tf = TFR.Framer(tcfg, tbank, loader=TL.make_array_loader(cap), batch=1,
                    device='cpu')
    tframes = _frames(tf, p['start'])
    return dict(system=system, cfg=cfg, tcfg=tcfg, cap=cap, tbank=tbank,
                jf=jf, tf=tf, jframes=jframes, tframes=tframes)


def _field_picture(seq, f):
    W = seq['cfg'].sys.outlinelen
    return f.dspicture.reshape(-1, W)


def test_process_fields(seq):
    """Each field of FieldDecoder.process: decisions exact, line
    locations, burst levels, picture and audio within budget."""
    assert seq['tf'].prefetcher is None
    assert len(seq['tframes']) == len(seq['jframes']) >= 1
    for a, b in zip(seq['jframes'], seq['tframes']):
        for fa, fb in zip(a[3], b[3]):
            assert (fb.valid, fb.istop, fb.linecount, fb.nextfieldoffset,
                    fb.peak_count, fb.vsync_count, fb.readsample) \
                == (fa.valid, fa.istop, fa.linecount, fa.nextfieldoffset,
                    fa.peak_count, fa.vsync_count, fa.readsample)
            assert fb.linecode == fa.linecode and fb.vbi == fa.vbi
            assert np.abs(fb.linelocs - fa.linelocs).max() <= LOC_TOL
            if seq['system'] == 'NTSC':
                np.testing.assert_array_equal(np.sign(fb.burstlevel),
                                              np.sign(fa.burstlevel))
                assert np.abs(fb.burstlevel - fa.burstlevel).max() \
                    <= 1e-5 * np.abs(fa.burstlevel).max()
            else:
                assert fa.burstlevel is None and fb.burstlevel is None
            pa, pb = _field_picture(seq, fa), _field_picture(seq, fb)
            assert pb.dtype == np.uint16 and pb.shape == pa.shape
            _assert_pic(seq['system'], pb, pa)
            assert_audio_close(fb.dsaudio, fa.dsaudio)
            assert abs(fb.audio_next_offset - fa.audio_next_offset) < 1e-9


def test_readframe(seq):
    """Framer(loader=..., batch=1).readframe: next sample, line-0 words,
    CAV number, frame picture and the frame's audio."""
    assert seq['tf'].vbi['framenr'] == seq['jf'].vbi['framenr'] is not None
    cfg = seq['cfg']
    shape = (cfg.sys.frame_lines, cfg.sys.outlinelen)
    for a, b in zip(seq['jframes'], seq['tframes']):
        assert b[2] == a[2]
        assert b[0].dtype == np.uint16 and b[0].shape == a[0].shape
        np.testing.assert_array_equal(b[0][:16], a[0][:16])
        if seq['system'] == 'NTSC':
            assert_picture_close(b[0].reshape(shape), a[0].reshape(shape))
        else:
            assert_pal_picture(b[0].reshape(shape), a[0].reshape(shape),
                               per_row=2)
        assert_audio_close(b[1], a[1])
    assert seq['tf'].audio_offset == pytest.approx(seq['jf'].audio_offset,
                                                   abs=1e-9)


def _assert_pic(system, got, want):
    if system == 'NTSC':
        assert_picture_close(got, want)
    else:
        assert_pal_picture(got, want, rows=want.shape[0])


def test_refinement_steps(seq):
    """The burst pass, the picture resample and the VBI slice alone, from
    the JAX field's own float64 line locations: K1's dispatcher at B=1
    (the 48-column burst window against the JAX full-width call) and the
    host slicer on a host copy of each code line's window."""
    cfg, tcfg = seq['cfg'], seq['tcfg']
    with jax.enable_x64(False):
        jf = JFR.Framer(cfg, JF.make_demod_bank(cfg, np.complex64),
                        loader=JL.make_array_loader(seq['cap']))
        _, rs, _ = jf.readfield(None, SYSTEMS[seq['system']]['start'])
        win = jf._load(None, rs)
        jd = jf.decoder
        fa = jd.process(win, jf.mtf_level)
        jvid, _ = jd.demod(win, jf.mtf_level)
        if seq['system'] == 'NTSC':
            jll, jbl = jd.refine_linelocs_burst(jvid, fa.linelocs,
                                                fa.linecount)
        jpic = jd.downscale_picture(jvid, fa.linelocs, fa.linecount,
                                    fa.burstlevel)
        jcode, jvbi = jd.decode_vbi(jvid, fa.linelocs)
    assert fa.valid
    td = TFD.FieldDecoder(tcfg, seq['tbank'], 66, device='cpu')
    tvid, _ = td.demod(win, jf.mtf_level)
    launches = CR.resample_lines_batch.launches
    if seq['system'] == 'NTSC':
        tll, tbl = td.refine_linelocs_burst(tvid, fa.linelocs, fa.linecount)
        assert np.abs(tll - jll).max() <= LOC_TOL
        np.testing.assert_array_equal(np.sign(tbl), np.sign(jbl))
    tpic = td.downscale_picture(tvid, fa.linelocs, fa.linecount,
                                fa.burstlevel)
    assert CR.resample_lines_batch.launches == launches   # CPU: plain
    W = cfg.sys.outlinelen
    _assert_pic(seq['system'], tpic.reshape(-1, W), jpic.reshape(-1, W))
    assert td.decode_vbi(tvid, fa.linelocs) == (jcode, jvbi)


def test_batch1_against_batch8(seq):
    """The port's sequential frame against its batched frame and its
    resident sequential frame (process_resident, the pair of
    tests/test_fused.py) from the same start, to tests/test_fused.py's
    budgets for the JAX package's two paths: structure exact, line
    locations < 0.05 px, picture p99.9 <= 2 / max <= 64 LSB, audio p99.9
    <= 2 LSB and lengths within 2.  The batched frame's audio carry
    advances per field, the sequential one's per frame, so only the
    resident frame's audio is compared; PAL's 11 tail-sanitized rows a
    field are held to the max alone, and PAL audio to torch_parity's
    budget (the 48 kHz chase takes the neighbouring sample on a few ticks
    of the steep test tone)."""
    start = SYSTEMS[seq['system']]['start']
    rv1 = seq['tframes'][0]
    W = seq['cfg'].sys.outlinelen
    for batch in (8, 1):
        tf = TFR.Framer(seq['tcfg'], seq['tbank'], capture=seq['cap'],
                        batch=batch, device='cpu')
        rv = tf.readframe(None, start, True)
        assert rv[0] is not None and rv[2] == rv1[2]
        for fa, fb in zip(rv1[3], rv[3]):
            assert (fa.istop, fa.linecount, fa.vbi) == (fb.istop,
                                                        fb.linecount, fb.vbi)
            # a batched window may start whole samples off the sequential
            # one, and line locations count from the window start
            d = fa.linelocs - fb.linelocs[:len(fa.linelocs)]
            assert np.abs(d - np.round(np.median(d))).max() < 0.05
        d = np.abs(rv1[0].astype(np.int64) - rv[0].astype(np.int64))
        d = d.reshape(-1, W)
        if seq['system'] == 'PAL':
            d = d[:2 * (312 - TAIL_ROWS)]
        assert np.percentile(d, 99.9) <= 2 and d.max() <= 64
    assert abs(len(rv1[1]) - len(rv[1])) <= 2
    if seq['system'] == 'PAL':
        assert_audio_close(rv[1], rv1[1])
    else:
        n = min(len(rv1[1]), len(rv[1]))
        da = np.abs(rv1[1][:n].astype(np.int64) - rv[1][:n].astype(np.int64))
        assert np.percentile(da, 99.9) <= 2


def test_process_resident_batch1(seq):
    """Framer(capture=..., batch=1) decodes field by field through
    process_resident (the JAX package's resident sequential branch): the
    same frames as its batched framer's first frame."""
    tf = TFR.Framer(seq['tcfg'], seq['tbank'], capture=seq['cap'], batch=1,
                    device='cpu')
    assert tf.prefetcher is None
    rv = tf.readframe(None, SYSTEMS[seq['system']]['start'], True)
    with jax.enable_x64(False):
        jf = JFR.Framer(seq['cfg'], JF.make_demod_bank(seq['cfg'],
                                                       np.complex64),
                        capture=seq['cap'])
        jrv = jf.readframe(None, SYSTEMS[seq['system']]['start'], True)
    assert rv[2] == jrv[2]
    np.testing.assert_array_equal(rv[0][:16], np.asarray(jrv[0])[:16])
    for fa, fb in zip(jrv[3], rv[3]):
        assert (fb.istop, fb.linecount) == (fa.istop, fa.linecount)
        _assert_pic(seq['system'], _field_picture(seq, fb),
                    _field_picture(seq, fa))
    assert_audio_close(rv[1], jrv[1])


@pytest.fixture(scope='module')
def r16(tmp_path_factory):
    cfg = DecoderConfig(system='NTSC', freq_mhz=40.0)
    cap = JE.encode_frames(cfg, 5, JE.EncodeSpec(pattern='ramp',
                                                 cav_start_frame=900))
    path = tmp_path_factory.mktemp('seq') / 'cap.r16'
    (cap.astype(np.int32) - 32768).astype('<i2').tofile(path)
    return path


def test_cli_batch1_against_jax(r16, tmp_path):
    """lddecode_torch.py --batch 1 against lddecode_tpu.py --batch 1 on a
    signed .r16 capture (the loader's values reach the demod as they
    are): the .tbc frames, their line-0 words and the .pcm."""
    out_j, out_t = str(tmp_path / 'jax'), str(tmp_path / 'torch')
    with jax.enable_x64(False):
        assert lddecode_tpu.main([str(r16), out_j, '--batch', '1', '-q',
                                  '-l', '2']) == 0
    assert lddecode_torch.main([str(r16), out_t, '--batch', '1', '-q',
                                '-l', '2', '--device', 'cpu']) == 0
    tj, tt = (np.fromfile(o + '.tbc', '<u2') for o in (out_j, out_t))
    frame = 525 * 910
    assert tj.size == tt.size == 2 * frame
    for k in range(2):
        a = tj[k * frame:(k + 1) * frame].reshape(525, 910)
        b = tt[k * frame:(k + 1) * frame].reshape(525, 910)
        np.testing.assert_array_equal(a[0, :16], b[0, :16])
        assert_picture_close(b, a)
    pj, pt = (np.fromfile(o + '.pcm', '<i2') for o in (out_j, out_t))
    assert_audio_close(pt, pj)
