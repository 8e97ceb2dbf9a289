"""PyTorch port: the codec routes end to end.  The prefetcher's picture
modes (Framer(pic_mode=), lddecode_torch.py --pic-mode) and the batched
combs' RGB codec (codec=True), on the CPU.

Budgets: pic_mode='codec' writes the same .tbc bytes as 'raw' (the codec
is lossless), with no raw fallback (pic_raw_fallback 0) and every field
decoded on the native route (on the numpy route when it is asked for);
'auto' resolves to raw on the CPU; an EMA forced far below the used words
takes the top-up path and still decodes equal.  lddecode_torch.py
--pic-mode codec against lddecode_tpu.py --pic-mode codec: the picture and
audio budgets of tests/torch_parity.py.  The combs with codec=True equal
codec=False bit for bit, RGB48 and out8, rgb_decode_fallback 0."""

import jax
import numpy as np
import pytest
import torch

import lddecode_torch
import lddecode_tpu
from ld_decode_tpu.models import encode as JE
from ld_decode_tpu.utils.params import DecoderConfig as JConfig
from ld_decode_tpu_torch.comb import batch as CB
from ld_decode_tpu_torch.comb.comb_ntsc import CombConfig
from ld_decode_tpu_torch.comb.comb_pal import CombPALConfig
from ld_decode_tpu_torch.ops import filters as TF
from ld_decode_tpu_torch.tbc import framer as TFR
from ld_decode_tpu_torch.tbc import native_codec as NC
from ld_decode_tpu_torch.tbc import pipeline as TP
from ld_decode_tpu_torch.utils.params import DecoderConfig

from torch_parity import assert_audio_close, assert_picture_close

torch.set_num_threads(2)

FRAME = 525 * 910


@pytest.fixture(scope='module')
def cap():
    return JE.encode_frames(JConfig(), 4, JE.EncodeSpec(
        pattern='ramp', cav_start_frame=900))


def _decode(cap, mode, topup=False, n=2):
    cfg = DecoderConfig(system='NTSC', freq_mhz=40.0)
    fr = TFR.Framer(cfg, TF.make_demod_bank(cfg, np.complex64,
                                            device='cpu'),
                    capture=cap, batch=6, device='cpu', pic_mode=mode)
    if topup:
        # underestimate the used words ~1000x at every dispatch
        pf = fr.prefetcher._prefixes
        start = pf.start

        finish = pf.finish
        pf.finished = 0

        def forced(*args):
            pf._ema = (20.0, 8.0)
            return start(*args)

        def counted(*args):
            pf.finished += 1
            return finish(*args)
        pf.start, pf.finish = forced, counted
    frames, s = [], 33046
    for i in range(n):
        rv = fr.readframe(None, s, i == 0)
        assert rv[0] is not None
        frames.append(rv[0])
        s = rv[2]
    return frames, dict(fr.prefetcher.stats,
                        finished=getattr(fr.prefetcher._prefixes,
                                         'finished', None))


@pytest.fixture(scope='module')
def raw(cap):
    return _decode(cap, 'raw')


def test_codec_equals_raw(cap, raw):
    frames, st = _decode(cap, 'codec')
    for a, b in zip(raw[0], frames):
        np.testing.assert_array_equal(a, b)
    assert st['pic_mode'] == 'codec' and raw[1]['pic_mode'] == 'raw'
    assert st['pic_raw_fallback'] == 0
    assert st['pic_decode_native'] >= 4 and st['pic_decode_numpy'] == 0
    assert 0 < st['shipped_u16'] < st['raw_u16']
    assert raw[1]['pic_decode_native'] == raw[1]['shipped_u16'] == 0


def test_codec_numpy_route_and_topup(cap, raw):
    NC.set_native(False)
    try:
        frames, st = _decode(cap, 'codec', topup=True)
    finally:
        NC.set_native(True)
    for a, b in zip(raw[0], frames):
        np.testing.assert_array_equal(a, b)
    assert st['pic_decode_numpy'] >= 4 and st['pic_decode_native'] == 0
    # every batch that reached the host topped its plane prefix up
    assert st['pic_topups'] >= st['finished'] >= 2
    assert st['pic_raw_fallback'] == 0


def test_auto_picks_raw_on_the_cpu(cap, raw):
    assert TP.probed_link_rate('cpu') == float('inf')
    frames, st = _decode(cap, 'auto', n=1)
    assert st['pic_mode'] == 'raw'
    np.testing.assert_array_equal(frames[0], raw[0][0])
    with pytest.raises(ValueError, match='pic_mode'):
        TP.FieldPrefetcher(None, None, pic_mode='fast')


def test_cli_pic_mode_codec_against_jax(cap, tmp_path):
    r16 = tmp_path / 'cap.r16'
    (cap.astype(np.int32) - 32768).astype('<i2').tofile(r16)
    out_j, out_t = str(tmp_path / 'jax'), str(tmp_path / 'torch')
    flags = ['--pic-mode', 'codec', '--batch', '6', '-q', '-l', '2']
    with jax.enable_x64(False):
        assert lddecode_tpu.main([str(r16), out_j] + flags) == 0
    assert lddecode_torch.main([str(r16), out_t, '--device', 'cpu']
                               + flags) == 0
    assert lddecode_torch.main([str(r16), out_t + '_raw', '--device', 'cpu',
                                '--pic-mode', 'raw', '--batch', '6', '-q',
                                '-l', '2']) == 0
    tj, tt = (np.fromfile(o + '.tbc', '<u2') for o in (out_j, out_t))
    assert open(out_t + '.tbc', 'rb').read() \
        == open(out_t + '_raw.tbc', 'rb').read()
    assert tj.size == tt.size == 2 * FRAME
    for f in range(2):
        a = tj[f * FRAME:(f + 1) * FRAME].reshape(525, 910)
        b = tt[f * FRAME:(f + 1) * FRAME].reshape(525, 910)
        np.testing.assert_array_equal(a[0, :16], b[0, :16])
        assert_picture_close(b, a)
    assert_audio_close(np.fromfile(out_t + '.pcm', '<i2'),
                       np.fromfile(out_j + '.pcm', '<i2'))
    assert lddecode_torch.parse_args(['a', 'b']).pic_mode == 'auto'


def _comb_frames(rows, cols, n=3, seed=1):
    rng = np.random.default_rng(seed)
    base = rng.integers(12000, 40000, (rows, cols))
    frames = np.stack([base + 300 * k for k in range(n)])
    return frames.astype(np.uint16)


def _run_comb(make, frames, flush):
    comb = make()
    rgb, words = comb.collect(comb.feed(frames))
    if flush:
        rgb.append(comb.flush())
    return rgb, words, comb.stats


@pytest.mark.parametrize('out8', [False, True])
@pytest.mark.parametrize('system', ['NTSC', 'PAL'])
def test_comb_codec_equals_raw(system, out8):
    if system == 'NTSC':
        frames = _comb_frames(525, 910)
        make = lambda codec: CB.NTSCCombBatch(
            CombConfig(dim=2), out8=out8, device='cpu', codec=codec)
    else:
        frames = _comb_frames(625, 1135)
        make = lambda codec: CB.PALCombBatch(
            CombPALConfig(dim=3), out8=out8, device='cpu', codec=codec)
    rgb0, words0, st0 = _run_comb(lambda: make(False), frames,
                                  system == 'PAL')
    rgb1, words1, st1 = _run_comb(lambda: make(True), frames,
                                  system == 'PAL')
    assert len(rgb0) == len(rgb1) == 3
    for a, b in zip(rgb0, rgb1):
        assert a.dtype == b.dtype == (np.uint8 if out8 else np.uint16)
        np.testing.assert_array_equal(a, b)
    for a, b in zip(words0, words1):
        np.testing.assert_array_equal(a, b)
    assert st1['rgb_decode_fallback'] == 0
    assert st1['rgb_decode_native'] == st1['frames_out'] == 3
    assert 'rgb_decode_fallback' not in st0
