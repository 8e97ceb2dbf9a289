"""PyTorch port: its copies of the JAX package's numpy host modules (the
port imports nothing of the JAX package) behave exactly as the originals."""

import dataclasses
import io
import types

import numpy as np
import pytest

from ld_decode_tpu.io import loaders as JL
from ld_decode_tpu.models import encode as JE
from ld_decode_tpu.tbc.despackle import despackle as j_despackle
from ld_decode_tpu.utils import params as JP
from ld_decode_tpu.vbi import metadata as JM
from ld_decode_tpu.vbi import philips as JPH
from ld_decode_tpu_torch.io import loaders as TL
from ld_decode_tpu_torch.models import encode as TE
from ld_decode_tpu_torch.tbc.despackle import despackle as t_despackle
from ld_decode_tpu_torch.utils import params as TP
from ld_decode_tpu_torch.vbi import metadata as TM
from ld_decode_tpu_torch.vbi import philips as TPH


@pytest.mark.parametrize('system', ['NTSC', 'PAL', 'VHS'])
def test_params_equal(system):
    assert dataclasses.asdict(TP.sys_params(system)) \
        == dataclasses.asdict(JP.sys_params(system))
    assert dataclasses.asdict(TP.rf_params(system)) \
        == dataclasses.asdict(JP.rf_params(system))
    tc, jc = TP.DecoderConfig(system=system), JP.DecoderConfig(system=system)
    for name in ('linelen', 'linelen_float', 'block_keep', 'freq_hz_half'):
        assert getattr(tc, name) == getattr(jc, name), name
    assert tc.iretohz(-40) == jc.iretohz(-40)


@pytest.mark.parametrize('system,pattern', [('NTSC', 'ramp'),
                                            ('PAL', 'palbars')])
def test_encode_frames_equal(system, pattern):
    spec = dict(pattern=pattern, cav_start_frame=900, noise_rms=0.01)
    a = TE.encode_frames(TP.DecoderConfig(system=system), 1,
                         TE.EncodeSpec(**spec), seed=3)
    b = JE.encode_frames(JP.DecoderConfig(system=system), 1,
                         JE.EncodeSpec(**spec), seed=3)
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize('ext', ['.lds', '.r30', '.r16', '.u8'])
def test_loaders_equal(ext):
    rng = np.random.default_rng(8)
    s = rng.integers(0, 1024, 40001)
    raw = {'.lds': lambda: TL.pack_data_4_40(s).tobytes(),
           '.r30': lambda: TL.pack_data_3_32(s).tobytes(),
           '.r16': lambda: (s - 512).astype('<i2').tobytes(),
           '.u8': lambda: (s >> 2).astype(np.uint8).tobytes()}[ext]()
    tl, jl = TL.loader_for_path('x' + ext), JL.loader_for_path('x' + ext)
    assert TL.bytes_per_sample_for_path('x' + ext) \
        == JL.bytes_per_sample_for_path('x' + ext)
    f = io.BytesIO(raw)
    for start, n in ((0, 1000), (3, 4097), (39000, 900), (39900, 5000)):
        a, b = tl(f, start, n), jl(f, start, n)
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a, b)
    assert TL.file_samples(tl, f) == JL.file_samples(jl, f)


def test_philips_host_equal():
    rng = np.random.default_rng(9)
    data = np.cumsum(rng.standard_normal(4000))
    for start in (0, 10.5, 1000.25, 3990):
        for target in (0.0, 5.0, -3.0):
            assert TPH.calczc_host(data, start, target, 500) \
                == JPH.calczc_host(data, start, target, 500)
    codes = [
        {16: [15, 8, 0, 9, 0, 1], 17: None, 18: [15, 8, 0, 9, 0, 1]},
        {16: [15, 3, 13, 0, 2, 7], 17: [8, 13, 12, 1, 2, 3], 18: None},
        {16: [8, 11, 14, 4, 5, 6], 17: [8, 7, 15, 15, 15, 15], 18: None},
        {16: None, 17: None, 18: None},
    ]
    for c in codes:
        assert TPH.interpret_philips(c) == JPH.interpret_philips(c)


def _field(rng, istop, framenr, white):
    pic = rng.integers(1024, 0xc800, 263 * 910).astype(np.uint16)
    if white:
        pic[10 * 910 + 2:10 * 910 + 400] = 0xc000
    lc = {16: [15, 8, 0, 9, 0, framenr % 10] if framenr else None,
          17: [8, 13, 12, 1, 2, 3], 18: None}
    return types.SimpleNamespace(
        linecode=lc, vbi=JPH.interpret_philips(lc), dspicture=pic,
        linecount=263 if istop else 262, white_flag=None)


def test_metadata_words_equal():
    rng = np.random.default_rng(10)
    cfg_t, cfg_j = TP.DecoderConfig(), JP.DecoderConfig()
    for white in (False, True):
        fields = [_field(rng, True, 901, white), _field(rng, False, 0, False)]
        vbi = dict(fields[0].vbi)
        np.testing.assert_array_equal(
            TM.frame_metadata_words(fields, vbi, cfg_t),
            JM.frame_metadata_words(fields, vbi, cfg_j))


def test_despackle_equal():
    rng = np.random.default_rng(11)
    frame = rng.integers(0x2000, 0xb000, 525 * 910).astype(np.uint16)
    frame[rng.integers(0, frame.size, 300)] = 0      # rot hits
    scale = (0xc800 - 0x0400) / 140
    np.testing.assert_array_equal(
        t_despackle(frame.copy(), 910, scale, 1024, -40.0),
        j_despackle(frame.copy(), 910, scale, 1024, -40.0))
