"""PyTorch port: lddecode_torch.py against lddecode_tpu.py --pic-mode raw on
a small synthetic .r16 capture (frame limit and frame-accurate seek), and
`-p` on a PAL `palbars` .lds capture."""

import jax
import numpy as np
import pytest
import torch

import lddecode_torch
import lddecode_tpu
from ld_decode_tpu.models import encode as JE
from ld_decode_tpu.utils.params import DecoderConfig

from torch_parity import (assert_audio_close, assert_pal_picture,
                          assert_picture_close)

torch.set_num_threads(2)

FRAME = 525 * 910


@pytest.fixture(scope='module')
def r16(tmp_path_factory):
    cfg = DecoderConfig(system='NTSC', freq_mhz=40.0)
    cap = JE.encode_frames(cfg, 5, JE.EncodeSpec(pattern='ramp',
                                                 cav_start_frame=900))
    path = tmp_path_factory.mktemp('cli') / 'cap.r16'
    (cap.astype(np.int32) - 32768).astype('<i2').tofile(path)
    return path


def _run_both(r16, tmp_path, flags):
    out_j, out_t = str(tmp_path / 'jax'), str(tmp_path / 'torch')
    with jax.enable_x64(False):
        assert lddecode_tpu.main([str(r16), out_j, '--pic-mode', 'raw',
                                  '--batch', '6', '-q'] + flags) == 0
    assert lddecode_torch.main([str(r16), out_t, '--batch', '6', '-q',
                                '--device', 'cpu'] + flags) == 0
    res = []
    for o in (out_j, out_t):
        tbc = np.fromfile(o + '.tbc', '<u2')
        pcm = np.fromfile(o + '.pcm', '<i2')
        res.append((tbc, pcm))
    return res


def _assert_close(res, nframes):
    (tj, pj), (tt, pt) = res
    assert tj.size == tt.size == nframes * FRAME
    for f in range(nframes):
        a = tj[f * FRAME:(f + 1) * FRAME].reshape(525, 910)
        b = tt[f * FRAME:(f + 1) * FRAME].reshape(525, 910)
        np.testing.assert_array_equal(a[0, :16], b[0, :16])
        assert_picture_close(b, a)
    assert_audio_close(pt, pj)


def test_cli_length(r16, tmp_path):
    _assert_close(_run_both(r16, tmp_path, ['-l', '2']), 2)


def test_cli_seek(r16, tmp_path):
    res = _run_both(r16, tmp_path, ['-S', '902', '-l', '1'])
    _assert_close(res, 1)
    # frame number word 15 of the line-0 metadata: the seek target
    assert res[1][0][15] == 902


def test_cli_unported_modes_raise(r16, tmp_path):
    """--batch 1 decodes (the sequential path, held to lddecode_tpu.py in
    tests/test_torch_field_seq.py); -p with -n is refused."""
    assert lddecode_torch.main([str(r16), str(tmp_path / 'o'), '--batch',
                                '1', '-l', '1', '--device', 'cpu',
                                '-q']) == 0
    assert np.fromfile(str(tmp_path / 'o') + '.tbc', '<u2').size == FRAME
    assert lddecode_torch.main([str(r16), str(tmp_path / 'o'), '-p', '-n',
                                '--device', 'cpu', '-q']) == 1


def test_cli_pal_against_jax(tmp_path):
    """`-p` on a 4-frame `palbars` .lds: the .tbc has the size and the
    line-0 words of lddecode_tpu.py's, the picture is within the budget of
    tests/test_torch_pal.py (the rows that read a tail-sanitized line held
    apart), the .pcm within the audio budget."""
    from ld_decode_tpu.io import loaders as JL
    cfg = DecoderConfig(system='PAL', freq_mhz=40.0)
    cap = JE.encode_frames(cfg, 4, JE.EncodeSpec(pattern='palbars',
                                                 cav_start_frame=900))
    lds = tmp_path / 'cap.lds'
    lds.write_bytes(JL.pack_data_4_40(cap).tobytes())
    (tj, pj), (tt, pt) = _run_both(lds, tmp_path, ['-p', '-l', '2'])
    n = 625 * 1135
    assert tj.size == tt.size == 2 * n
    for f in range(2):
        a = tj[f * n:(f + 1) * n].reshape(625, 1135)
        b = tt[f * n:(f + 1) * n].reshape(625, 1135)
        np.testing.assert_array_equal(a[0, :16], b[0, :16])
        assert_pal_picture(b, a, per_row=2)
    assert tt[15] >= 900 and tt[n + 15] == tt[15] + 1   # CAV frame numbers
    assert_audio_close(pt, pj)


def test_cli_defaults_to_the_card(r16, tmp_path):
    """No silent CPU fallback: without a CUDA device the CLI fails, naming
    the flag that asks for the CPU."""
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present: the default would run')
    with pytest.raises(RuntimeError, match='--device cpu'):
        lddecode_torch.main([str(r16), str(tmp_path / 'o'), '-q'])
    assert not (tmp_path / 'o.tbc').exists()
