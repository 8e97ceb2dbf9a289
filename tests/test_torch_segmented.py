"""PyTorch port, the segmented decode: a sliding device-resident window over
an .lds file too large to keep resident (tests/test_segmented.py), against
the port's whole-capture decode and against the JAX package's segmented
decode of the same file.

Budgets: CAV numbers, next samples, line-0 words and seek positions exact;
the segmented frames within p99.9 <= 2 LSB of the resident ones (rows
24+, the JAX package's own budget between its two paths) and within
tests/torch_parity.py's picture budget of the JAX package's."""

import jax
import numpy as np
import pytest
import torch

from ld_decode_tpu.io import loaders as JL
from ld_decode_tpu.models import encode as JE
from ld_decode_tpu.ops import filters as JF
from ld_decode_tpu.tbc import framer as JFR
from ld_decode_tpu.utils.params import DecoderConfig
from ld_decode_tpu_torch.io import loaders as TL
from ld_decode_tpu_torch.ops import filters as TF
from ld_decode_tpu_torch.tbc import framer as TFR
from ld_decode_tpu_torch.utils.params import DecoderConfig as TConfig

from torch_parity import assert_picture_close

torch.set_num_threads(2)

START = 33046
NFRAMES = 8


@pytest.fixture(scope='module')
def capture(tmp_path_factory):
    cfg = DecoderConfig(system='NTSC', freq_mhz=40.0)
    # big enough that the chain horizon and several swaps fit inside it
    samples = JE.encode_frames(cfg, 12, JE.EncodeSpec(pattern='ramp',
                                                      cav_start_frame=900))
    path = tmp_path_factory.mktemp('seg') / 'cap.lds'
    path.write_bytes(JL.pack_data_4_40(samples).tobytes())
    tcfg = TConfig(system='NTSC', freq_mhz=40.0)
    return cfg, tcfg, samples, path, TF.make_demod_bank(tcfg, device='cpu')


def _decode_frames(fr, fd, n, start=START):
    out, s = [], start
    for i in range(n):
        rv = fr.readframe(fd, s, i == 0)
        if rv[0] is None:
            break
        out.append((np.asarray(rv[0]), fr.vbi.get('framenr'), rv[2]))
        s = rv[2]
    return out


def _segmented(tcfg, bank, path):
    # the smallest legal segment (2x the chain horizon, ~9.5 frames at
    # batch 2) is under the 12-frame file: 8 frames cross a swap
    return TFR.Framer(tcfg, bank, TL.loader_for_path(str(path)), batch=2,
                      segment_samples=1, device='cpu')


def test_segmented_matches_resident(capture):
    cfg, tcfg, samples, path, bank = capture
    ref = _decode_frames(TFR.Framer(tcfg, bank, capture=samples, batch=2,
                                    device='cpu'), None, NFRAMES)
    fr = _segmented(tcfg, bank, path)
    with open(path, 'rb') as fd:
        got = _decode_frames(fr, fd, NFRAMES)
    assert len(got) == len(ref) >= 6
    assert fr._seg_samples > 0
    assert fr._seg_base > START              # the window slid
    for (a, fa, na), (b, fb, nb) in zip(ref, got):
        assert fa == fb is not None and na == nb
        np.testing.assert_array_equal(a[:16], b[:16])
        d = np.abs(a.reshape(-1, 910)[24:].astype(np.int64)
                   - b.reshape(-1, 910)[24:])
        assert np.percentile(d, 99.9) <= 2, d.max()

    with jax.enable_x64(False):
        jfr = JFR.Framer(cfg, JF.make_demod_bank(cfg, np.complex64),
                         loader=JL.loader_for_path(str(path)), batch=2,
                         segment_samples=1, pic_mode='raw')
        with open(path, 'rb') as fd:
            want = _decode_frames(jfr, fd, NFRAMES)
    assert len(want) == len(got)
    for (a, fa, na), (b, fb, nb) in zip(want, got):
        assert (fa, na) == (fb, nb)
        np.testing.assert_array_equal(a[:16], b[:16])
        assert_picture_close(b.reshape(-1, 910), a.reshape(-1, 910))


def test_segmented_seek(capture):
    """findframe across segment boundaries lands where the JAX package's
    does."""
    cfg, tcfg, samples, path, bank = capture
    fr = _segmented(tcfg, bank, path)
    with open(path, 'rb') as fd:
        pos = TFR.findframe(fd, fr, 908, START)
        assert pos is not None
        rv = fr.readframe(fd, pos, False)
    assert rv[0] is not None and abs(fr.vbi['framenr'] - 908) <= 1
    with jax.enable_x64(False):
        jfr = JFR.Framer(cfg, JF.make_demod_bank(cfg, np.complex64),
                         loader=JL.loader_for_path(str(path)), batch=2,
                         segment_samples=1, pic_mode='raw')
        with open(path, 'rb') as fd:
            assert JFR.findframe(fd, jfr, 908, START) == pos
