"""PyTorch port, `full_decode=False` (locate fields without decoding their
content) against the JAX package's, NTSC `ramp` and PAL `palbars`.

Both Framers are built the JAX way, with `full_decode` as the fourth
positional parameter.  At batch=1 on a loader's window
(FieldDecoder.process) a field skips the burst or pilot passes, so its line
locations stay at the hsync stage, and has no picture and no audio; on a
resident capture (process_resident) the line locations are the finish's,
as in the JAX package.  readframe returns no frame.  At batch > 1 the
fields decode in full and only the frame is left out.  Budgets
(tests/torch_parity.py): integer outputs exact (line counts, parities,
next-field offsets, peak and vsync counts, Philips codes, the next
sample), line locations <= 0.02 px."""

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

from torch_parity import LOC_TOL

torch.set_num_threads(2)

SYSTEMS = {'NTSC': dict(pattern='ramp', start=33046),
           'PAL': dict(pattern='palbars', start=2560 * 14)}


@pytest.fixture(scope='module', params=list(SYSTEMS))
def sysdata(request):
    system = request.param
    p = SYSTEMS[system]
    cfg = DecoderConfig(system=system, freq_mhz=40.0)
    cap = JE.encode_frames(cfg, 3, JE.EncodeSpec(pattern=p['pattern'],
                                                 cav_start_frame=900))
    tcfg = TConfig(system=system, freq_mhz=40.0)
    return dict(system=system, cfg=cfg, tcfg=tcfg, cap=cap,
                start=p['start'],
                tbank=TF.make_demod_bank(tcfg, np.complex64, device='cpu'))


def _assert_fields_equal(got, want, hsync_stage):
    for fa, fb in zip(want, got):
        assert (fb.valid, fb.istop, fb.linecount, fb.nextfieldoffset,
                fb.peak_count, fb.vsync_count) \
            == (fa.valid, fa.istop, fa.linecount, fa.nextfieldoffset,
                fa.peak_count, fa.vsync_count)
        assert fb.linecode == fa.linecode and fb.vbi == fa.vbi
        assert np.abs(fb.linelocs - fa.linelocs).max() <= LOC_TOL
        assert fb.dspicture is None and fa.dspicture is None
        assert fb.dsaudio is None and fa.dsaudio is None
        if hsync_stage:
            assert fb.burstlevel is None and fa.burstlevel is None


@pytest.mark.parametrize('source', ['loader', 'capture'])
def test_locate_only_against_jax(sysdata, source):
    """Framer(cfg, bank, loader, False) at batch=1 on both packages: the
    same fields located, no frame, no picture, no audio."""
    cap, start = sysdata['cap'], sysdata['start']
    with jax.enable_x64(False):
        jbank = JF.make_demod_bank(sysdata['cfg'], np.complex64)
        if source == 'loader':
            jf = JFR.Framer(sysdata['cfg'], jbank, JL.make_array_loader(cap),
                            False)
        else:
            jf = JFR.Framer(sysdata['cfg'], jbank, None, False, capture=cap)
        jrv = jf.readframe(None, start, True)
    loader = TL.make_array_loader(cap) if source == 'loader' else None
    tf = TFR.Framer(sysdata['tcfg'], sysdata['tbank'], loader, False,
                    capture=None if loader else cap, batch=1, device='cpu')
    assert tf.full_decode is False and tf.prefetcher is None
    rv = tf.readframe(None, start, True)
    assert rv[0] is None and jrv[0] is None
    assert rv[1] is None and jrv[1] is None
    assert rv[2] == jrv[2]
    assert tf.vbi == jf.vbi and tf.vbi['framenr'] is not None
    _assert_fields_equal(rv[3], jrv[3], hsync_stage=source == 'loader')


def test_locate_only_is_the_hsync_stage(sysdata):
    """On a loader's window the located fields' line locations are the
    full decode's hsync stage, exactly: the same fields, the same code
    path up to the burst or pilot passes."""
    cap, start = sysdata['cap'], sysdata['start']
    kept = []
    full = TFR.Framer(sysdata['tcfg'], sysdata['tbank'],
                      TL.make_array_loader(cap), batch=1, device='cpu')
    hsync = full.decoder.refine_linelocs_hsync

    def keep(*a, **k):
        r = hsync(*a, **k)
        kept.append(r[0].copy())
        return r

    full.decoder.refine_linelocs_hsync = keep
    frv = full.readframe(None, start, True)
    loc = TFR.Framer(sysdata['tcfg'], sysdata['tbank'],
                     TL.make_array_loader(cap), False, batch=1, device='cpu')
    rv = loc.readframe(None, start, True)
    assert frv[0] is not None and rv[0] is None and rv[2] == frv[2]
    for ff, f in zip(frv[3], rv[3]):
        hs = next(k for k in kept if k.shape == f.linelocs.shape
                  and np.array_equal(k, f.linelocs))
        assert not np.array_equal(hs, ff.linelocs)   # the full decode moved on
        assert ff.dspicture is not None and f.dspicture is None


def test_locate_only_batched(sysdata):
    """At batch > 1 the prefetcher decodes the fields in full, as the JAX
    package's does, and readframe leaves out only the frame: the fields
    and the audio equal a full decode's."""
    cap, start = sysdata['cap'], sysdata['start']
    out = []
    for full_decode in (True, False):
        fr = TFR.Framer(sysdata['tcfg'], sysdata['tbank'], None, full_decode,
                        capture=cap, batch=4, device='cpu')
        out.append(fr.readframe(None, start, True))
    (fa, aa, na, fla), (fb, ab, nb, flb) = out
    assert fa is not None and fb is None and na == nb
    np.testing.assert_array_equal(ab, aa)
    for x, y in zip(fla, flb):
        assert (x.istop, x.linecount, x.vbi) == (y.istop, y.linecount, y.vbi)
        np.testing.assert_array_equal(x.linelocs, y.linelocs)
        np.testing.assert_array_equal(x.dspicture, y.dspicture)
