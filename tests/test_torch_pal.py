"""PyTorch port, PAL decode: the pilot refinement (tbc/pal.py), the PAL
vote and line numbering, one whole PAL `field_pipeline_batch`, and the
Framer, against the JAX package on a `palbars` capture.

Budgets are those of the NTSC tests (tests/torch_parity.py): integer
decisions exact, line locations <= 0.02 px, picture rows >= 24 p99.9 <= 2
and max <= 4 LSB, audio <= 0.6 LSB rms with the neighbouring-sample ticks
counted apart.

One place needs its own line.  The tail gap sanitizer of `_hsync_refine`
(JAX and port alike) rewrites the last 10 lines of a field as a running sum
that reaches 25,600 samples, where one float32 step is 2^-9 px: an input
difference of 4e-5 px (the FFTs' rounding) can move such a line by one
step.  On `palbars` the full-amplitude subcarrier is as steep as 10^4 LSB a
pixel, so those rows differ by up to 8 LSB where the rest of the field
stays within 4.  The tail rows are held apart (tests/torch_parity.py::
assert_pal_picture): locations to 2^-9 px (well inside the 0.02 px budget),
picture to TAIL_MAX."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ld_decode_tpu.models import encode as E
from ld_decode_tpu.ops import filters as JF
from ld_decode_tpu.tbc import framer as JFR
from ld_decode_tpu.tbc import fused as JFU
from ld_decode_tpu.tbc import pal as JPAL
from ld_decode_tpu.tbc import sync as JS
from ld_decode_tpu.tbc import sync_dev as JSD
from ld_decode_tpu.utils.params import DecoderConfig
from ld_decode_tpu_torch.ops import filters as TF
from ld_decode_tpu_torch.tbc import framer as TFR
from ld_decode_tpu_torch.tbc import fused as TFU
from ld_decode_tpu_torch.tbc import pal as TPAL
from ld_decode_tpu_torch.tbc import sync_dev as TSD
from ld_decode_tpu_torch.utils.params import DecoderConfig as TConfig

from torch_parity import LOC_TOL, assert_audio_close, assert_pal_picture

torch.set_num_threads(2)

NBLOCKS, BATCH = 56, 4
START = 2560 * 14      # past the first vertical interval
FRAC_TOL = 1e-5        # pilot phase fractions, cycles, where no floor flipped


def T(x):
    return torch.from_numpy(np.array(x))


def _loc(i, f):
    return np.asarray(i).astype(np.float64) + np.asarray(f)


@pytest.fixture(scope='module')
def ref():
    """One JAX PAL batch from a framer-locked start, with the intermediates
    of every stage."""
    cfg = DecoderConfig(system='PAL', freq_mhz=40.0)
    cap = E.encode_frames(cfg, 4, E.EncodeSpec(pattern='palbars',
                                               cav_start_frame=900))
    out = {'cfg': cfg, 'tcfg': TConfig(system='PAL', freq_mhz=40.0),
           'cap': cap}
    pitch = int(round(cfg.freq_hz / cfg.sys.fps / 2))
    with jax.enable_x64(False):
        bank = JF.make_demod_bank(cfg, np.complex64)
        n_audio1 = NBLOCKS * bank.a_stage1_keep
        fr = JFR.Framer(cfg, bank, capture=cap, batch=BATCH, nblocks=NBLOCKS)
        f0, rs0, _ = fr.readfield(None, START)
        rs0 = int(f0.readsample if f0.readsample >= 0 else rs0)
        chunks, ns, no, pic, *_ = JFU.field_pipeline_batch(
            jnp.asarray(cap), jnp.int32(rs0), jnp.float32(0.0),
            jnp.float32(1.0), bank, cfg, NBLOCKS, n_audio1, BATCH, pitch,
            pallas=False, valid_len=jnp.int32(cap.shape[0]), codec=False)
        buf = np.concatenate([np.asarray(c) for c in chunks]).reshape(
            BATCH, -1)
        spec = JFU.pipeline_bundle_spec(cfg)
        out['bundle'] = [spec.unpack(buf[b]) for b in range(BATCH)]
        out['pic'] = np.asarray(pic).reshape(BATCH, JFU.max_linecount(cfg),
                                             -1)
        out['next'] = (int(ns), float(no))

        starts = JFU.pipeline_starts(jnp.int32(rs0), 0, BATCH, pitch,
                                     jnp.int32(cap.shape[0]), cfg, NBLOCKS)
        video, audio1, lld, lc, *_ = JFU.pipeline_analyze(
            jnp.asarray(cap), starts, jnp.float32(1.0), bank, cfg, NBLOCKS)
        pk = jax.vmap(lambda s: JS.find_sync_peaks(
            s, int(cfg.linelen * 0.4)))(video['demod_sync'])
        out['idx'], out['val'] = np.asarray(pk[0]), np.asarray(pk[1])
        out['nv'] = (out['idx'] >= 0).sum(1).astype(np.int32)
        vsd = jax.vmap(lambda p, v, nv: JSD.determine_vsyncs_dev(
            p, v, nv, cfg.linelen, True))(
            jnp.asarray(out['idx']), jnp.asarray(out['val']),
            jnp.asarray(out['nv']))
        out['vsd'] = {k: np.asarray(v) for k, v in vsd._asdict().items()}
        out['lld'] = {k: np.asarray(v) for k, v in lld._asdict().items()}
        lli, llf, _bad = jax.vmap(lambda v, i_, f_, b_, l_: JFU._hsync_refine(
            v, i_, f_, b_, l_, cfg))(video, lld.lli, lld.llf, lld.bad, lc)
        out['lli'], out['llf'] = np.asarray(lli), np.asarray(llf)
        out['lc'] = np.asarray(lc)
        out['demod'] = np.asarray(video['demod'])
        out['demod_05'] = np.asarray(video['demod_05'])
        out['n_audio1'] = n_audio1
        out['rs0'], out['pitch'] = rs0, pitch
    return out


@pytest.fixture(scope='module')
def port_batch(ref):
    cfg = ref['tcfg']
    bank = TF.make_demod_bank(cfg, np.complex64, device='cpu')
    res, ns, no = TFU.field_pipeline_batch(
        torch.from_numpy(ref['cap'].astype(np.float32)), ref['rs0'], 0.0,
        1.0, bank, cfg, NBLOCKS, ref['n_audio1'], BATCH, ref['pitch'])
    out = {k: v.numpy() for k, v in res.items()}
    out['next'] = (int(ns), float(no))
    return out


# --------------------------------------------------------------------------
# tbc/pal.py

def _j_offsets(demod, d05, lli, llf, cfg):
    with jax.enable_x64(False):
        fr, cr = jax.vmap(lambda d, e, i_, f_: JPAL.pilot_offsets(
            d, e, i_, f_, cfg.linelen, cfg.freq_mhz))(
            jnp.asarray(demod), jnp.asarray(d05), jnp.asarray(lli),
            jnp.asarray(llf))
        return np.asarray(fr), np.asarray(cr)


def _j_once(demod, d05, lli, llf, cfg, relative_only):
    with jax.enable_x64(False):
        i2, f2 = jax.vmap(lambda d, e, i_, f_: JPAL._refine_pilot_once(
            d, e, i_, f_, cfg.linelen, cfg.freq_mhz, relative_only))(
            jnp.asarray(demod), jnp.asarray(d05), jnp.asarray(lli),
            jnp.asarray(llf))
        return np.asarray(i2), np.asarray(f2)


def _frac_flips(got, want, mask):
    """Circular |d| of the phase fractions on the crossings, and the count
    of crossings whose floor flipped (|d| of almost a cycle)."""
    d = np.abs(got - want)[mask]
    flips = d > 0.5
    return np.minimum(d, 1 - d), int(flips.sum())


def test_pilot_offsets_decoded_field(ref):
    cfg = ref['cfg']
    wfrac, wcross = _j_offsets(ref['demod'], ref['demod_05'], ref['lli'],
                               ref['llf'], cfg)
    frac, cross = TPAL.pilot_offsets(
        T(ref['demod']), T(ref['demod_05']), T(ref['lli']), T(ref['llf']),
        cfg.linelen, cfg.freq_mhz)
    np.testing.assert_array_equal(cross.numpy(), wcross)
    # the capture carries a pilot: most lines have crossings
    assert wcross.any(axis=-1).mean() > 0.9
    d, flips = _frac_flips(frac.numpy(), wfrac, wcross)
    assert flips == 0
    assert d.max() <= FRAC_TOL


@pytest.mark.parametrize('relative_only', [False, True])
def test_refine_pilot_once_decoded_field(ref, relative_only):
    cfg = ref['cfg']
    wi, wf = _j_once(ref['demod'], ref['demod_05'], ref['lli'], ref['llf'],
                     cfg, relative_only)
    gi, gf = TPAL._refine_pilot_once(
        T(ref['demod']), T(ref['demod_05']), T(ref['lli']), T(ref['llf']),
        cfg.linelen, cfg.freq_mhz, relative_only)
    assert gi.dtype == torch.int32 and gf.dtype == torch.float32
    assert np.abs(_loc(gi, gf) - _loc(wi, wf)).max() <= LOC_TOL
    # the pass moved the lines
    assert np.abs(_loc(wi, wf) - _loc(ref['lli'], ref['llf'])).max() > 0.05


def _pilot_field(rng, phase, amp=200000.0, L=24, zero_lines=()):
    """A synthetic field: a 3.75 MHz pilot of `phase` cycles on a flat
    demod, lines 2560 apart with jitter.  zero_lines carry no pilot (an
    empty row)."""
    n = 2560 * (L + 2)
    t = np.arange(n)
    demod = amp * np.sin(2 * np.pi * (t * 3.75 / 40.0 + phase))
    ll = 3000.0 + 2560.0 * np.arange(L) + rng.uniform(-0.4, 0.4, L)
    for l in zero_lines:
        s = int(ll[l])
        demod[s - 400:s + 10] = 0.0
    lli = np.floor(ll).astype(np.int32)
    return (demod.astype(np.float32), np.zeros(n, np.float32), lli,
            (ll - lli).astype(np.float32))


def test_refine_pilot_seeded_edge_cases():
    """Seeded fields that hit: an even and an odd count of crossings in a
    row (the even one averages the two middles), rows with no crossing
    (NaN median -> no move), a field with no crossing at all (global median
    NaN -> tgt 0, nothing moves) and pilot phases whose fractions straddle
    the 0/1 wrap (where one flipped floor would move a line's plain median
    by almost a cycle)."""
    cfg = DecoderConfig(system='PAL', freq_mhz=40.0)
    rng = np.random.default_rng(31)
    fields = [_pilot_field(rng, ph, zero_lines=z)
              for ph, z in ((0.13, (5, 6)), (0.40, ()), (0.4415, (9,)),
                            (0.77, ()))]
    fields.append(_pilot_field(rng, 0.3, amp=0.0))         # no pilot at all
    demod, d05, lli, llf = (np.stack(x) for x in zip(*fields))

    wfrac, wcross = _j_offsets(demod, d05, lli, llf, cfg)
    frac, cross = TPAL.pilot_offsets(T(demod), T(d05), T(lli), T(llf),
                                     cfg.linelen, cfg.freq_mhz)
    np.testing.assert_array_equal(cross.numpy(), wcross)
    counts = wcross[:, 2:].sum(-1)
    assert (counts == 0).any() and (counts % 2 == 0).any() \
        and (counts % 2 == 1).any(), np.unique(counts)
    assert not wcross[4].any()                              # the empty field
    d, flips = _frac_flips(frac.numpy(), wfrac, wcross)
    assert flips == 0 and d.max() <= FRAC_TOL
    # the wrap is straddled, between the lines of field 1 and within the
    # lines of field 2 (fractions at both ends of one row)
    lo = np.where(wcross, wfrac, 2.0).min(axis=-1)
    hi = np.where(wcross, wfrac, -1.0).max(axis=-1)
    assert lo[1].min() < 0.1 and hi[1].max() > 0.9
    assert ((lo[2] < 0.01) & (hi[2] > 0.99)).any()

    for relative_only in (False, True):
        wi, wf = _j_once(demod, d05, lli, llf, cfg, relative_only)
        gi, gf = TPAL._refine_pilot_once(T(demod), T(d05), T(lli), T(llf),
                                         cfg.linelen, cfg.freq_mhz,
                                         relative_only)
        assert np.abs(_loc(gi, gf) - _loc(wi, wf)).max() <= LOC_TOL
        # rows with no crossing, and the empty field, do not move
        moved = np.abs(_loc(gi, gf) - _loc(lli, llf))
        assert moved[4].max() == 0
        assert moved[0, 5:7].max() == 0 and moved[2, 9] == 0


def test_refine_pilot_passes(ref):
    """`passes` stays a knob: 2 passes = the verbatim pass, then one
    relative-only pass."""
    cfg = ref['cfg']
    args = [T(ref[k][:2]) for k in ('demod', 'demod_05', 'lli', 'llf')]
    with jax.enable_x64(False):
        want = jax.vmap(lambda d, e, i_, f_: JPAL.refine_pilot(
            d, e, i_, f_, cfg.linelen, cfg.freq_mhz, passes=2))(
            *[jnp.asarray(a.numpy()) for a in args])
    got = TPAL.refine_pilot(*args, cfg.linelen, cfg.freq_mhz, passes=2)
    assert np.abs(_loc(*got) - _loc(*want)).max() <= LOC_TOL
    one = TPAL.refine_pilot(*args, cfg.linelen, cfg.freq_mhz)
    assert np.abs(_loc(*got) - _loc(*one)).max() > 0


# --------------------------------------------------------------------------
# the PAL vote and line numbering

def test_pal_vsync_vote_exact(ref):
    cfg = ref['cfg']
    got = TSD.determine_vsyncs_dev(T(ref['idx']), T(ref['val']),
                                   T(ref['nv']), cfg.linelen, True)
    for k in ('idx', 'line0', 'istop', 'count'):
        np.testing.assert_array_equal(getattr(got, k).numpy(),
                                      ref['vsd'][k], err_msg=k)
    assert (ref['vsd']['count'] >= 2).all()
    # both field polarities are in the batch
    assert len(set(ref['vsd']['istop'][:, 0].tolist())) == 2
    # the NTSC vote decides otherwise on the same peaks
    ntsc = TSD.determine_vsyncs_dev(T(ref['idx']), T(ref['val']),
                                    T(ref['nv']), cfg.linelen, False)
    assert not np.array_equal(ntsc.line0.numpy(), ref['vsd']['line0']) \
        or not np.array_equal(ntsc.istop.numpy(), ref['vsd']['istop'])


def test_pal_linelocs_dev_exact(ref):
    cfg = ref['cfg']
    v = ref['vsd']
    got = TSD.compute_linelocs_dev(
        T(ref['idx']), T(ref['val']), T(ref['nv']), T(v['med']),
        T(v['tol']), T(v['line0'][:, 0]), T(v['line0'][:, 1]),
        T(ref['lc']), cfg.linelen, TFU.max_nlines(ref['tcfg']))
    r = ref['lld']
    assert r['lli'].shape[1] == 317
    np.testing.assert_array_equal(got.bad.numpy(), r['bad'])
    np.testing.assert_array_equal(got.ok.numpy(), r['ok'])
    np.testing.assert_array_equal(got.lli.numpy(), r['lli'])
    assert np.abs(got.llf.numpy() - r['llf']).max() <= LOC_TOL


# --------------------------------------------------------------------------
# the whole batch

def test_pal_batch_meta_words_exact(ref, port_batch):
    want = np.stack([b['meta_i'] for b in ref['bundle']])
    np.testing.assert_array_equal(port_batch['meta_i'], want)
    assert want[:, 0].all()
    assert set(want[:, 2].tolist()) == {312, 313}          # lc
    assert port_batch['next'][0] == ref['next'][0]
    np.testing.assert_allclose(port_batch['meta_f'],
                               [b['meta_f'][0] for b in ref['bundle']],
                               rtol=0, atol=1e-9)


def test_pal_batch_linelocs(ref, port_batch):
    for b, jb in enumerate(ref['bundle']):
        want = _loc(jb['linelocs_i'], jb['linelocs_f'])
        got = _loc(port_batch['linelocs_i'][b], port_batch['linelocs_f'][b])
        assert np.abs(got - want).max() <= LOC_TOL
        lc = int(jb['meta_i'][2])
        # the head and tail sanitizers' lines step by 2^-9 px
        assert np.abs(got - want)[10:lc - 6].max() <= 5e-4
        assert np.abs(got - want).max() <= 2.0 ** -9 + 2e-4
    assert not port_batch['burstlevel'].any()      # PAL: burst levels zero


def test_pal_batch_audio(ref, port_batch):
    for b, jb in enumerate(ref['bundle']):
        assert port_batch['audio_count'][b] == jb['audio_count'][0]
        n = (int(jb['audio_count'][0]) - 1) * 2
        assert_audio_close(port_batch['audio'][b, :n], jb['audio'][:n])


def test_pal_batch_philips_codes(ref, port_batch):
    nok = 0
    for b, jb in enumerate(ref['bundle']):
        ok = jb['philips_ok'].astype(bool)
        np.testing.assert_array_equal(port_batch['philips_ok'][b], ok)
        np.testing.assert_array_equal(port_batch['philips_nib'][b][ok],
                                      jb['philips_nib'][ok])
        nok += int(ok.sum())
    assert nok >= BATCH                    # lines 19-21 carried real codes


def test_pal_batch_picture(ref, port_batch):
    assert port_batch['picture'].shape == (BATCH, 313, 1135)
    assert_pal_picture(port_batch['picture'], ref['pic'])
    # columns 0/1 carry picture, not burst flag/level words (JAX passes no
    # burst level into the PAL scale): they equal JAX's and are no flags
    d01 = np.abs(port_batch['picture'][:, 24:300, :2].astype(np.int64)
                 - ref['pic'][:, 24:300, :2])
    assert d01.max() <= 4
    assert not np.isin(port_batch['picture'][:, 1:300, 0],
                       (16384, 32768)).all()


# --------------------------------------------------------------------------
# the Framer

def _frames(framer, n=3):
    out, s = [], START
    for i in range(n):
        rv = framer.readframe(None, s, i == 0)
        if rv[0] is None:
            break
        out.append(rv)
        s = rv[2]
    return out


@pytest.fixture(scope='module')
def pair(ref):
    cap = ref['cap']
    with jax.enable_x64(False):
        jf = JFR.Framer(ref['cfg'], JF.make_demod_bank(ref['cfg'],
                                                       np.complex64),
                        capture=cap, batch=6, pic_mode='raw')
        jframes = _frames(jf)
    bank = TF.make_demod_bank(ref['tcfg'], np.complex64, device='cpu')
    tf = TFR.Framer(ref['tcfg'], bank, capture=cap, batch=6, device='cpu')
    tframes = _frames(tf)
    td = TFR.Framer(ref['tcfg'], bank, capture=cap, batch=6, device='cpu',
                    fetch_picture=False)
    return jf, tf, jframes, tframes, _frames(td)


def test_pal_framer_frames_and_positions(pair):
    jf, tf, jframes, tframes, _ = pair
    assert len(tframes) == len(jframes) >= 2
    assert tf.clvfps == 25
    for a, b in zip(jframes, tframes):
        assert a[2] == b[2]                      # next sample: exact
        assert a[0].shape == b[0].shape == (625 * 1135,)
        assert b[0].dtype == np.uint16
        assert [f.linecount for f in a[3]] == [f.linecount for f in b[3]]
    assert tf.prefetcher.stats['seq_fallback'] >= 1
    assert tf.prefetcher.stats['hits'] >= 3
    assert tf.prefetcher.field_pitch == 800000


def test_pal_framer_picture_vbi_audio(pair):
    jf, tf, jframes, tframes, _ = pair
    assert tf.vbi['framenr'] == jf.vbi['framenr'] is not None
    for a, b in zip(jframes, tframes):
        assert [f.vbi['framenr'] for f in a[3]] \
            == [f.vbi['framenr'] for f in b[3]]
        np.testing.assert_array_equal(a[0][:16], b[0][:16])
        assert_pal_picture(b[0].reshape(625, 1135), a[0].reshape(625, 1135),
                           per_row=2)
        assert_audio_close(b[1], a[1])


def test_pal_device_weave_equals_host_weave(pair):
    """Framer(fetch_picture=False) weaves 313/312-line fields of 1135
    columns on the device: equal to the host weave, line-0 words and the
    trailing half line included."""
    _, _, _, host, dev = pair
    assert sum(isinstance(f[0], torch.Tensor) for f in dev) >= 2
    for h, d in zip(host, dev):
        d = d[0].numpy() if isinstance(d[0], torch.Tensor) else d[0]
        assert d.shape == h[0].shape == (625 * 1135,)
        np.testing.assert_array_equal(d.astype(np.uint16), h[0])


def test_pal_field_window_check():
    """A PAL field needs a 56-block window; the NTSC value 52 is refused."""
    from ld_decode_tpu_torch.tbc.field import FieldDecoder
    cfg = TConfig(system='PAL', freq_mhz=40.0)
    bank = TF.make_demod_bank(cfg, np.complex64, device='cpu')
    with pytest.raises(ValueError, match='nblocks >= 56'):
        FieldDecoder(cfg, bank, nblocks=52, device='cpu')
    FieldDecoder(cfg, bank, nblocks=56, device='cpu')


def test_pilot_line_median_at_the_wrap(monkeypatch):
    """The pilot pass moves a line by the plain median of its pilot
    fractions (the reference's pass; the JAX package's and the port's
    alike).  Where a line's fractions straddle the 0/1 wrap, one fraction
    crossing it moves the median to the next order statistic: here 0.09
    of a cycle, 0.24 px (ROADMAP.md Queue 3, F3: the pilot median).  The
    0.25 px chip_smoke.py phase 15 sees card vs CPU on a PAL field's last
    line comes through the line's anchor instead
    (test_wrap_flip_lines_on_an_anchor_a_sample_apart)."""
    L, W = 4, 7
    moved = []
    for first in (0.001, 0.9995):
        frac = torch.full((1, L, W), 0.5)
        # 7 crossings: the pass drops the first and the last of a line
        frac[0, 3, 1:6] = torch.tensor([first, 0.02, 0.9, 0.99, 0.999])
        cross = torch.ones((1, L, W), dtype=torch.bool)
        monkeypatch.setattr(TPAL, 'pilot_offsets',
                            lambda *_a, f=frac, c=cross: (f, c))
        lli = torch.arange(L, dtype=torch.int32)[None] * 2560 + 5000
        li, lf = TPAL._refine_pilot_once(None, None, lli, torch.zeros(1, L),
                                         2560, 40.0, relative_only=False)
        moved.append(_loc(li, lf)[0] - _loc(lli, torch.zeros(1, L))[0])
    assert np.abs(moved[0][:3]).max() == 0 == np.abs(moved[1][:3]).max()
    # medians 0.9 and 0.99 against the target 0.5, a quarter of 40/3.75 px
    # a cycle
    assert moved[0][3] == pytest.approx((0.5 - 0.9) * 40 / 3.75 / 4, abs=1e-5)
    assert moved[0][3] - moved[1][3] == pytest.approx(0.24, abs=1e-5)


@pytest.mark.parametrize('shift', [0, 1])
def test_wrap_flip_lines_on_the_monkeypatched_wrap(monkeypatch, shift):
    """The wrap case above through `wrap_flip_lines`: the one line whose
    used fraction crossed the wrap is named, and the 0.24 px it moved is
    what the changed order statistic predicts.  shift=1 puts that
    crossing one sample later in the second decode (a sample next to zero
    rounding to the other sign): the phases still match as a set."""
    L, W = 4, 20
    at = np.array([0, 3, 6, 9, 12, 15, 18])
    fracs, locs = [], []
    for k, first in enumerate((0.001, 0.9995)):
        frac = torch.full((1, L, W), 0.5)
        cross = torch.zeros((1, L, W), dtype=torch.bool)
        idx = at.copy()
        idx[1] += shift * k
        cross[0, :, idx] = True
        # 7 crossings: the pass drops the first and the last of a line
        frac[0, 3, idx[1:6]] = torch.tensor([first, 0.02, 0.9, 0.99, 0.999])
        monkeypatch.setattr(TPAL, 'pilot_offsets',
                            lambda *_a, f=frac, c=cross: (f, c))
        lli = torch.arange(L, dtype=torch.int32)[None] * 2560 + 5000
        li, lf = TPAL._refine_pilot_once(None, None, lli, torch.zeros(1, L),
                                         2560, 40.0, relative_only=False)
        fracs.append((frac[0].numpy(), cross[0].numpy()))
        locs.append(_loc(li, lf)[0])
    ii, ff = lli[0].numpy(), np.zeros(L, np.float32)
    lines, pred, anchored = TPAL.wrap_flip_lines(
        *fracs[0], *fracs[1], (ii, ii), (ff, ff), 40.0)
    found = locs[1] - locs[0]
    assert lines.tolist() == [3] and not anchored.any()
    assert pred[0] == pytest.approx(-0.24, abs=1e-5)
    assert found[3] == pytest.approx(pred[0], abs=1e-4)
    assert np.abs(found[:3]).max() == 0


def test_wrap_flip_lines_on_seeded_straddling_fields():
    """The seeded fields of test_refine_pilot_seeded_edge_cases whose
    fractions straddle the wrap, decoded again with the pilot's phase
    nudged back by 1 and by 3 thousandths of a cycle: the lines a nudged
    fraction carried across the wrap (in the field whose rows straddle it)
    are the flips `wrap_flip_lines` names, each moved by the difference it
    predicts to 1e-4 px (some past 0.02 px); every other line moves by at
    most 0.02 px (the nudge alone is up to 0.008 px).  Against JAX's
    fractions the port's flip nowhere (test_refine_pilot_seeded_edge_cases),
    so there it names no line."""
    cfg = DecoderConfig(system='PAL', freq_mhz=40.0)
    flips, big = 0, 0.0
    for phase, nudge in ((0.40, -1e-3), (0.40, -3e-3), (0.4415, -1e-3),
                         (0.4415, -3e-3)):
        got = []
        for nudge in (0.0, nudge):
            rng = np.random.default_rng(31)
            demod, d05, lli, llf = _pilot_field(rng, phase + nudge)
            args = [T(x)[None] for x in (demod, d05, lli, llf)]
            frac, cross = TPAL.pilot_offsets(*args, cfg.linelen,
                                             cfg.freq_mhz)
            li, lf = TPAL._refine_pilot_once(*args, cfg.linelen,
                                             cfg.freq_mhz, False)
            got.append((frac[0].numpy(), cross[0].numpy(),
                        _loc(li, lf)[0]))
        (fa, ca, la), (fb, cb, lb) = got
        lines, pred, anchored = TPAL.wrap_flip_lines(
            fa, ca, fb, cb, (lli, lli), (llf, llf), cfg.freq_mhz)
        assert not anchored.any()
        d = lb - la
        flips += lines.size
        np.testing.assert_allclose(d[lines], pred, rtol=0, atol=1e-4)
        rest = np.setdiff1d(np.arange(d.size), lines)
        assert np.abs(d[rest]).max() <= 0.02
        big = max(big, float(np.abs(d[lines]).max(initial=0.0)))

        wfrac, wcross = _j_offsets(*(x[None] for x in _pilot_field(
            np.random.default_rng(31), phase)), cfg)
        none, _, _ = TPAL.wrap_flip_lines(wfrac[0], wcross[0], fa, ca,
                                          (lli, lli), (llf, llf),
                                          cfg.freq_mhz)
        assert none.size == 0
    # a flip moves its line by an order statistic's step: here past the
    # 0.02 px budget
    assert flips >= 8 and big > 0.02


def _anchor_decodes(cfg, locs, l=10):
    """The seeded field of phase 0.77 decoded once for each location of
    line l in `locs` (px from the integer nearest the line's own): each
    decode's (pilot_offsets, anchors, fractions, locations after the
    pass)."""
    demod, d05, lli, llf = _pilot_field(np.random.default_rng(31), 0.77)
    edge = float(np.round(lli[l] + llf[l]))       # the nearest integer
    got = []
    for loc in locs:
        ii, ff = lli.copy(), llf.copy()
        ii[l] = np.floor(edge + loc)
        ff[l] = np.float32(edge + loc - ii[l])
        args = [T(x)[None] for x in (demod, d05, ii, ff)]
        frac, cross = TPAL.pilot_offsets(*args, cfg.linelen, cfg.freq_mhz)
        li, lf = TPAL._refine_pilot_once(*args, cfg.linelen, cfg.freq_mhz,
                                         False)
        got.append((frac[0].numpy(), cross[0].numpy(), ii, ff,
                    _loc(li, lf)[0]))
    return got


def test_wrap_flip_lines_on_an_anchor_a_sample_apart():
    """A line whose location sits 5e-5 px either side of an integer in two
    decodes (what chip_smoke.py phase 15 found card vs CPU on line 312 of
    a PAL field): the pass reads its pilot from windows a sample apart,
    every phase moves by 3.75/40 of a cycle and the line by a quarter of
    a pixel.  `wrap_flip_lines` names it as an anchor flip and predicts
    the difference to 1e-4 px; the other lines stay within 0.02 px."""
    cfg = DecoderConfig(system='PAL', freq_mhz=40.0)
    l = 10
    (fa, ca, ia, fla, la), (fb, cb, ib, flb, lb) = _anchor_decodes(
        cfg, (-5e-5, 5e-5), l)
    lines, pred, anchored = TPAL.wrap_flip_lines(
        fa, ca, fb, cb, (ia, ib), (fla, flb), cfg.freq_mhz)
    d = lb - la
    assert lines.tolist() == [l] and anchored.tolist() == [True]
    assert abs(d[l]) > 0.2
    assert d[l] == pytest.approx(pred[0], abs=1e-4)
    assert np.abs(np.delete(d, l)).max() <= 0.02


def test_wrap_flip_lines_names_no_line_that_entered_apart():
    """Anchors a sample apart make a flip only where the two locations
    the pass started from straddle an integer within 0.02 px and the
    phases moved by a sample: the same line entering 1 px apart (an hsync
    stage a pixel off), or 0.03 px apart, is no flip, nor is one whose
    phases did not move with its anchor."""
    cfg = DecoderConfig(system='PAL', freq_mhz=40.0)
    l = 10
    for locs in ((-0.3, 0.7), (-0.015, 0.015)):
        (fa, ca, ia, fla, _), (fb, cb, ib, flb, _) = _anchor_decodes(
            cfg, locs, l)
        assert ib[l] - ia[l] == 1
        lines, _, _ = TPAL.wrap_flip_lines(fa, ca, fb, cb, (ia, ib),
                                           (fla, flb), cfg.freq_mhz)
        assert lines.size == 0
    (fa, ca, ia, fla, _), (_, _, ib, flb, _) = _anchor_decodes(
        cfg, (-5e-5, 5e-5), l)
    assert TPAL.wrap_flip_lines(fa, ca, fa, ca, (ia, ib), (fla, flb),
                                cfg.freq_mhz)[0].size == 0


def test_batch_wrap_flips_holds_the_hsync_stage(ref, monkeypatch):
    """chip_smoke.py phase 11's accounting (`_batch_wrap_flips`), driven on
    the CPU with two CPU decodes of the batch standing for the card's and
    the CPU's: the hsync stage it runs again agrees, and no line is named
    a flip.  Where one decode's hsync stage puts every line a pixel off,
    the phase fails on the stage itself, before any line can pass as a
    flip."""
    import chip_smoke as CS
    cfg = ref['tcfg']
    cap = torch.from_numpy(ref['cap'].astype(np.float32))
    bank = TF.make_demod_bank(cfg, np.complex64, device='cpu')
    runs = {'cuda': (cap, bank), 'cpu': (cap, bank)}
    args = (torch, np, cfg, runs, ref['rs0'], NBLOCKS, 2, ref['pitch'])
    got = CS._batch_wrap_flips(*args)
    assert len(got) == 2
    for lines, pred, anchored, _detail in got:
        assert lines.size == 0 and pred.size == 0 and anchored.size == 0

    refine, calls = TFU._hsync_refine, []

    def off_by_a_pixel(*a, **kw):
        lli, llf, bad = refine(*a, **kw)
        calls.append(1)
        return (lli + 1 if len(calls) == 1 else lli), llf, bad

    monkeypatch.setattr(TFU, '_hsync_refine', off_by_a_pixel)
    with pytest.raises(SystemExit):
        CS._batch_wrap_flips(*args)
