"""PyTorch port: burst refinement, Philips slicer, audio stage 2, u16
scaling and one whole `field_pipeline_batch` against the JAX package."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ld_decode_tpu.audio.stage2 import audio_stage2 as j_stage2
from ld_decode_tpu.models import encode as E
from ld_decode_tpu.ops import filters as JF
from ld_decode_tpu.tbc import burst as JB
from ld_decode_tpu.tbc import framer as JFR
from ld_decode_tpu.tbc import fused as JFU
from ld_decode_tpu.tbc import resample as JR
from ld_decode_tpu.utils.params import DecoderConfig
from ld_decode_tpu.vbi.philips import slice_philips_dev as j_philips
from ld_decode_tpu_torch.audio.stage2 import audio_stage2
from ld_decode_tpu_torch.utils.params import DecoderConfig as TConfig
from ld_decode_tpu_torch.ops import filters as TF
from ld_decode_tpu_torch.tbc import burst as TB
from ld_decode_tpu_torch.tbc import fused as TFU
from ld_decode_tpu_torch.vbi.philips import slice_philips_dev

from torch_parity import LOC_TOL, assert_audio_close, assert_picture_close

torch.set_num_threads(2)

NBLOCKS, BATCH = 52, 4
HZ_IRE = 1700000 / 140


def T(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope='module')
def ref():
    """One JAX batch from a framer-locked start, with its intermediates."""
    cfg = DecoderConfig(system='NTSC', freq_mhz=40.0)
    cap = E.encode_frames(cfg, 4, E.EncodeSpec(pattern='ramp',
                                               cav_start_frame=900))
    out = {'cfg': cfg, 'tcfg': TConfig(system='NTSC', freq_mhz=40.0),
           'cap': cap}
    pitch = int(round(cfg.freq_hz / cfg.sys.fps / 2))
    with jax.enable_x64(False):
        bank = JF.make_demod_bank(cfg, np.complex64)
        n_audio1 = NBLOCKS * bank.a_stage1_keep
        # lock onto the field grid first: a batch started at a raw capture
        # offset is invalid in the device vsync voter
        fr = JFR.Framer(cfg, bank, capture=cap, batch=BATCH, nblocks=NBLOCKS)
        f0, rs0, _ = fr.readfield(None, 33046)
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
        lli, llf, _bad = jax.vmap(lambda v, i_, f_, b_, l_: JFU._hsync_refine(
            v, i_, f_, b_, l_, cfg))(video, lld.lli, lld.llf, lld.bad, lc)
        max_lc = JFU.max_linecount(cfg)

        def burst_window(d, i_, f_):
            gaps = (i_[1:] - i_[:-1]).astype(jnp.float32) + (f_[1:] - f_[:-1])
            wow = (gaps[:max_lc] / cfg.linelen).astype(jnp.float32)
            return JR.downscale_lines_split(d, i_, f_, 910, max_lc, wow,
                                            col0=16, ncols=48)

        out['scaled'] = np.asarray(jax.vmap(burst_window)(
            video['demod_burst'], lli, llf))
        out['lli'], out['llf'] = np.asarray(lli), np.asarray(llf)
        out['lc'] = np.asarray(lc)
        out['demod'] = np.asarray(video['demod'])
        out['audio1'] = {k: np.asarray(v) for k, v in audio1.items()}
        out['n_audio1'] = n_audio1
        out['rs0'], out['pitch'] = rs0, pitch
        out['jbank'] = bank
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
# module level

def test_burst_phase_offsets_population_std():
    """jnp.std is the population std; a burst just under the weak-burst
    gate (std/hz_ire >= 3) passes it with torch's default correction=1."""
    rng = np.random.default_rng(2)
    k = np.arange(48)
    amps = np.array([2.99, 3.02, 2.5, 8.0, 2.995, 40.0]) * np.sqrt(2) * HZ_IRE
    phases = rng.uniform(0, 2 * np.pi, amps.size)
    scaled = (amps[:, None] * np.sin(2 * np.pi * k / 4 + phases[:, None])
              ).astype(np.float32)
    scaled[2] += rng.normal(0, 0.3 * HZ_IRE, 48).astype(np.float32)
    with jax.enable_x64(False):
        want = [np.asarray(x) for x in JB.burst_phase_offsets(
            jnp.asarray(scaled), HZ_IRE, win0=4)]
    got = [x.numpy() for x in TB.burst_phase_offsets(T(scaled), HZ_IRE,
                                                     win0=4)]
    np.testing.assert_array_equal(got[3], want[3])    # level_ok
    np.testing.assert_array_equal(got[4], want[4])    # counts_ok
    assert not want[3][0] and want[3][1]              # the gate is hit
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-4)


def test_masked_nanmedian_averages_the_middles():
    """numpy nanmedian semantics (two middles averaged; NaN when empty),
    which torch.nanmedian does not have."""
    x = torch.tensor([[1., 2., 3., 4., 9.], [5., 1., 7., 2., 0.],
                      [1., 1., 1., 1., 1.]])
    mask = torch.tensor([[1, 1, 1, 1, 0], [1, 1, 1, 1, 1],
                         [0, 0, 0, 0, 0]], dtype=torch.bool)
    got = TFU._masked_nanmedian(x, mask).numpy()
    want = np.nanmedian(np.where(mask.numpy(), x.numpy(), np.nan)[:2], axis=1)
    np.testing.assert_array_equal(got[:2], want)
    assert np.isnan(got[2])
    assert got[0] == 2.5 and torch.nanmedian(x[0, :4]).item() == 2.0


def _valid_phase_lines(ref, lc):
    """Per field, the count of lines with a valid phase pair."""
    max_lc = JFU.max_linecount(ref['cfg'])
    with jax.enable_x64(False):
        ph = jax.vmap(lambda s: JB.burst_phase_offsets(s, HZ_IRE, win0=4))(
            jnp.asarray(ref['scaled']))
    ok = np.asarray(ph[3]) & np.asarray(ph[4]) \
        & (np.arange(max_lc) < lc[:, None])
    return ok.sum(axis=1)


def test_burst_refine_post_hits_even_count(ref):
    """The line counts the next test uses give both parities of valid
    phase lines: an even count is where numpy's median averages."""
    counts = np.concatenate([_valid_phase_lines(ref, ref['lc'] + d)
                             for d in (0, -1)])
    assert (counts % 2 == 0).any() and (counts % 2 == 1).any(), counts


@pytest.mark.parametrize('lc_delta', [0, -1])
def test_burst_refine_post_matches_jax(ref, lc_delta):
    """Burst repair from identical scaled windows."""
    cfg = ref['cfg']
    max_lc = JFU.max_linecount(cfg)
    lc = (ref['lc'] + lc_delta).astype(np.int32)
    with jax.enable_x64(False):
        want = jax.vmap(lambda s, i_, f_, l_: JFU._burst_refine_post(
            s, i_, f_, max_lc, l_, cfg))(
            jnp.asarray(ref['scaled']), jnp.asarray(ref['lli']),
            jnp.asarray(ref['llf']), jnp.asarray(lc))
        want = [np.asarray(w) for w in want]
    got = [g.numpy() for g in TFU._burst_refine_post(
        T(ref['scaled']), T(ref['lli']), T(ref['llf']), max_lc, T(lc),
        ref['tcfg'])]
    np.testing.assert_array_equal(got[2] == 0, want[2] == 0)
    np.testing.assert_allclose(got[2], want[2], rtol=1e-4, atol=1e-2)
    loc = got[0].astype(np.float64) + got[1]
    wloc = want[0].astype(np.float64) + want[1]
    assert np.abs(loc - wloc).max() <= LOC_TOL


def test_slice_philips_matches_jax(ref):
    cfg = ref['cfg']
    wp = TFU.philips_window_len(cfg)
    wins, fracs = [], []
    for b in range(BATCH):
        for l in cfg.sys.philips_codelines:
            w0 = int(np.clip(ref['lli'][b, l], 0, ref['demod'].shape[1] - wp))
            wins.append(ref['demod'][b, w0:w0 + wp])
            fracs.append(np.float32(ref['lli'][b, l] - w0) + ref['llf'][b, l])
    wins = np.stack(wins)
    fracs = np.asarray(fracs, np.float32)
    with jax.enable_x64(False):
        want = [j_philips(jnp.asarray(w), jnp.float32(f), cfg.freq_mhz,
                          cfg.iretohz(50)) for w, f in zip(wins, fracs)]
    nib, ok = slice_philips_dev(T(wins), T(fracs), cfg.freq_mhz,
                                cfg.iretohz(50))
    np.testing.assert_array_equal(nib.numpy(),
                                  np.stack([np.asarray(w[0]) for w in want]))
    np.testing.assert_array_equal(ok.numpy(),
                                  np.array([bool(w[1]) for w in want]))
    assert ok.numpy().sum() >= BATCH      # real codes were sliced


def test_audio_stage2_matches_jax(ref):
    cfg = ref['cfg']
    a1 = ref['audio1']
    n = ref['n_audio1']
    with jax.enable_x64(False):
        want = [jax.vmap(lambda l, r: j_stage2(l, r, ref['jbank'], n))(
            jnp.asarray(a1['audio_left']), jnp.asarray(a1['audio_right']))]
        want = [np.asarray(w) for w in want[0]]
    bank = TF.make_demod_bank(ref['tcfg'], np.complex64,
                               device='cpu')
    got = audio_stage2(T(a1['audio_left']), T(a1['audio_right']), bank, n)
    for g, w in zip(got, want):
        g = g.numpy()
        assert g.shape == w.shape
        assert np.abs(g - w).max() <= 1e-4 * np.ptp(w)


def _stage2_fields(device):
    """Stage-2 audio of 16 fields (64 transform rows, over IRFFT_ROWS) in
    one call, and in two calls of 8 fields."""
    tcfg = TConfig(system='NTSC', freq_mhz=40.0)
    bank = TF.make_demod_bank(tcfg, np.complex64, device=device)
    n = NBLOCKS * bank.a_stage1_keep
    rng = np.random.default_rng(11)
    x = torch.from_numpy(rng.standard_normal((2, 16, n), dtype=np.float32)
                         * 1e5).to(device)
    whole = audio_stage2(x[0], x[1], bank, n)
    halves = [audio_stage2(x[0, h], x[1, h], bank, n)
              for h in (slice(0, 8), slice(8, 16))]
    return x, bank, n, whole, [torch.cat(c) for c in zip(*halves)]


def test_audio_stage2_rows_split(monkeypatch):
    """The irfft split into calls of IRFFT_ROWS rows reassembles exactly:
    on the CPU (whose FFT does not depend on the rows of a call) equal to
    one call over all the rows, and a field's audio the same in a call of
    16 fields as in one of 8."""
    from ld_decode_tpu_torch.audio import stage2 as S2
    x, bank, n, whole, halves = _stage2_fields('cpu')
    assert x.shape[1] * 4 > S2.IRFFT_ROWS
    monkeypatch.setattr(S2, 'IRFFT_ROWS', 1 << 30)
    one_call = audio_stage2(x[0], x[1], bank, n)
    for w, h, o in zip(whole, halves, one_call):
        assert torch.equal(w, h)
        assert torch.equal(w, o)


@pytest.mark.cuda
def test_cuda_audio_stage2_independent_of_fields():
    """On a card: a field's stage-2 audio is the same whether it is
    decoded with 15 other fields or with 7 (the sharded batch's rank)."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    _x, _bank, _n, whole, halves = _stage2_fields('cuda')
    for w, h in zip(whole, halves):
        assert torch.equal(w, h)


def test_scale_u16_matches_jax(ref):
    cfg = ref['cfg']
    rng = np.random.default_rng(4)
    max_lc = JFU.max_linecount(cfg)
    out = rng.uniform(cfg.iretohz(-45), cfg.iretohz(105),
                      (2, max_lc, 910)).astype(np.float32)
    bl = rng.normal(0, 30 * HZ_IRE, (2, max_lc + 4)).astype(np.float32)
    lc = np.array([262, 263], np.int32)
    with jax.enable_x64(False):
        want = np.stack([np.asarray(JFU._scale_u16(
            jnp.asarray(out[b]), max_lc, jnp.int32(lc[b]), jnp.asarray(bl[b]),
            cfg, 1.45)).reshape(max_lc, 910) for b in range(2)])
    got = TFU._scale_u16(T(out), T(lc), T(bl), ref['tcfg'], 1.45).numpy()
    np.testing.assert_array_equal(got[:, :, :2], want[:, :, :2])
    assert np.abs(got.astype(np.int64) - want).max() <= 1


# --------------------------------------------------------------------------
# the whole batch

def test_batch_meta_words_exact(ref, port_batch):
    """Every integer decision: valid, istop, lc, nfo, peak and vsync
    counts, window starts, white flag; and the chained start."""
    want = np.stack([b['meta_i'] for b in ref['bundle']])
    np.testing.assert_array_equal(port_batch['meta_i'], want)
    assert want[:, 0].all()
    assert port_batch['next'][0] == ref['next'][0]
    np.testing.assert_allclose(port_batch['meta_f'],
                               [b['meta_f'][0] for b in ref['bundle']],
                               rtol=0, atol=1e-9)


def test_batch_linelocs(ref, port_batch):
    for b, jb in enumerate(ref['bundle']):
        want = jb['linelocs_i'].astype(np.float64) + jb['linelocs_f']
        got = (port_batch['linelocs_i'][b].astype(np.float64)
               + port_batch['linelocs_f'][b])
        assert np.abs(got - want).max() <= LOC_TOL


def test_batch_audio(ref, port_batch):
    for b, jb in enumerate(ref['bundle']):
        assert port_batch['audio_count'][b] == jb['audio_count'][0]
        n = (int(jb['audio_count'][0]) - 1) * 2
        assert_audio_close(port_batch['audio'][b, :n], jb['audio'][:n])


def test_batch_philips_codes(ref, port_batch):
    for b, jb in enumerate(ref['bundle']):
        np.testing.assert_array_equal(port_batch['philips_ok'][b],
                                      jb['philips_ok'].astype(bool))
        ok = jb['philips_ok'].astype(bool)
        np.testing.assert_array_equal(port_batch['philips_nib'][b][ok],
                                      jb['philips_nib'][ok])


def test_batch_picture(ref, port_batch):
    assert_picture_close(port_batch['picture'], ref['pic'])
