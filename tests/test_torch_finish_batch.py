"""PyTorch port: the sequential path's batched programs and the last
resample/demod helpers against the JAX package -- `instantaneous_freq`,
`sample_cubic`, `downscale_lines`, `field_analyze_batch`,
`field_finish_core` and `field_finish_batch` (both values of `pallas` in
the port; JAX's `pallas=False`).

JAX returns packed u16 bundles from the analyze and finish programs; the
tests unpack them with `PEAKS_SPEC` and `finish_bundle_spec` and compare
field by field.  Inputs: seeded numpy data, and framer-locked 4-field
batches of `models/encode.py` captures (NTSC `ramp`, PAL `palbars`); the
JAX side runs inside jax.enable_x64(False) with a complex64 bank, and both
finishes get the same host line tables (the port's device line numbering of
the windows, whose integers equal JAX's).

Budgets (PERF.md section 2, tests/torch_parity.py): peak indices, line
counts, audio tick counts and VBI codes exact; peak values within 1e-4
relative; line locations <= 0.02 px; picture rows >= 24 p99.9 <= 2 and max
<= 4 LSB (PAL's 11 tail-sanitized rows 16); audio <= 0.6 LSB rms."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ld_decode_tpu.models import encode as E
from ld_decode_tpu.ops import demod as JD
from ld_decode_tpu.ops import filters as JF
from ld_decode_tpu.tbc import fused as JFU
from ld_decode_tpu.tbc import resample as JR
from ld_decode_tpu.utils.params import DecoderConfig
from ld_decode_tpu_torch.ops import demod as TD
from ld_decode_tpu_torch.ops import filters as TF
from ld_decode_tpu_torch.tbc import framer as TFR
from ld_decode_tpu_torch.tbc import fused as TFU
from ld_decode_tpu_torch.tbc import resample as TR
from ld_decode_tpu_torch.utils.params import DecoderConfig as TConfig
from ld_decode_tpu_torch.vbi.philips import decode_philips_line

from torch_parity import (LOC_TOL, assert_audio_close, assert_pal_picture,
                          assert_picture_close)

torch.set_num_threads(2)

BATCH = 4
SYSTEMS = {'NTSC': dict(pattern='ramp', start=33046, nblocks=52),
           'PAL': dict(pattern='palbars', start=2560 * 14, nblocks=56)}
OFFSETS = np.array([0.0, 1.25e-5, 7.5e-6, 2.0e-5], np.float32)


def T(x):
    return torch.from_numpy(np.array(x))


# ---------------------------------------------------------------------------
# helpers


def test_instantaneous_freq():
    rng = np.random.default_rng(3)
    n = 4096
    f = 8.1e6 + 0.5e6 * np.sin(np.arange(n) / 97.0)
    ph = np.cumsum(2 * np.pi * f / 40e6) + rng.uniform(0, 2 * np.pi)
    amp = 1.0 + 0.2 * rng.normal(size=n)
    a = (amp * np.exp(1j * ph)).astype(np.complex64)
    with jax.enable_x64(False):
        want = np.asarray(JD.instantaneous_freq(jnp.asarray(a), 40e6))
    got = TD.instantaneous_freq(T(a), 40e6).numpy()
    assert got.dtype == np.float32 and got.shape == (n,) and got[0] == 0
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)


def test_sample_cubic_edges():
    """Positions inside, on and past the ends: clamped to [1, n-3] before
    the floor."""
    rng = np.random.default_rng(4)
    data = rng.normal(size=1000).astype(np.float32)
    pos = np.concatenate([rng.uniform(-20, 1020, 500),
                          [-5.0, 0.0, 0.5, 1.0, 1.5, 996.0, 996.5, 997.0,
                           998.9, 1000.0, 1e6]]).astype(np.float32)
    with jax.enable_x64(False):
        want = np.asarray(JR.sample_cubic(jnp.asarray(data),
                                          jnp.asarray(pos.reshape(-1, 1))))
    got = TR.sample_cubic(T(data), T(pos.reshape(-1, 1))).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-5


@pytest.mark.parametrize('wow', [False, True])
def test_downscale_lines(wow):
    """263 lines onto 910 columns, the first line starting before the data
    and the last ending past it, with and without the wow scale."""
    rng = np.random.default_rng(5)
    n = 700_000
    data = rng.normal(size=n).astype(np.float32)
    nl = 263
    li = (np.cumsum(rng.uniform(2540, 2552, nl + 1)) + 1000.3)
    li[0], li[-1] = -5.0, n + 10.0
    li = li.astype(np.float32)
    ws = rng.uniform(0.99, 1.01, nl).astype(np.float32) if wow else None
    with jax.enable_x64(False):
        want = np.asarray(JR.downscale_lines(
            jnp.asarray(data), jnp.asarray(li), 910, nl,
            None if ws is None else jnp.asarray(ws)))
    got = TR.downscale_lines(T(data), T(li), 910, nl,
                             None if ws is None else T(ws)).numpy()
    assert got.shape == (nl, 910)
    assert np.abs(got - want).max() <= 1e-5


# ---------------------------------------------------------------------------
# the batched programs


@pytest.fixture(scope='module', params=list(SYSTEMS))
def ref(request):
    """JAX's analyze and finish programs on a framer-locked 4-field batch."""
    system = request.param
    p = SYSTEMS[system]
    cfg = DecoderConfig(system=system, freq_mhz=40.0)
    cap = E.encode_frames(cfg, 4, E.EncodeSpec(pattern=p['pattern'],
                                               cav_start_frame=900))
    nblk = p['nblocks']
    pitch = int(round(cfg.freq_hz / cfg.sys.fps / 2))
    out = dict(system=system, cfg=cfg, cap=cap, nblk=nblk,
               tcfg=TConfig(system=system, freq_mhz=40.0))
    # the field grid and the host line tables (the device line numbering
    # of the windows) come from the port, whose integers equal JAX's
    # (tests/test_torch_framer.py, test_torch_fused.py); both packages'
    # finishes get the same tables
    tcfg = out['tcfg']
    tbank = TF.make_demod_bank(tcfg, np.complex64, device='cpu')
    capt = torch.from_numpy(cap.astype(np.float32))
    fr = TFR.Framer(tcfg, tbank, capture=cap, batch=1, nblocks=nblk,
                    device='cpu')
    f0, rs0, _ = fr.readfield(None, p['start'])
    rs0 = int(f0.readsample if f0.readsample >= 0 else rs0)
    starts = TFU.pipeline_starts(rs0, 0, BATCH, pitch, cap.shape[0], tcfg,
                                 nblk)
    _v, _a, lld, lc, valid, *_ = TFU.pipeline_analyze(
        capt, starts, 1.0, tbank, tcfg, nblk)
    assert valid.all()
    out.update(starts=starts.numpy(), lc=lc.numpy(), tbank=tbank, capt=capt,
               lld={k: getattr(lld, k).numpy() for k in ('lli', 'llf',
                                                         'bad')})
    with jax.enable_x64(False):
        bank = JF.make_demod_bank(cfg, np.complex64)
        n_audio1 = nblk * bank.a_stage1_keep
        video, audio1, packed = JFU.field_analyze_batch(
            jnp.asarray(cap), jnp.asarray(out['starts']), bank, cfg, nblk,
            jnp.float32(1.0))
        pk = np.asarray(packed).reshape(BATCH, -1)
        out['peaks'] = [JFU.PEAKS_SPEC.unpack(pk[b]) for b in range(BATCH)]
        tab = [jnp.asarray(out['lld'][k]) for k in ('lli', 'llf', 'bad')]
        lcj, offs = jnp.asarray(out['lc']), jnp.asarray(OFFSETS)
        spec = JFU.finish_bundle_spec(cfg)
        fin = np.asarray(JFU.field_finish_batch(
            video, audio1, *tab, lcj, offs, bank, cfg, n_audio1,
            pallas=False)).reshape(BATCH, -1)
        out['finish'] = [spec.unpack(fin[b]) for b in range(BATCH)]
        core = jax.jit(JFU.field_finish_core, static_argnums=(8, 9))(
            {k: v[1] for k, v in video.items()},
            {k: v[1] for k, v in audio1.items()}, *(t[1] for t in tab),
            lcj[1], offs[1], bank, cfg, n_audio1)
        out['core'] = spec.unpack(np.asarray(core))
        out['n_audio1'] = n_audio1
    return out


@pytest.fixture(scope='module')
def port(ref):
    cfg, bank, capt = ref['tcfg'], ref['tbank'], ref['capt']
    video, audio1, idx, val = TFU.field_analyze_batch(
        capt, T(ref['starts']), bank, cfg, ref['nblk'], 1.0)
    tables = [T(ref['lld'][k]) for k in ('lli', 'llf', 'bad')]
    lc, offs = T(ref['lc']), T(OFFSETS)
    fin = {}
    for pallas in (False, True):
        res = TFU.field_finish_batch(video, audio1, *tables, lc, offs, bank,
                                     cfg, ref['n_audio1'], pallas=pallas)
        fin[pallas] = {k: v.numpy() for k, v in res.items()}
    core = TFU.field_finish_core(
        {k: v[1] for k, v in video.items()},
        {k: v[1] for k, v in audio1.items()},
        *(t[1] for t in tables), lc[1], offs[1], bank, cfg, ref['n_audio1'])
    return dict(idx=idx.numpy(), val=val.numpy(), finish=fin,
                core={k: v.numpy() for k, v in core.items()})


def test_field_analyze_batch(ref, port):
    """Peak indices exact and values within 1e-4 relative, field by field
    against JAX's bundle unpacked with PEAKS_SPEC."""
    assert port['idx'].shape == (BATCH, ref['peaks'][0]['idx'].shape[0])
    for b, jp in enumerate(ref['peaks']):
        np.testing.assert_array_equal(port['idx'][b], jp['idx'])
        ok = jp['idx'] >= 0
        assert ok.sum() > 300
        np.testing.assert_allclose(port['val'][b][ok], jp['val'][ok],
                                   rtol=1e-4, atol=0)


def _check_field(ref, got, want, b=None):
    """One field of the port's finish (dict, batch axis removed) against
    JAX's unpacked bundle."""
    cfg = ref['cfg']
    W, max_lc = cfg.sys.outlinelen, JFU.max_linecount(cfg)
    lc = int(ref['lc'][b])
    loc = lambda d: (d['linelocs_i'].astype(np.float64)
                     + d['linelocs_f'].astype(np.float64))
    assert np.abs(loc(got) - loc(want)).max() <= LOC_TOL
    # integers: the audio tick count and the VBI codes the host slicer
    # reads from the Philips windows
    assert int(got['audio_count']) == int(want['audio_count'][0])
    n = (int(want['audio_count'][0]) - 1) * 2
    assert_audio_close(got['audio'][:n], want['audio'][:n])
    np.testing.assert_allclose(got['audio_next_offset'],
                               want['audio_next_offset'][0], rtol=0,
                               atol=1e-9)
    for i, l in enumerate(cfg.sys.philips_codelines):
        assert decode_philips_line(got['philips'][i],
                                   float(got['philips_frac'][i]), cfg) == \
            decode_philips_line(want['philips'][i],
                                float(want['philips_frac'][i]), cfg)
    np.testing.assert_allclose(got['philips'], want['philips'], rtol=0,
                               atol=1e-3 * np.abs(want['philips']).max())
    pic = want['picture'].reshape(max_lc, W)
    assert got['picture'].shape == (max_lc, W)
    if cfg.system == 'PAL':
        assert_pal_picture(got['picture'][:lc], pic[:lc], rows=lc)
        assert not got['burstlevel'].any()
    else:
        assert_picture_close(got['picture'], pic)
        bl, wl = got['burstlevel'], want['burstlevel']
        np.testing.assert_array_equal(np.sign(bl), np.sign(wl))
        assert np.abs(bl - wl).max() <= 1e-4 * np.abs(wl).max()


@pytest.mark.parametrize('pallas', [False, True])
def test_field_finish_batch(ref, port, pallas):
    """The batched finish (both values of `pallas` give the port's one
    path) against JAX's field_finish_batch(pallas=False), field by
    field."""
    fin = port['finish'][pallas]
    assert fin['picture'].shape[0] == BATCH
    for b, want in enumerate(ref['finish']):
        _check_field(ref, {k: v[b] for k, v in fin.items()}, want, b)
    if pallas:
        for k, v in port['finish'][False].items():
            np.testing.assert_array_equal(fin[k], v)


def test_field_finish_core(ref, port):
    """One unbatched field against JAX's field_finish_core, and equal to
    the same field of the port's batch."""
    _check_field(ref, port['core'], ref['core'], 1)
    for k, v in port['finish'][False].items():
        np.testing.assert_array_equal(port['core'][k], v[1])


@pytest.mark.cuda
def test_card_field_finish_batch(ref, port):
    """On the card: field_finish_batch launches K1 once for the batch's
    picture (and twice for NTSC's burst windows) and stays within the
    budgets of the CPU's run on the same inputs."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device: K1 has no CPU mode')
    from ld_decode_tpu_torch.tbc import cuda_resample as CR
    cfg = ref['tcfg']
    bank = TF.make_demod_bank(cfg, np.complex64, device='cuda')
    capt = ref['capt'].cuda()
    video, audio1, _, _ = TFU.field_analyze_batch(
        capt, T(ref['starts']).cuda(), bank, cfg, ref['nblk'], 1.0)
    tables = [T(ref['lld'][k]).cuda() for k in ('lli', 'llf', 'bad')]
    CR.resample_lines_batch.launches = 0
    res = TFU.field_finish_batch(video, audio1, *tables, T(ref['lc']).cuda(),
                                 T(OFFSETS).cuda(), bank, cfg,
                                 ref['n_audio1'])
    got = {k: v.cpu().numpy() for k, v in res.items()}
    assert CR.resample_lines_batch.launches == \
        (3 if cfg.system == 'NTSC' else 1)
    for b, want in enumerate(ref['finish']):
        _check_field(ref, {k: v[b] for k, v in got.items()}, want, b)
