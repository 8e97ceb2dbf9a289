"""PyTorch port: sync peaks, hsync refinement, vsync voting and line
numbering against the JAX package.  Each stage is fed the JAX outputs of
the stage before it, so a fault points at one module."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ld_decode_tpu.models import encode as E
from ld_decode_tpu.ops import demod as JD
from ld_decode_tpu.ops import filters as JF
from ld_decode_tpu.tbc import fused as JFU
from ld_decode_tpu.tbc import sync as JS
from ld_decode_tpu.tbc import sync_dev as JSD
from ld_decode_tpu.utils.params import DecoderConfig
from ld_decode_tpu_torch.tbc import sync as TS
from ld_decode_tpu_torch.tbc import sync_dev as TSD

from torch_parity import LOC_TOL

torch.set_num_threads(2)

NBLOCKS = 52
# a raw capture offset (not locked to a field), then two field starts
STARTS = (33046, 640958, 1308291)


def T(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope='module')
def ref():
    """JAX reference outputs of every stage for three field windows."""
    cfg = DecoderConfig(system='NTSC', freq_mhz=40.0)
    cap = E.encode_frames(cfg, 2, E.EncodeSpec(pattern='ramp',
                                               cav_start_frame=900))
    n = JD.stream_len(cfg, NBLOCKS)
    out = {'cfg': cfg}
    with jax.enable_x64(False):
        bank = JF.make_demod_bank(cfg, np.complex64)
        vids = [JD.demod_stream(jnp.asarray(cap[s - cfg.blockcut:
                                                s - cfg.blockcut + n]),
                                bank, cfg, NBLOCKS, jnp.float32(1.0))[0]
                for s in STARTS]
        out['sync'] = np.stack([np.asarray(v['demod_sync']) for v in vids])
        out['d05'] = np.stack([np.asarray(v['demod_05']) for v in vids])
        win = int(cfg.linelen * 0.4)
        pk = [JS.find_sync_peaks(jnp.asarray(s), win) for s in out['sync']]
        out['idx'] = np.stack([np.asarray(p[0]) for p in pk])
        out['val'] = np.stack([np.asarray(p[1]) for p in pk])
        out['nv'] = (out['idx'] >= 0).sum(1).astype(np.int32)
        vsd = jax.vmap(lambda p, v, nv: JSD.determine_vsyncs_dev(
            p, v, nv, cfg.linelen, False))(
            jnp.asarray(out['idx']), jnp.asarray(out['val']),
            jnp.asarray(out['nv']))
        out['vsd'] = {k: np.asarray(v) for k, v in vsd._asdict().items()}
        lc = (cfg.sys.frame_lines // 2
              + out['vsd']['istop'][:, 0].astype(np.int32)).astype(np.int32)
        out['lc'] = lc
        lld = jax.vmap(lambda p, v, nv, m, t, a, b, l: JSD.compute_linelocs_dev(
            p, v, nv, m, t, a, b, l, cfg.linelen, JFU.max_nlines(cfg)))(
            jnp.asarray(out['idx']), jnp.asarray(out['val']),
            jnp.asarray(out['nv']), vsd.med, vsd.tol, vsd.line0[:, 0],
            vsd.line0[:, 1], jnp.asarray(lc))
        out['lld'] = {k: np.asarray(v) for k, v in lld._asdict().items()}
        si = out['lld']['lli'].copy()
        si[:, :9] -= 200
        out['si'] = si
        hargs = (40, cfg.iretohz(-20), cfg.iretohz(-60), cfg.iretohz(20),
                 cfg.iretohz(100), cfg.iretohz(-10), cfg.iretohz(10))
        out['hargs'] = hargs
        zc = [JS.refine_hsync_zc(jnp.asarray(d), jnp.asarray(s), *hargs)
              for d, s in zip(out['d05'], si)]
        out['zc'] = [np.stack([np.asarray(z[i]) for z in zc])
                     for i in range(5)]
    return out


def test_sliding_max_matches_jax():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((3, 5000)).astype(np.float32)
    with jax.enable_x64(False):
        ref = np.stack([np.asarray(JS.sliding_max(jnp.asarray(r), 77))
                        for r in x])
    np.testing.assert_array_equal(TS.sliding_max(T(x), 77).numpy(), ref)


def test_find_sync_peaks_matches_jax(ref):
    cfg = ref['cfg']
    idx, val = TS.find_sync_peaks(T(ref['sync']), int(cfg.linelen * 0.4))
    # peak indices are integer decisions: exact
    np.testing.assert_array_equal(idx.numpy(), ref['idx'])
    np.testing.assert_array_equal(val.numpy(), ref['val'])
    assert (ref['nv'] > 300).all()


def test_refine_hsync_zc_matches_jax(ref):
    got = TS.refine_hsync_zc(T(ref['d05']), T(ref['si']), *ref['hargs'])
    starts_i, zc, refined, bad, found = [g.numpy() for g in got]
    np.testing.assert_array_equal(starts_i, ref['zc'][0])
    np.testing.assert_array_equal(bad, ref['zc'][3])
    np.testing.assert_array_equal(found, ref['zc'][4])
    assert np.abs(zc - ref['zc'][1]).max() <= LOC_TOL
    assert np.abs(refined - ref['zc'][2]).max() <= LOC_TOL


def test_determine_vsyncs_matches_jax(ref):
    cfg = ref['cfg']
    got = TSD.determine_vsyncs_dev(T(ref['idx']), T(ref['val']),
                                   T(ref['nv']), cfg.linelen, False)
    for k in ('idx', 'line0', 'istop', 'count'):
        np.testing.assert_array_equal(getattr(got, k).numpy(),
                                      ref['vsd'][k], err_msg=k)
    np.testing.assert_allclose(got.med.numpy(), ref['vsd']['med'],
                               rtol=1e-6)
    np.testing.assert_allclose(got.tol.numpy(), ref['vsd']['tol'],
                               rtol=1e-4)
    # the locked windows find both vsyncs; the raw offset is exercised too
    assert (ref['vsd']['count'][1:] >= 2).all()


def test_compute_linelocs_matches_jax(ref):
    cfg = ref['cfg']
    v = ref['vsd']
    got = TSD.compute_linelocs_dev(
        T(ref['idx']), T(ref['val']), T(ref['nv']), T(v['med']),
        T(v['tol']), T(v['line0'][:, 0]), T(v['line0'][:, 1]),
        T(ref['lc']), cfg.linelen, ref['lld']['lli'].shape[1])
    r = ref['lld']
    np.testing.assert_array_equal(got.bad.numpy(), r['bad'])
    np.testing.assert_array_equal(got.ok.numpy(), r['ok'])
    loc = got.lli.numpy().astype(np.float64) + got.llf.numpy()
    rloc = r['lli'].astype(np.float64) + r['llf']
    assert np.abs(loc - rloc).max() <= LOC_TOL
    assert got.lli.dtype == torch.int32 and got.llf.dtype == torch.float32
