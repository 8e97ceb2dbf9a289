"""PyTorch port: the multi-device decode (ld_decode_tpu_torch/parallel/
mesh.py) and the data-parallel NN trainer, in gloo worlds of 2 and 4
ranks on the CPU (tests/torch_mesh_worker.py, one process a rank),
against the JAX package's shard_map versions on the tier-1 conftest's
virtual CPU devices and against the port's own single-rank paths.

Budgets:
  * sharded demod: the demod tap within DEMOD_TOL of its peak-to-peak of
    JAX's on the same (dp, sp) layout, the wrapped last block included
    (tests/test_torch_filters_demod.py's float32 budget); sync peak
    indices exact;
  * sharded batch pipeline (NTSC `bars`, nblocks 52, batch 8; PAL
    `palbars`, nblocks 56, batch 4; both from a framer-locked start, so
    every field is valid): equal to the port's single-rank
    field_pipeline_batch bit for bit, except the audio, which may move
    by 1 LSB on <= 16 ticks (tests/test_parallel.py:140-144, JAX's own
    allowance between its sharded and single-device batches);
    next_start0 / next_offset0 exact; against JAX's sharded batch the
    port's field-pipeline budgets (tests/torch_parity.py, as
    tests/test_torch_fused.py and tests/test_torch_pal.py hold the
    single-device batch);
  * sharded 3D comb (16 frames of 525 x 910 with strongly varying burst
    levels, tests/test_parallel.py:62): equal to the port's sequential
    comb_frame chain, within 1 LSB of JAX's sharded comb;
  * the NN trainer with mesh= against mesh=None over 3 steps at features
    (8, 8): loss within rtol 1e-4, parameters within 1e-5 (JAX's own
    tolerances, tests/test_parallel.py:197-202), once no gradient
    component of the first step lies within 10x the two runs' gradient
    difference of zero (Adam's first step moves a parameter by
    lr * sign(g)).
  * graphs: in the 2-rank world each sharded function (and the
    data-parallel trainer) also runs through the emulated graph
    protocol, collectives included, 3 calls with changing inputs (a
    warm-up, a capture, a replay; the batch calls' start0,
    audio_offset0, mtf_level and valid_len all change); the first two
    calls' outputs differ from the replay's, which equals the eager call
    bit for bit.
The JAX pipeline and comb run on a 4-device mesh; the port's 2-rank
world is held to them through its equality with the single-rank path."""

import json
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from ld_decode_tpu.comb import comb_ntsc as JCN
from ld_decode_tpu.models import encode as JE
from ld_decode_tpu.ops import filters as JF
from ld_decode_tpu.parallel import mesh as JM
from ld_decode_tpu.tbc import fused as JFU
from ld_decode_tpu.utils.params import DecoderConfig as JConfig
from ld_decode_tpu_torch.comb import comb_ntsc as CN
from ld_decode_tpu_torch.ops import filters as TF
from ld_decode_tpu_torch.tbc import framer as TFR
from ld_decode_tpu_torch.tbc import fused as TFU
from ld_decode_tpu_torch.utils.params import DecoderConfig as TConfig

import torch_mesh_worker as W
from torch_parity import (LOC_TOL, assert_audio_close, assert_pal_picture,
                          assert_picture_close)

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLDS = (2, 4)
WORLD_TIMEOUT_S = 300
DEMOD_TOL = 1e-3          # tests/test_torch_filters_demod.py F32_TOL
DEMOD_NBLOCKS, DEMOD_NFIELDS = 16, 2
DEMOD_DP = {2: 1, 4: 2}   # dp 1 x sp 2 and dp 2 x sp 2
PIPELINE = {
    'NTSC': dict(pattern='bars', nframes=6, nblocks=52, batch=8,
                 lock=33046),
    'PAL': dict(pattern='palbars', nframes=4, nblocks=56, batch=4,
                lock=2560 * 14),
}
OFFSET0 = 0.001
COMB_FRAMES = 16
AUDIO_LSB, AUDIO_TICKS = 1, 16
NN_LOSS_RTOL, NN_PARAM_ATOL = 1e-4, 1e-5


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


def _launch(world: int, workdir: str):
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS='1')
    procs = []
    for r in range(world):
        log = open(os.path.join(workdir, f'rank{r}.log'), 'w')
        procs.append((subprocess.Popen(
            [sys.executable, os.path.join(ROOT, 'tests',
                                          'torch_mesh_worker.py'),
             str(r), str(world), str(port), workdir],
            stdout=log, stderr=subprocess.STDOUT, env=env), log))
    return procs


def _wait(procs, workdir: str) -> str:
    """Wait for every rank; returns what the ranks that failed or hung
    printed (a hung rank is killed: none waits in a collective
    forever)."""
    try:
        for p, _log in procs:
            p.wait(timeout=WORLD_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        pass
    failed = []
    for r, (p, log) in enumerate(procs):
        if p.poll() is None:
            p.kill()
            p.wait()
        log.close()
        if p.returncode != 0:
            with open(os.path.join(workdir, f'rank{r}.log')) as f:
                failed.append(f'rank {r} rc {p.returncode}:\n'
                              f'{f.read()[-3000:]}')
    return '\n'.join(failed)


def _inputs(workdir: str):
    """The captures, locked starts, demod streams and comb frames every
    rank reads; the same arrays feed JAX."""
    arrays, spec = {}, {'pipeline': {}, 'demod_nblocks': DEMOD_NBLOCKS,
                        'demod_dp': {str(k): v for k, v in DEMOD_DP.items()}}
    for system, p in PIPELINE.items():
        cfg = TConfig(system=system, freq_mhz=40.0)
        cap = JE.encode_frames(JConfig(system=system, freq_mhz=40.0),
                               p['nframes'], JE.EncodeSpec(
                                   pattern=p['pattern'],
                                   cav_start_frame=900))
        # lock onto the field grid: a batch started at a raw capture
        # offset is invalid in the device vsync voter
        fr = TFR.Framer(cfg, TF.make_demod_bank(cfg, device='cpu'),
                        capture=cap, batch=1, nblocks=p['nblocks'],
                        device='cpu')
        f0, rs0, _ = fr.readfield(None, p['lock'])
        arrays[f'cap_{system}'] = cap
        spec['pipeline'][system] = dict(
            nblocks=p['nblocks'], batch=p['batch'], offset0=OFFSET0,
            start=int(f0.readsample if f0.readsample >= 0 else rs0),
            pitch=int(round(cfg.freq_hz / cfg.sys.fps / 2)))

    cfg = W.small_cfg()
    total = DEMOD_NBLOCKS * cfg.block_keep + cfg.blocklen - cfg.block_keep
    ntsc = arrays['cap_NTSC']
    arrays['demod_streams'] = np.stack([
        ntsc[33046 + f * 100000:33046 + f * 100000 + total]
        for f in range(DEMOD_NFIELDS)]).astype(np.float32)

    # smooth-ish frames with a moving feature and burst levels that vary
    # strongly from frame to frame (tests/test_parallel.py:62-78)
    rng = np.random.default_rng(4)
    base = rng.integers(12000, 40000, (CN.IN_Y, CN.IN_X)).astype(np.uint16)
    frames = np.stack([base] * COMB_FRAMES).astype(np.int32)
    for k in range(COMB_FRAMES):
        frames[k, 100:200, 100 + 8 * k:200 + 8 * k] += 4000
    frames = frames.astype(np.uint16)
    frames[:, :, 1] = np.uint16((6 + 10 * (np.arange(COMB_FRAMES)[:, None]
                                           % 4)) * 358.4)
    arrays['comb_frames'] = frames
    np.savez(os.path.join(workdir, 'inputs.npz'), **arrays)
    with open(os.path.join(workdir, 'spec.json'), 'w') as f:
        json.dump(spec, f)
    return arrays, spec


def _jax_refs(arrays, spec):
    refs = {'demod': {}}
    with jax.enable_x64(False):
        cfg = JConfig(system='NTSC', freq_mhz=40.0, blocklen=2048,
                      blockcut=128, blockcut_end=32)
        bank = JF.make_demod_bank(cfg, np.complex64)
        body = arrays['demod_streams'][:, :DEMOD_NBLOCKS * cfg.block_keep]
        for world, dp in DEMOD_DP.items():
            mesh = JM.make_mesh(world, dp=dp)
            step = JM.build_sharded_demod(cfg, bank, mesh, DEMOD_NBLOCKS,
                                          DEMOD_NFIELDS)
            got = step(jax.device_put(jnp.asarray(body), NamedSharding(
                mesh, P('dp', 'sp'))), jnp.float32(1.0))
            refs['demod'][world] = [np.asarray(g) for g in got]

        for system, p in spec['pipeline'].items():
            cfg = JConfig(system=system, freq_mhz=40.0)
            bank = JF.make_demod_bank(cfg, np.complex64)
            n_audio1 = p['nblocks'] * bank.a_stage1_keep \
                if bank.has_audio else 0
            step, _ = JM.build_pipeline_batch_sharded(
                cfg, bank, JM.make_mesh(4), p['nblocks'], n_audio1,
                p['batch'], p['pitch'])
            cap = arrays[f'cap_{system}']
            bundle, ns, no, pic, *_ = step(
                jnp.asarray(cap), jnp.int32(p['start']),
                jnp.float32(OFFSET0), jnp.float32(1.0),
                jnp.int32(cap.shape[0]))
            spec_b = JFU.pipeline_bundle_spec(cfg)
            bundle = np.asarray(bundle)
            refs[system] = dict(
                bundle=[spec_b.unpack(bundle[b]) for b in range(p['batch'])],
                pic=np.asarray(pic).reshape(p['batch'],
                                            JFU.max_linecount(cfg), -1),
                next=(int(ns), float(no)))

        step, fmesh = JM.build_sharded_comb3d(
            JCN.CombConfig(dim=3, opticalflow=False), JM.make_mesh(4),
            COMB_FRAMES)
        refs['comb'] = np.asarray(step(jax.device_put(
            jnp.asarray(arrays['comb_frames']), NamedSharding(fmesh,
                                                              P('f')))))
    return refs


def _port_refs(arrays, spec):
    """The port's single-rank paths on the same inputs."""
    refs = {}
    for system, p in spec['pipeline'].items():
        cfg = TConfig(system=system, freq_mhz=40.0)
        bank = TF.make_demod_bank(cfg, np.complex64, device='cpu')
        n_audio1 = p['nblocks'] * bank.a_stage1_keep \
            if bank.has_audio else 0
        out, ns, no = TFU.field_pipeline_batch(
            torch.from_numpy(arrays[f'cap_{system}'].astype(np.float32)),
            p['start'], p['offset0'], 1.0, bank, cfg, p['nblocks'],
            n_audio1, p['batch'], p['pitch'])
        refs[system] = {k: v.numpy() for k, v in out.items()}
        refs[system]['next'] = (int(ns), float(no))

    frames = torch.from_numpy(arrays['comb_frames'].astype(np.int32))
    cfg = CN.CombConfig(dim=3, opticalflow=False)
    ab, rgb = -1.0, []
    for k in range(COMB_FRAMES):
        out, ab, _ = CN.comb_frame(frames[k], frames[(k + 1) % COMB_FRAMES],
                                   frames[k - 1], ab, cfg)
        rgb.append(out.numpy())
    refs['comb'] = np.stack(rgb)
    refs['grads'] = {k: g.numpy() for k, g in W.first_step_grads().items()}
    state, refs['nn_loss'] = W.train()
    refs['nn'] = {k: v.numpy() for k, v in state.items()}
    return refs


def _collect(world: int, workdir: str):
    """The ranks' shards reassembled: the demod tiles into whole bodies,
    the batch rows and comb frames in rank order."""
    ranks = [dict(np.load(os.path.join(workdir, f'rank{r}.npz')))
             for r in range(world)]
    dp, sp = DEMOD_DP[world], world // DEMOD_DP[world]
    rows = [np.concatenate([ranks[i * sp + j]['demod'] for j in range(sp)],
                           axis=1) for i in range(dp)]
    got = {'ranks': ranks, 'demod': np.concatenate(rows),
           'pidx': [[ranks[i * sp + j]['pidx'] for j in range(sp)]
                    for i in range(dp)],
           'comb': np.concatenate([r['comb_rgb'] for r in ranks])}
    for system in PIPELINE:
        keys = [k[len(system) + 1:] for k in ranks[0]
                if k.startswith(system + '_') and k != system + '_next']
        got[system] = {k: np.concatenate([r[f'{system}_{k}'] for r in ranks])
                       for k in keys}
        got[system]['next'] = [tuple(r[f'{system}_next']) for r in ranks]
    return got


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    """Both gloo worlds run while the parent computes the JAX and the
    single-rank references."""
    root = tmp_path_factory.mktemp('mesh')
    arrays, spec = _inputs(str(root))
    procs = {}
    for world in WORLDS:
        d = root / f'w{world}'
        d.mkdir()
        for name in ('inputs.npz', 'spec.json'):
            os.link(root / name, d / name)
        procs[world] = (_launch(world, str(d)), str(d))
    try:
        jrefs = _jax_refs(arrays, spec)
        prefs = _port_refs(arrays, spec)
    finally:
        failed = [_wait(ps, d) for ps, d in procs.values()]
    assert not any(failed), '\n'.join(filter(None, failed))
    return dict(jax=jrefs, port=prefs, spec=spec,
                worlds={w: _collect(w, d) for w, (_, d) in procs.items()})


# --------------------------------------------------------------------------

@pytest.mark.parametrize('world', WORLDS)
def test_make_mesh_layout(runs, world):
    """JAX's default split (dp 2 when the world is even and > 1) and its
    row-major (dp, sp) layout of the ranks."""
    for r, rank in enumerate(runs['worlds'][world]['ranks']):
        dp, sp = 2, world // 2
        ddp = DEMOD_DP[world]
        dsp = world // ddp
        np.testing.assert_array_equal(
            rank['layout'], [dp, sp, r // sp, r % sp, ddp, dsp, r // dsp,
                             r % dsp])


@pytest.mark.parametrize('world', WORLDS)
def test_sharded_demod_against_jax(runs, world):
    got = runs['worlds'][world]
    demod, pidx, _pval = runs['jax']['demod'][world]
    assert got['demod'].shape == demod.shape
    assert np.abs(got['demod'] - demod).max() <= DEMOD_TOL * np.ptp(demod)
    # the wrapped last block (its halo is the first shard's head) too
    keep = W.small_cfg().block_keep
    tail = slice((DEMOD_NBLOCKS - 1) * keep, None)
    assert np.abs(got['demod'][:, tail] - demod[:, tail]).max() \
        <= DEMOD_TOL * np.ptp(demod)
    # each field's peaks over the whole field, the same on every sp rank
    f_l = DEMOD_NFIELDS // DEMOD_DP[world]
    for i, row in enumerate(got['pidx']):
        for shard in row:
            np.testing.assert_array_equal(shard,
                                          pidx[i * f_l:(i + 1) * f_l])
    assert (pidx >= 0).sum(axis=1).min() >= 8


def _assert_equal_but_audio(got, want):
    keys = set(want) - {'next'}
    assert set(got) - {'next'} == keys
    for k in keys:
        if k == 'audio':
            d = got[k].astype(np.int64) - want[k].astype(np.int64)
            assert np.abs(d).max() <= AUDIO_LSB \
                and (d != 0).sum() <= AUDIO_TICKS, k
        else:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize('system', list(PIPELINE))
@pytest.mark.parametrize('world', WORLDS)
def test_sharded_pipeline_against_single_rank(runs, world, system):
    got = runs['worlds'][world][system]
    want = runs['port'][system]
    assert got['meta_i'][:, 0].all()                  # every field valid
    _assert_equal_but_audio(got, want)
    # the chained scalars, the same on every rank
    for ns, no in got['next']:
        assert int(ns) == want['next'][0]
        assert np.float32(no) == np.float32(want['next'][1])


@pytest.mark.parametrize('system', list(PIPELINE))
@pytest.mark.parametrize('world', WORLDS)
def test_sharded_pipeline_against_jax(runs, world, system):
    got = runs['worlds'][world][system]
    ref = runs['jax'][system]
    np.testing.assert_array_equal(
        got['meta_i'], np.stack([b['meta_i'] for b in ref['bundle']]))
    np.testing.assert_allclose(got['meta_f'],
                               [b['meta_f'][0] for b in ref['bundle']],
                               rtol=0, atol=1e-9)
    for ns, no in got['next']:
        assert int(ns) == ref['next'][0]
        assert abs(no - ref['next'][1]) <= 1e-9
    for b, jb in enumerate(ref['bundle']):
        want = jb['linelocs_i'].astype(np.float64) + jb['linelocs_f']
        loc = (got['linelocs_i'][b].astype(np.float64)
               + got['linelocs_f'][b])
        assert np.abs(loc - want).max() <= LOC_TOL
        assert got['audio_count'][b] == jb['audio_count'][0]
        n = (int(jb['audio_count'][0]) - 1) * 2
        if n > 0:
            assert_audio_close(got['audio'][b, :n], jb['audio'][:n])
        ok = jb['philips_ok'].astype(bool)
        np.testing.assert_array_equal(got['philips_ok'][b], ok)
        np.testing.assert_array_equal(got['philips_nib'][b][ok],
                                      jb['philips_nib'][ok])
    if system == 'PAL':
        assert_pal_picture(got['picture'], ref['pic'])
    else:
        assert_picture_close(got['picture'], ref['pic'])


@pytest.mark.parametrize('world', WORLDS)
def test_sharded_comb3d(runs, world):
    got = runs['worlds'][world]['comb']
    np.testing.assert_array_equal(got, runs['port']['comb'])
    d = np.abs(got.astype(np.int64) - runs['jax']['comb'])
    assert d.max() <= 1


@pytest.mark.parametrize('world', WORLDS)
def test_nn_comb_train_dp_mesh(runs, world):
    ranks = runs['worlds'][world]['ranks']
    want = runs['port']
    for name, g in want['grads'].items():
        noise = max(float(np.abs(r[f'grad_{name}'] - g).max())
                    for r in ranks)
        assert float(np.abs(g).min()) > 10 * noise, name
    for r in ranks:
        assert np.isfinite(r['nn_loss'])
        np.testing.assert_allclose(float(r['nn_loss']), want['nn_loss'],
                                   rtol=NN_LOSS_RTOL)
        for name, v in want['nn'].items():
            np.testing.assert_allclose(r[f'nn_{name}'], v,
                                       atol=NN_PARAM_ATOL, err_msg=name)


@pytest.mark.parametrize('name', ['demod', 'NTSC', 'PAL', 'comb', 'nn'])
def test_sharded_graphs_equal_eager(runs, name):
    """The 2-rank gloo world's sharded functions, emulated: the
    sharded demod, the NTSC and PAL batch calls, the 3D comb
    and the data-parallel trainer; each key warmed up and captured once
    on other inputs, and the replay on the eager call's inputs equal to
    it bit for bit on every rank."""
    for rank in runs['worlds'][W.GRAPH_WORLD]['ranks']:
        if name == 'nn':
            # 3 steps: the first eager (Adam's state), a warm-up, a capture
            np.testing.assert_array_equal(rank['g_nn_counts'], [1, 1, 1])
            assert float(rank['g_nn_loss']) == float(rank['nn_loss'])
            keys = [k[2:] for k in rank if k.startswith('g_nn_')
                    and k not in ('g_nn_counts', 'g_nn_loss')]
        else:
            # a warm-up, a capture (its own replay), a replay
            np.testing.assert_array_equal(rank[f'g_{name}_counts'],
                                          [1, 1, 2])
            # the warm-up's and the capture's inputs were not the replay's
            np.testing.assert_array_equal(rank[f'g_{name}_varied'],
                                          [True, True])
            keys = {'demod': ['demod', 'pidx', 'pval'],
                    'comb': ['comb_rgb']}.get(name) or [
                k[2:] for k in rank
                if k.startswith(f'g_{name}_')
                and not k.endswith(('_counts', '_varied'))]
        assert len(keys) >= 3 or name == 'comb', keys
        for k in keys:
            np.testing.assert_array_equal(rank['g_' + k], rank[k],
                                          err_msg=k)
