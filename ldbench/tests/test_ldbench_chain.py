"""The `chain` entry (ldbench/drivers/chain.py) on the CPU, at a size a test
run holds: a 6-frame NTSC tile, batches of 2 fields, the smallest segment,
graphs off, comb windows of 3 frames 1 deep, 2 seconds of window, 2
frames compared.

  * a sound run is `correct` and its control (the plain reference at
    bfloat16 in the program's place) is not;
  * the timed path broken underneath, once for each fault the chain can
    have: a state reset (the AGC carry at every window, the CX state at
    every frame), a wrong input (the ring's previous frame taken from two
    frames back), an output lost (one RGB frame of every window dropped),
    a wrong decode word the comb reads (every burst flag inverted, every
    burst level 9 % low), a line location moved;
  * the comb's and CX's readers read the program's spans and, by hand,
    the device operations launched inside them;
  * the reference, the entry and the readers import neither JAX nor, the
    reference, the port.

    python -m pytest ldbench/tests/test_ldbench_chain.py -q
"""

import ast
import os
import time

import numpy as np
import pytest
import torch

from ldbench import harness

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELL = 'ntsc_cav_dd40.chain_noflow'
JAX = {'jax', 'jaxlib', 'flax', 'ld_decode_tpu'}


@pytest.fixture(autouse=True)
def tile_cache(tmp_path_factory, monkeypatch):
    from ldbench.source import stream
    monkeypatch.setattr(stream, 'CACHE_DIR',
                        str(tmp_path_factory.getbasetemp() / 'tiles'))


def run(seed, control=False):
    cell = harness.resolve(CELL)
    # graphs off: on the CPU they are eager calls, and a process-wide cache
    # of them would keep a call from an earlier test past a fault planted
    # in a later one
    cell['traffic'] = dict(cell['traffic'], batch=2, segment_mb=1,
                           check_frames=2, warmup_frames_after_swap=2,
                           graphs=False, comb_batch=3, depth=1)
    return harness.run(cell, seed, 2.0, False, 'cpu', time.perf_counter(),
                       control=control, tile_frames=6)


def test_sound_run_is_correct_and_the_control_is_not():
    r = run(424242, control=True)
    assert r['correct'], r['_reasons']
    assert r['failed'] == 0 and r['attempted'] > 0
    assert not r['_control']['correct']
    for k in ('picture_lsb', 'audio_p99_lsb'):
        assert r['_control'][k] > 100 * max(r['checks'][k]['value'], 1), k
    assert r['_extras']['agc_windows'] >= 2
    assert r['_extras']['burst_rel_max'] < 0.02
    assert r['_extras']['rgb_lsb'] <= 16384
    # the control's RGB is off by more than RGB_LSB at a pixel of a frame
    assert r['_control']['failed'] > 0


def test_an_agc_carry_reset_at_every_window_is_caught(monkeypatch):
    from ld_decode_tpu_torch.comb import batch as TB
    real = TB.NTSCCombBatch._feed

    def reset(self, dev):
        self.aburstlev = -1.0
        return real(self, dev)

    monkeypatch.setattr(TB.NTSCCombBatch, '_feed', reset)
    r = run(515151)
    assert not r['correct']
    assert r['failed'] > 0
    assert any('AGC carry' in x for x in r['_reasons'])


def test_the_previous_frame_from_two_frames_back_is_caught(monkeypatch):
    from ld_decode_tpu_torch.comb import batch as TB
    from ld_decode_tpu_torch.comb.comb_ntsc import _frame_core

    def two_back(win, levels, cfg):
        prv = torch.cat([win[:1], win[:-3]])
        rgb, _ = _frame_core(win[1:-1], prv, win[2:], levels, cfg)
        return TB._crop(rgb, cfg), win[1:-1, 0, :16]

    monkeypatch.setattr(TB, '_comb_window_ring', two_back)
    r = run(626262)
    assert not r['correct']
    assert r['checks']['picture_lsb']['value'] \
        > r['checks']['picture_lsb']['limit']


def test_a_dropped_rgb_frame_is_caught(monkeypatch):
    from ld_decode_tpu_torch.comb import batch as TB
    real = TB.NTSCCombBatch.collect

    def drop_one(self, handle):
        rgb, words = real(self, handle)
        return rgb[1:], words[1:]

    monkeypatch.setattr(TB.NTSCCombBatch, 'collect', drop_one)
    r = run(737373)
    assert not r['correct']
    assert r['failed'] > 0


def test_a_cx_state_reset_at_every_frame_is_caught(monkeypatch):
    from ld_decode_tpu_torch.audio import cx as TCX
    real = TCX.CXExpander.process

    def reset(self, pcm):
        TCX.CXExpander.__init__(self, device=self.device)
        return real(self, pcm)

    monkeypatch.setattr(TCX.CXExpander, 'process', reset)
    r = run(848484)
    assert not r['correct']
    assert r['checks']['audio_p99_lsb']['value'] \
        > r['checks']['audio_p99_lsb']['limit']


def test_inverted_burst_flags_are_caught(monkeypatch):
    from ld_decode_tpu_torch.tbc import fused
    real = fused._scale_u16

    def inverted(out, lc, burstlevel, cfg, colorlevel):
        return real(out, lc, None if burstlevel is None else -burstlevel,
                    cfg, colorlevel)

    monkeypatch.setattr(fused, '_scale_u16', inverted)
    r = run(959595)
    assert not r['correct']
    assert any('burst flags' in x for x in r['_reasons'])


def test_low_burst_levels_are_caught(monkeypatch):
    """Levels 9 % low reach the AGC and the comb the same way on both sides
    of the RGB comparison; the burst words' own check sees them."""
    from ld_decode_tpu_torch.tbc import fused
    real = fused._scale_u16

    def low(out, lc, burstlevel, cfg, colorlevel):
        return real(out, lc, burstlevel, cfg, colorlevel * 1.1)

    monkeypatch.setattr(fused, '_scale_u16', low)
    r = run(161616)
    assert not r['correct']
    assert r['_extras']['burst_rel_max'] > 0.08


def test_moved_line_locations_are_caught(monkeypatch):
    """Three lines of every field moved 2 px: the reference's comb reads
    the port's locations, so only the fields' own check sees them."""
    from ld_decode_tpu_torch.tbc import fused
    real = fused._refine_batch

    def moved(*a, **kw):
        lli, llf, bl = real(*a, **kw)
        lli = lli.clone()
        lli[:, 100:103] += 2
        return lli, llf, bl

    monkeypatch.setattr(fused, '_refine_batch', moved)
    r = run(272727)
    assert not r['correct']
    assert r['checks']['lineloc_px']['value'] >= 1.9


def _reader(name):
    return harness.metric_reader(name)


def test_the_span_readers_read_the_chain():
    """The program's spans, recorded under a profiler over a few RGB frames
    of the chain entry on the CPU, are what the four span readers read.
    (A traced harness run on the CPU cannot close its slice in time: a
    frame takes seconds there.)"""
    from types import SimpleNamespace
    from ldbench.drivers.chain import Driver
    from ldbench.source.stream import SideStream
    from ld_decode_tpu_torch.utils import spans as S
    cell = harness.resolve(CELL)
    cell['traffic'] = dict(cell['traffic'], batch=2, segment_mb=1,
                           graphs=False, comb_batch=3, depth=1)
    src = SideStream(cell['config'], 313131, 'cpu', tile_frames=6)
    drv = Driver(cell, src, 'cpu')
    try:
        drv.frame()
        S.reset()
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]):
            for _ in range(4):
                drv.frame()
    finally:
        drv.release()
    run = SimpleNamespace(trace={'window_s': 1.0, 'busy_s': 0.0, 'ops': []},
                          cell=cell, window_s=1.0, before={}, after={})
    recs = S.records()
    feeds = [b - a for n, a, b, _, _ in recs if n == 'comb.feed']
    assert feeds
    assert _reader('comb.feed_ms_per_frame')(run) == pytest.approx(
        sum(feeds) / 1e6 / (3 * len(feeds)))
    for name, span in (('comb.levels_ms', 'comb.levels'),
                       ('comb.collect_ms', 'comb.collect'),
                       ('cx.ms_per_frame', 'cx.process')):
        got = [b - a for n, a, b, _, _ in recs if n == span]
        assert got, span
        assert _reader(name)(run) == pytest.approx(
            float(np.median(got)) / 1e6), name
    # no device: the device readers find nothing
    assert _reader('comb.device_share')(run) is None
    assert _reader('comb_roofline')(run) is None
    S.reset()


def test_the_device_readers_by_hand(monkeypatch):
    """comb.device_share and comb_roofline on a hand-made trace: each
    device operation belongs to the span its launch began in (a graph's
    kernels share its launch's correlation), copies count for the share
    and not for the roofline, and a window counts whole where its
    `comb.replay` begins in the slice."""
    from types import SimpleNamespace
    from ldbench import comb_yardstick as CY
    from ldbench import program_spans as P
    # records in ns: a feed holding levels and a replay, a collect, a
    # decode span; and a replay that begins after the slice
    recs = [('comb.feed', 100_000, 400_000, -1, -1),
            ('comb.levels', 110_000, 150_000, 0, -1),
            ('comb.replay', 200_000, 300_000, 0, -1),
            ('comb.collect', 500_000, 520_000, -1, -1),
            ('prefetch.dispatch', 600_000, 700_000, -1, -1),
            ('comb.replay', 2_000_000, 2_100_000, -1, -1)]
    monkeypatch.setattr(P, 'records', lambda run: recs)
    # launches (us, correlation): the levels' copy (1), the graph (2) and
    # the RGB copy (3) in the replay, the decode's kernel (4), the late
    # window's graph (5)
    launches = [(120.0, 1), (210.0, 2), (250.0, 3), (650.0, 4),
                (2050.0, 5)]
    dev = [(160.0, 161.0, 'Memcpy DtoH', 7, 1),
           (300.0, 340.0, 'comb_kernel_a', 7, 2),
           (340.0, 380.0, 'comb_kernel_b', 7, 2),
           (380.0, 390.0, 'Memcpy DtoH', 7, 3),
           (700.0, 800.0, 'decode_kernel', 7, 4),
           (2100.0, 2200.0, 'comb_kernel_a', 7, 5)]
    host = [(0.0, 1000.0, 'ldbench.slice')]
    monkeypatch.setitem(CY._kept, 'events', (dev, host, launches))
    cell = harness.resolve(CELL)
    run = SimpleNamespace(trace={'window_s': 1e-3, 'busy_s': 191e-6,
                                 'ops': []}, cell=cell)
    share = _reader('comb.device_share')(run)
    assert share == pytest.approx((1 + 80 + 10) / 191)
    frames = cell['traffic']['comb_batch']
    least_us = frames * (525 * 910 * 2 + 480 * 744 * 6) / 3.35e12 * 1e6
    assert _reader('comb_roofline')(run) == pytest.approx(
        100 * least_us / 80)


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module \
                and not node.level:
            yield node.module


@pytest.mark.parametrize('path', [
    'reference/comb.py', 'drivers/chain.py', 'comb_yardstick.py',
    'metrics/comb.feed_ms_per_frame.py', 'metrics/comb.levels_ms.py',
    'metrics/comb.collect_ms.py', 'metrics/cx.ms_per_frame.py',
    'metrics/comb.device_share.py', 'metrics/comb_roofline.py'])
def test_imports_no_jax(path):
    names = {n.split('.')[0] for n in _imports(os.path.join(BENCH, path))}
    assert not names & JAX, (path, names & JAX)
    if path.startswith('reference/'):
        assert 'ld_decode_tpu_torch' not in names


def test_the_reference_needs_no_port():
    """The reference's comb runs in a process that has never loaded the
    port, TF32 off."""
    import subprocess
    import sys
    code = ('import sys, numpy as np, torch\n'
            'from ldbench.reference import comb as RC\n'
            'r = RC.CombReference("cpu")\n'
            'f = np.full((525, 910), 20000, np.uint16)\n'
            'f[:, 0] = 16384; f[:, 1] = 7168\n'
            'lv, c = r.agc(f[:, 1], -1.0)\n'
            'assert r.frame(f, f, f, lv).shape == (480, 744, 3)\n'
            'assert not torch.backends.cuda.matmul.allow_tf32\n'
            'assert not torch.backends.cudnn.allow_tf32\n'
            'bad = [m for m in sys.modules if m.split(".")[0] in '
            '("ld_decode_tpu_torch", "ld_decode_tpu", "jax")]\n'
            'assert not bad, bad\n')
    p = subprocess.run([sys.executable, '-c', code],
                       cwd=os.path.dirname(BENCH), capture_output=True,
                       text=True, timeout=300)
    assert p.returncode == 0, p.stderr
    assert np.isfinite(0.0)
