"""PyTorch port, the bench: bench_torch.py against bench.py at a tiny size
on the CPU (the decode stage position for position, the tables, the
timing arithmetic), one chain stage's checks, the captures' encode, the
refusals and the JSON line."""

import json
import os
import subprocess
import sys
import types

import jax
import numpy as np
import pytest
import torch

import bench as JB
import bench_torch as TB
from ld_decode_tpu.models import encode as JE
from ld_decode_tpu.tbc import framer as JFR
from ld_decode_tpu.utils.params import DecoderConfig
from ld_decode_tpu_torch.models import encode as TE
from ld_decode_tpu_torch.tbc import framer as TFR
from ld_decode_tpu_torch.utils.graphs import GraphCache
from ld_decode_tpu_torch.utils.params import DecoderConfig as TConfig

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RAMP = dict(pattern='ramp', cav_start_frame=900)


@pytest.fixture(scope='module')
def ntsc_capture():
    return JE.encode_frames(DecoderConfig(), 16, JE.EncodeSpec(**RAMP))


def _recorder(monkeypatch, framer_cls):
    """Record (next sample, VBI frame number) of every readframe."""
    seen = []
    orig = framer_cls.readframe

    def readframe(self, *a, **k):
        rv = orig(self, *a, **k)
        seen.append((rv[2], self.vbi.get('framenr')))
        return rv

    monkeypatch.setattr(framer_cls, 'readframe', readframe)
    return seen


def test_decode_stage_matches_bench(monkeypatch, ntsc_capture):
    """One visit of one short pass of the headline stage at batch 2: the
    port's reads land on bench.py's sample positions and frame numbers,
    and its prefetcher makes the same integer decisions."""
    cap = ntsc_capture[:14 * 1334669]
    monkeypatch.setattr(JB, 'capture_for', lambda key, jobs: cap)
    monkeypatch.setattr(TB, 'capture_for', lambda key, jobs: cap)
    jseen = _recorder(monkeypatch, JFR.Framer)
    tseen = _recorder(monkeypatch, TFR.Framer)
    with jax.enable_x64(False):
        js = JB._DecodeStage('ntsc', 'clean', 'NTSC', {}, batch=2,
                             nblocks=52, start=33046, reps=2)
        js.visit(1)
    ts = TB._DecodeStage('ntsc', 'clean', 'NTSC', TB.Jobs({}), batch=2,
                         nblocks=52, start=33046, reps=2, device='cpu')
    ts.visit(1)
    assert len(tseen) == len(jseen) >= 8
    assert tseen == jseen
    assert [n for _, n in tseen] == list(range(901, 901 + len(tseen)))
    jstats, tstats = js.fr.prefetcher.stats, ts.fr.prefetcher.stats
    common = [k for k, v in jstats.items()
              if isinstance(v, (int, str)) and k in tstats]
    assert {'refills', 'hits', 'batches', 'seq_fallback'} <= set(common)
    assert {k: tstats[k] for k in common} == {k: jstats[k] for k in common}
    assert len(ts.rates) == len(js.rates) == 1 and ts.rates[0] > 0
    rep = ts.report()
    assert rep['frames_checked'] == len(tseen)
    assert rep['warmup_s'] > 0
    assert rep['kernel_launches'] == {'K1': 0, 'K1_window': 0, 'K2': 0}


def test_capture_table_matches_bench():
    assert TB._CAPTURES.keys() == JB._CAPTURES.keys()
    for key, (system, frames, kw, tag) in JB._CAPTURES.items():
        assert TB._CAPTURES[key] == (system, frames, kw, tag)
        assert TE.EncodeSpec(**kw) == TE.EncodeSpec(
            **TB._CAPTURES[key][2])


@pytest.mark.parametrize('rates', [[3.0, 1.0, 2.0], [4.0, 1.0, 3.0, 2.0],
                                   [5.5]], ids=['odd', 'even', 'one'])
def test_median_matches_bench(rates):
    assert TB.median(rates) == JB.median(rates)


def test_stages_take_bench_parameters():
    stages = TB.make_stages(TB.Jobs({}), 'cpu')
    assert list(stages) == ['ntsc', 'ntsc_noisy', 'pal', 'full_chain',
                            'full_chain_rgb8', 'full_chain_noflow',
                            'pal_chain', 'pal_chain_rgb8']
    got = {k: (s.key, s.batch, s.reps, s.start) for k, s in stages.items()}
    assert got['ntsc'] == ('clean', 16, 32, 33046)
    assert got['ntsc_noisy'] == ('noisy', 16, 24, 33046)
    assert got['pal'] == ('pal', 16, 20, 2560 * 14)
    assert got['full_chain'] == ('clean', 16, 24, 33046)
    assert got['pal_chain_rgb8'] == ('pal', 16, 20, 2560 * 14)
    assert stages['ntsc'].nblocks == 52 and stages['pal'].nblocks == 56
    assert (stages['full_chain_noflow'].opticalflow, stages[
        'full_chain_rgb8'].out8) == (False, True)
    # bench.py's schedule
    assert sorted({k for k, _ in TB.SCHEDULE}) == sorted(stages)
    assert sum(n for _, n in TB.SCHEDULE) == 34
    # --quick: each stage once, one pass, captures cut to what that reads
    quick = TB.quick_schedule()
    assert sorted(k for k, _ in quick) == sorted(stages)
    assert {n for _, n in quick} == {1}
    cut = TB.quick_frames(stages)
    assert cut == {'clean': 124, 'noisy': 92, 'pal': 120}
    for key, st in stages.items():
        assert st.frames_needed(1) <= cut[st.key]


@pytest.fixture(scope='module')
def pal_capture():
    return JE.encode_frames(DecoderConfig(system='PAL'), 16, JE.EncodeSpec(
        pattern='palbars', cav_start_frame=900))


@pytest.mark.parametrize('key,held,rgb', [
    ('full_chain', 2, (480, 744, 3, 2)),
    ('pal_chain_rgb8', 1, (576, 1135, 3, 1))])
def test_chain_stage_checks(monkeypatch, request, key, held, rgb):
    """A chain stage at batch 2, windows of 3 with 1 in flight, two
    visits (the comb's stream runs on across them): every frame checked,
    every RGB frame of the stage's shape and dtype, every frame fed back
    as RGB but those the comb holds (NTSC flow: the pending frame and the
    stream's frame 0; PAL: the last frame, which its flush would emit)."""
    cap = request.getfixturevalue('pal_capture' if 'pal' in key
                                  else 'ntsc_capture')
    monkeypatch.setattr(TB, 'capture_for', lambda k, jobs: cap)
    st = TB.make_stages(TB.Jobs({}), 'cpu')[key]
    st.CB, st.DEPTH, st.batch, st.reps = 3, 1, 2, 2
    st.visit(1)
    rep = st.report()
    assert rep['frames_checked'] == 2 + 2 * 3 + 4 + 2
    assert rep['rgb_frames'] > 0
    assert rep['frames_fed'] - rep['rgb_frames'] == rep['comb_held'] == held
    assert rep['rgb_bytes_per_frame'] == np.prod(rgb)
    assert rep['cx_audio_bytes'] > 0 and len(rep['pass_rates']) == 1
    # a frame of another shape fails the check
    st.rgb_shape = (480, 910, 3)
    with pytest.raises(TB.BenchCheckError, match='RGB frame'):
        st.visit(1)


def _stage_with_vbi():
    st = TB.make_stages(TB.Jobs({}), 'cpu')['ntsc']
    st.fr = types.SimpleNamespace(vbi={'framenr': None})
    return st


@pytest.mark.parametrize('numbers', [[901, 903], [901, 901], [901, None]],
                         ids=['gap', 'repeat', 'missing'])
def test_frame_number_check(numbers):
    st = _stage_with_vbi()
    frame = (np.zeros(4), None, 0, None)
    for n in numbers[:-1]:
        st.fr.vbi['framenr'] = n
        st._check_frame(frame)
    st.fr.vbi['framenr'] = numbers[-1]
    with pytest.raises(TB.BenchCheckError, match='frame number'):
        st._check_frame(frame)


def test_missing_frame_fails():
    st = _stage_with_vbi()
    with pytest.raises(TB.BenchCheckError, match='no frame'):
        st._check_frame((None, None, None, None))
    fr = types.SimpleNamespace(readframe=lambda *a: (None,) * 4,
                               device=torch.device('cpu'))
    with pytest.raises(TB.BenchCheckError, match='end of capture'):
        TB.sustained_passes(fr, 0, 4, 1, 1e6, 'ntsc')


def test_burn_in_missing_frame_fails():
    """A read of the burn-in that returns no frame fails the visit, as
    one of a timed pass does."""
    st = _stage_with_vbi()
    st.batch = 2
    st.fr = types.SimpleNamespace(
        vbi={'framenr': None}, readframe=lambda *a: (None,) * 4,
        prefetcher=types.SimpleNamespace(DEPTH=3))
    with pytest.raises(TB.BenchCheckError, match='no frame'):
        st._burn_in(0, st._check_frame)


@pytest.mark.parametrize('intervals,window,busy', [
    ([(0, 4), (2, 6), (8, 9)], None, 7),
    ([(0, 4), (1, 2), (5, 7)], None, 6),
    ([(0, 4), (2, 6), (8, 9)], (3, 8.5), 3.5),
    ([], None, 0)], ids=['overlap', 'nested', 'window', 'none'])
def test_busy_union(intervals, window, busy):
    assert TB._busy_us(intervals, *(window or ())) == busy


def test_trace_summary_counts_device_work():
    """The device's busy time in a pass is its kernels' and copies'
    union inside the pass's range; the range's own annotation on the
    device's timeline is no work."""
    from torch.autograd import DeviceType

    def ev(name, a, b, dev, annotation=False):
        return types.SimpleNamespace(
            name=name, time_range=types.SimpleNamespace(start=a, end=b),
            device_type=dev, is_user_annotation=annotation)

    cuda, cpu = DeviceType.CUDA, DeviceType.CPU
    prof = types.SimpleNamespace(events=lambda: [
        ev('pal pass 0', 10, 50, cpu), ev('pal pass 0', 12, 49, cuda, True),
        ev('pal pass 1', 60, 100, cpu), ev('pal pass 1', 61, 99, cuda),
        ev('kern', 5, 15, cuda), ev('kern', 20, 30, cuda),
        ev('Memcpy DtoH', 25, 35, cuda), ev('kern', 70, 80, cuda),
        ev('aten::add', 20, 21, cpu)])
    got = TB.trace_summary(prof, 'pal')
    assert got['device_ops'] == 4 and got['device_busy_ms'] == 0.035
    assert [p['device_busy_ms'] for p in got['passes']] == [0.02, 0.01]
    assert [p['wall_ms'] for p in got['passes']] == [0.04, 0.04]
    assert [p['busy_share'] for p in got['passes']] == [0.5, 0.25]


def _traced_stub(tag, key, fail=False):
    """A stage whose visit times passes over a framer that reads frames
    without decoding (one field batch dispatched a frame)."""
    st = _Stub(tag, key, fail)
    stats = {'batches': 0}

    def readframe(*a):
        stats['batches'] += 1
        st.fr.vbi['framenr'] += 1
        return np.zeros(4), None, 0, None

    def visit(npasses):
        st._last_framenr = None
        st.fr = types.SimpleNamespace(
            graphs=GraphCache('cpu'), device=torch.device('cpu'),
            vbi={'framenr': 900}, readframe=readframe,
            prefetcher=types.SimpleNamespace(stats=stats))
        st.warmup_s = 0.5
        st.rates.extend(TB.sustained_passes(
            st.fr, 0, 3, npasses, 1e6, tag, per_frame=st._check_frame,
            pass_batches=st.pass_batches))

    st.visit = visit
    return st


def test_profile_names_a_stage(monkeypatch, capsys, tmp_path):
    """LD_TPU_PROFILE_STAGE picks the stage whose first visit is traced;
    the line gains the trace's summary, one entry a timed pass; a name
    that is not a stage fails the run."""
    keys = list(TB.make_stages(TB.Jobs({}), 'cpu'))
    monkeypatch.setattr(TB, 'make_stages', lambda jobs, device: {
        k: _traced_stub(k, 'pal' if 'pal' in k else 'clean') for k in keys})
    monkeypatch.setattr(TB, 'start_pre_encodes', lambda jobs: jobs)
    monkeypatch.setenv('LD_TPU_PROFILE_DIR', str(tmp_path))
    monkeypatch.setenv('LD_TPU_PROFILE_STAGE', 'pal')
    assert TB.main(['--device', 'cpu']) == 0
    extra = json.loads(capsys.readouterr().out.strip().splitlines()[-1])[
        'extra']
    prof = extra['profile']
    assert prof['stage'] == 'pal' and len(prof['pass_rates']) == 2
    assert prof['device_ops'] == 0 and len(prof['passes']) == 2
    assert all(p['wall_ms'] > 0 and p['device_busy_ms'] == 0
               and p['batches'] == 3 for p in prof['passes'])
    assert os.listdir(tmp_path) == ['bench_torch_pal_visit0.json']
    assert extra['stages']['pal']['pass_batches'] == [3] * 4
    monkeypatch.setenv('LD_TPU_PROFILE_STAGE', 'palx')
    with pytest.raises(ValueError, match='not one of'):
        TB.main(['--device', 'cpu', '--quick'])


def test_captures_encode_in_subprocesses(tmp_path):
    """A spawn process encodes the capture into the cache, equal to the
    encoder's own output; the name follows the frame count."""
    jobs = TB.Jobs({'clean': 2}, cache_dir=str(tmp_path))
    TB.start_pre_encodes(jobs)
    assert jobs.mode == 'serial' and set(jobs.procs) == {'clean'}
    got = TB.capture_for('clean', jobs)
    want = TE.encode_frames(TConfig(), 2, TE.EncodeSpec(**RAMP))
    np.testing.assert_array_equal(got, want)
    assert not jobs.procs['clean'].is_alive()
    assert TB.encode_seconds(jobs)['clean'] > 0
    again = TB.Jobs({'clean': 2}, cache_dir=str(tmp_path))
    TB.start_pre_encodes(again)
    assert again.mode == 'cached' and not again.procs
    assert TB.capture_path('clean', 3) != TB.capture_path('clean', 2)


class _Stub(TB._Stage):
    """A stage whose visit records rates without decoding."""

    batch, reps = 16, 4

    def __init__(self, tag, key, fail=False):
        super().__init__(tag, key, 'cpu')
        self.fail = fail

    def visit(self, npasses):
        if self.fail:
            raise RuntimeError(f'{self.tag} failed')
        self.fr = types.SimpleNamespace(
            graphs=GraphCache('cpu'),
            prefetcher=types.SimpleNamespace(stats={}))
        self.warmup_s = 0.5
        self.rates.extend([50.0 + len(self.rates)] * npasses)


def _stubs(fail=()):
    keys = list(TB.make_stages(TB.Jobs({}), 'cpu'))
    return lambda jobs, device: {
        k: _Stub(k, 'pal' if 'pal' in k else 'clean', k in fail)
        for k in keys}


def test_json_line(monkeypatch, capsys):
    """The last line holds every key of bench.py's line but the link
    probe's, and the port's additions."""
    monkeypatch.setattr(TB, 'make_stages', _stubs())
    monkeypatch.setattr(TB, 'start_pre_encodes', lambda jobs: jobs)
    assert TB.main(['--device', 'cpu', '--quick']) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line['metric'] == 'ntsc_demod_tbc_throughput'
    assert line['unit'] == 'MSa/s' and line['value'] == 50.0
    assert line['vs_baseline'] == 1.25
    extra = line['extra']
    keys = ['ntsc_noisy', 'pal', 'full_chain', 'full_chain_rgb8',
            'full_chain_noflow', 'pal_chain', 'pal_chain_rgb8']
    want = {'ntsc_pass_rates', 'pic_mode'} \
        | {f'{k}_MSa_s' for k in keys} | {f'{k}_pass_rates' for k in keys}
    port = {'device', 'encode_s', 'encode_mode', 'stages', 'reduced'}
    assert want | port <= set(extra)
    assert 'd2h_probe_MBps' not in extra
    assert extra['device'] == {'name': 'cpu', 'power_limit': None,
                               'count': 0}
    assert len(extra['reduced']) == 3
    for k in ['ntsc'] + keys:
        st = extra['stages'][k]
        assert st['pass_rates'] == [50.0] and st['warmup_s'] == 0.5
        assert {'graphs', 'peak_mem_mib', 'kernel_launches'} <= set(st)
    # the full schedule: bench.py's passes, nothing reduced
    monkeypatch.setattr(TB, 'make_stages', _stubs())
    assert TB.main(['--device', 'cpu']) == 0
    extra = json.loads(capsys.readouterr().out.strip().splitlines()[-1])[
        'extra']
    assert extra['reduced'] == []
    assert len(extra['ntsc_pass_rates']) == 8
    assert len(extra['ntsc_noisy_pass_rates']) == 3


def test_failed_stage_fails_the_run(monkeypatch):
    monkeypatch.setattr(TB, 'make_stages', _stubs(fail={'pal_chain'}))
    monkeypatch.setattr(TB, 'start_pre_encodes', lambda jobs: jobs)
    with pytest.raises(RuntimeError, match='pal_chain failed'):
        TB.main(['--device', 'cpu', '--quick'])


def test_no_card_no_run():
    """Without a CUDA device and without --device cpu the bench exits
    nonzero, naming the flag, and prints no result."""
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present: the bench would run')
    proc = subprocess.run([sys.executable, 'bench_torch.py', '--quick'],
                          cwd=ROOT, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0
    assert '--device cpu' in proc.stderr
    assert 'ntsc_demod_tbc_throughput' not in proc.stdout
