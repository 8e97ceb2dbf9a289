"""The comparison that decides `correct` fails where it must, on the CPU at a
size a test run holds: a 6-frame NTSC or 4-frame PAL tile, batches of 2
fields, the smallest segment, graphs off, 2 seconds of window, 2 frames
compared.

  * the control, the plain reference at bfloat16 in the decode's place;
  * the timed path broken underneath, once for each fault a decode cell
    can have: a step that returns its state unchanged (a segment swap that
    leaves the old samples in the buffer; the audio's carry reset at every
    field), half of the batch left out (its second half given the first
    half's pictures), an answer altered where it is produced (a picture
    sample of every field; three PAL lines moved by 2 px after the pilot
    pass);
  * a run whose process holds JAX once the comparison has run prints no
    result.

Each runs the harness as run.py does, skipping only its look for a card.

    python -m pytest ldbench/tests/test_ldbench_control.py -q
"""

import sys
import time
import types

import pytest
import torch

from ldbench import harness

CELLS = {'ntsc_cav_dd40.decode': 6, 'pal_cav_dd40.decode': 4}


@pytest.fixture(autouse=True)
def tile_cache(tmp_path_factory, monkeypatch):
    from ldbench.source import stream
    monkeypatch.setattr(stream, 'CACHE_DIR',
                        str(tmp_path_factory.getbasetemp() / 'tiles'))


def small_cell(name='ntsc_cav_dd40.decode'):
    cell = harness.resolve(name)
    # graphs off: on the CPU they are eager calls, and a process-wide
    # cache of them would keep a call from an earlier test past a fault
    # planted in a later one
    cell['traffic'] = dict(cell['traffic'], batch=2, segment_mb=1,
                           check_frames=2, warmup_frames_after_swap=2,
                           graphs=False)
    return cell


def run(seed, control=False, name='ntsc_cav_dd40.decode'):
    return harness.run(small_cell(name), seed, 2.0, False, 'cpu',
                       time.perf_counter(), control=control,
                       tile_frames=CELLS[name])


@pytest.mark.parametrize('name', sorted(CELLS))
def test_sound_run_is_correct_and_the_control_is_not(name):
    r = run(424242, control=True, name=name)
    assert r['correct'], r['_reasons']
    assert r['failed'] == 0
    assert not r['_control']['correct']
    for k in ('lineloc_px', 'lineloc_p99_px', 'picture_lsb',
              'audio_p99_lsb'):
        assert r['_control'][k] > 3 * r['checks'][k]['value'], k


def test_a_swap_that_leaves_the_old_samples_is_caught(monkeypatch):
    from ld_decode_tpu_torch.tbc import framer as FR
    real = FR.to_device_capture
    filled = []

    def stale(samples, device, out=None):
        if out is None or not filled:
            filled.append(1)
            return real(samples, device, out=out)
        return out

    monkeypatch.setattr(FR, 'to_device_capture', stale)
    r = run(515151)
    assert not r['correct']
    assert r['failed'] > 0


def _broken_batch(monkeypatch, change):
    from ld_decode_tpu_torch.tbc import fused as FU
    real = FU.field_pipeline_batch

    def broken(*a, **kw):
        out, nso, noo = real(*a, **kw)
        change(out)
        return out, nso, noo

    monkeypatch.setattr(FU, 'field_pipeline_batch', broken)


def test_half_the_batch_left_out_is_caught(monkeypatch):
    def half(out):
        pic = out['picture']
        b = pic.shape[0] // 2
        out['picture'] = torch.cat([pic[:b], pic[:b]])

    _broken_batch(monkeypatch, half)
    assert not run(626262)['correct']


def test_an_altered_picture_sample_is_caught(monkeypatch):
    def alter(out):
        out['picture'] = out['picture'].clone()
        out['picture'][:, 100, 300] += 64

    _broken_batch(monkeypatch, alter)
    r = run(737373)
    assert not r['correct']
    assert r['checks']['picture_lsb']['value'] >= 60


def test_an_audio_carry_reset_at_every_field_is_caught(monkeypatch):
    from ld_decode_tpu_torch.tbc import pipeline as PL
    real = PL.FieldPrefetcher.get

    def get(self, *a, **kw):
        f = real(self, *a, **kw)
        if f is not None:
            f.audio_next_offset = 0.0
        return f

    monkeypatch.setattr(PL.FieldPrefetcher, 'get', get)
    r = run(848484)
    assert not r['correct']
    assert r['failed'] > 0
    assert any('audio carry' in x for x in r['_reasons']), r['_reasons']


def test_pal_lines_moved_after_the_pilot_pass_are_caught(monkeypatch):
    from ld_decode_tpu_torch.tbc import pal as PALK
    real = PALK.refine_pilot

    def moved(*a, **kw):
        lli, llf = real(*a, **kw)
        lli = lli.clone()
        lli[:, 100:103] += 2
        return lli, llf

    monkeypatch.setattr(PALK, 'refine_pilot', moved)
    r = run(959595, name='pal_cav_dd40.decode')
    assert not r['correct']
    assert r['checks']['lineloc_px']['value'] >= 1.9


def test_jax_loaded_by_the_comparison_prints_no_result(monkeypatch, capsys):
    """run.py looks for JAX as its last step: a module planted while the
    reference judges the frames leaves the run without a result, where the
    same run without it prints one."""
    from ldbench import run as R
    from ldbench.reference import judge as J
    for m in list(sys.modules):
        if m.split('.')[0] in harness.JAX_NAMES:
            monkeypatch.delitem(sys.modules, m)
    cell = small_cell()
    real_run = harness.run
    monkeypatch.setattr(harness, 'resolve', lambda name: cell)
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: True)
    monkeypatch.setattr(torch.cuda, 'device_count', lambda: 1)
    monkeypatch.setattr(
        harness, 'run', lambda c, seed, seconds, trace, device, t0,
        control=False: real_run(c, seed, seconds, trace, 'cpu', t0,
                                control=control, tile_frames=6))
    argv = ['--workload', 'ntsc_cav_dd40.decode', '--seed', '616161',
            '--seconds', '2', '--trace', '0']
    assert R.main(argv) == 0
    assert '"correct": true' in capsys.readouterr().out

    real_frame = J.Judge.frame

    def frame(self, *a, **kw):
        monkeypatch.setitem(sys.modules, 'jax', types.ModuleType('jax'))
        return real_frame(self, *a, **kw)

    monkeypatch.setattr(J.Judge, 'frame', frame)
    assert R.main(argv) != 0
    captured = capsys.readouterr()
    assert '"correct"' not in captured.out
    assert 'jax' in captured.err
