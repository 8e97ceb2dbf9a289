"""An entry brings its own comparison, on the CPU.

A toy entry, handed to the harness in place of the decode's driver, emits
outputs that are no `.tbc` frames, each once the frame two later has been
read (as the chain's 3D comb holds a window of frames).  It marks every
frame with its place and CAV number, keeps its own notes of what it read,
and judges the marks and the sampled outputs against its own float64
reference, with a bfloat16 control; the harness holds its verdict to the
cell's limits.

    python -m pytest ldbench/tests/test_ldbench_entry.py -q
"""

import os
import time
from collections import deque

import pytest
import torch

from ldbench import harness

LAG = 2             # frame j is emitted once frame j + LAG has been read
SWAP_EVERY = 5      # frames between the toy's loader calls
N = 4096            # samples of a frame the toy reads
LIMITS = {'level_gap': 1e-3}


@pytest.fixture(autouse=True)
def tile_cache(tmp_path_factory, monkeypatch):
    from ldbench.source import stream
    monkeypatch.setattr(stream, 'CACHE_DIR',
                        str(tmp_path_factory.getbasetemp() / 'tiles'))


def frame_start(src, j: int) -> int:
    return int(j * src.samples_per_frame) // 4 * 4


class Toy:
    """Frame j's output is the mean level of its first N samples in
    float32 and the CAV number it carries.  `fault` plants one wrong
    number in the window ('number') or offsets every level ('level')."""
    fault = None

    def __init__(self, cell, src, device):
        self.src = src
        self.next_read = src.start_frame
        self.held = deque()
        self.read = []
        self.loader_calls = 0
        self.sample = frame_start(src, self.next_read)
        self.window_frames = None

    def _read_one(self):
        j = self.next_read
        q = self.src.quantised(frame_start(self.src, j), N)
        self.held.append({'frame': j, 'number': self.src.frame_number(j),
                          'level': float(q.to(torch.float32).mean())})
        self.read.append(j)
        self.next_read += 1
        self.sample = frame_start(self.src, self.next_read)
        if j % SWAP_EVERY == 0:
            self.loader_calls += 1

    def frame(self):
        while len(self.held) <= LAG:
            self._read_one()
        out = self.held.popleft()
        if self.window_frames is not None:
            self.window_frames += 1
            if self.fault == 'number' and self.window_frames == 3:
                out['number'] += 1
        if self.fault == 'level':
            out['level'] += 0.5
        return out

    def warm_up(self, frames_after_swap):
        calls, after = self.loader_calls, 0
        while after < frames_after_swap:
            self.frame()
            after += self.loader_calls > calls
        self.window_frames = 0

    def counters(self):
        return {'frames_read': len(self.read),
                'source_seconds': self.src.seconds}

    def label_layers(self):
        pass

    def mark(self, out):
        return out['frame'], out['number']

    def notes(self):
        return list(self.read)

    def release(self):
        self.held.clear()

    @staticmethod
    def judge(cell, src, device, marks, sampled, read, control):
        failed, reasons = 0, []
        for i, (j, nr) in enumerate(marks):
            if nr != src.frame_number(j) or (i and j != marks[i - 1][0] + 1):
                failed += 1
                reasons.append(f'frame {i}: frame {j} number {nr}')
        if read != list(range(read[0], read[-1] + 1)) \
                or read[-1] != marks[-1][0] + LAG:
            failed += 1
            reasons.append('the reads are not the frames emitted, '
                           f'{LAG} ahead')

        def level(out, dtype):
            q = src.quantised(frame_start(src, out['frame']), N)
            return float(q.to(dtype).mean())

        def gap(got):
            return {'level_gap': max(abs(got(o) - level(o, torch.float64))
                                     for o in sampled)}

        ctl = None
        if control:
            ctl = harness.Verdict(
                gap(lambda o: level(o, torch.bfloat16)), 0, len(sampled))
        return harness.Verdict(gap(lambda o: o['level']), failed,
                               len(sampled), reasons,
                               {'lag': read[-1] - marks[-1][0]}, ctl)


def toy_cell():
    cell = harness.resolve('ntsc_cav_dd40.decode')
    return dict(cell, name='ntsc_cav_dd40.toy', limits=LIMITS, traffic={
        'entry': 'toy', 'warmup_frames_after_swap': 2, 'check_frames': 4,
        'trace_slice': [0.4, 0.1], 'control': 'bfloat16'})


@pytest.mark.parametrize('fault, control, correct, failed', [
    (None, True, True, 0),
    ('number', False, False, 1),
    ('level', False, False, 0),
])
def test_a_toy_entry_is_judged_by_its_own_verdict(monkeypatch, fault,
                                                  control, correct, failed):
    entry = type('ToyEntry', (Toy,), {'fault': fault})
    monkeypatch.setattr(harness, 'driver_class', lambda name: entry)
    r = harness.run(toy_cell(), 313131, 0.5, False, 'cpu',
                    time.perf_counter(), control=control, tile_frames=6)
    assert r['correct'] is correct, r['_reasons']
    assert r['failed'] == failed
    assert set(r['checks']) == {'level_gap', 'failed_frames'}
    assert r['checks']['failed_frames'] == {'value': failed, 'limit': 0}
    assert r['_sampled_frames'] == 4
    assert r['_extras'] == {'lag': LAG}
    assert r['attempted'] > 3
    if fault == 'level':
        assert r['checks']['level_gap']['value'] >= 0.4
    if control:
        assert not r['_control']['correct']
        assert r['_control']['level_gap'] > 3 * r['checks']['level_gap'][
            'value']


def test_the_harness_holds_no_entry_s_comparison():
    """The decode's reference, judge and frame fields are its entry's:
    the harness neither imports nor names them."""
    with open(os.path.join(harness.BENCH_DIR, 'harness.py')) as f:
        text = f.read()
    for word in ('ldbench.reference', 'picture_fields', 'carries',
                 'Reference', 'framenr'):
        assert word not in text, word
