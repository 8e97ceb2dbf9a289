"""The readers of the program's spans (`ldbench/program_spans.py` and the
metrics that use it), on a hand-made traced run whose answers can be
worked out by hand, on the CPU.

    python -m pytest ldbench/tests/test_ldbench_spans.py -q
"""

import sys
from types import SimpleNamespace

import pytest

from ldbench import harness
from ld_decode_tpu_torch.utils import spans

BASE_NS = 1_760_000_000_000_000_000      # Unix-epoch nanoseconds
MS = 1_000                               # a millisecond in microseconds

# (name, start, end, parent) in microseconds from BASE_NS; frame numbers
# follow the root frames
RECORDS = [
    ('frame', 0, 100 * MS, -1),                         # 0
    ('segment.swap', 10 * MS, 70 * MS, 0),              # 1
    ('load.read', 10 * MS, 30 * MS, 1),
    ('load.unpack', 30 * MS, 40 * MS, 1),
    ('segment.convert', 40 * MS, 55 * MS, 1),
    ('segment.copy', 55 * MS, 69 * MS, 1),
    ('prefetch.refill', 70 * MS, 90 * MS, 0),           # 6
    ('prefetch.dispatch', 70 * MS, 75 * MS, 6),
    ('prefetch.fetch', 75 * MS, 85 * MS, 6),
    ('prefetch.unpack', 85 * MS, 88 * MS, 6),
    ('frame.weave', 90 * MS, 95 * MS, 0),
    ('frame', 110 * MS, 140 * MS, -1),                  # 11
    ('prefetch.dispatch', 112 * MS, 115 * MS, 11),
    ('frame.weave', 120 * MS, 122 * MS, 11),
    ('frame', 150 * MS, 350 * MS, -1),                  # 14
    ('segment.swap', 160 * MS, 300 * MS, 14),           # 15
    ('load.read', 160 * MS, 200 * MS, 15),
    ('load.unpack', 200 * MS, 220 * MS, 15),
    ('load.unpack', 220 * MS, 230 * MS, 15),
    ('segment.convert', 230 * MS, 260 * MS, 15),
    ('segment.copy', 260 * MS, 300 * MS, 15),
    ('prefetch.refill', 300 * MS, 340 * MS, 14),        # 21
    ('prefetch.dispatch', 300 * MS, 307 * MS, 21),
    ('frame', 400 * MS, 410 * MS, -1),
]

# device operations (start, end, name) in microseconds on the same clock:
# inside the swaps and refills they cover 10 + 15 + 5 + 50 ms
OPS = [(0, 20 * MS, 'a'), (50 * MS, 60 * MS, 'b'), (55 * MS, 65 * MS, 'c'),
       (85 * MS, 95 * MS, 'd'), (200 * MS, 250 * MS, 'e'),
       (500 * MS, 600 * MS, 'f')]

# by hand: swaps 60 and 140 ms; unpack 10 and 20 + 10; convert 15 and 30;
# copy 14 and 40; dispatches 5, 3, 7; frames' self 100 - 85, 30 - 5,
# 200 - 180, 10; frames cover 340 of 1000 ms; the swaps and refills
# [10, 90] and [160, 340] ms, 260 ms, the device busy 80 ms of it
WANT = {'segment.swap_ms': 100.0, 'segment.unpack_ms': 20.0,
        'segment.convert_ms': 22.5, 'segment.copy_ms': 27.0,
        'prefetch.dispatch_ms': 5.0, 'frame.self_ms': 17.5,
        'frame.outside_share': 0.66, 'segment.idle_share': 0.18}


def _records():
    out, frame, root = [], -1, 0
    for name, a, b, parent in RECORDS:
        if name == 'frame' and parent < 0:
            frame = root
            root += 1
        elif parent < 0:
            frame = -1
        out.append((name, BASE_NS + a * 1000, BASE_NS + b * 1000, parent,
                    frame))
    return out


def _run(trace=True):
    t = {'window_s': 1.0, 'busy_s': 0.0,
         'ops': [(BASE_NS / 1e3 + a, BASE_NS / 1e3 + b, n)
                 for a, b, n in OPS]} if trace else None
    return SimpleNamespace(window_s=1.0, before={}, after={}, cell={},
                           trace=t)


@pytest.fixture
def recorded(monkeypatch):
    monkeypatch.setattr(spans, 'records', _records)


@pytest.mark.parametrize('name', sorted(WANT))
def test_each_reader_by_hand(recorded, name):
    got = harness.metric_reader(name)(_run())
    assert got == pytest.approx(WANT[name], rel=1e-9, abs=1e-9)


@pytest.mark.parametrize('name', sorted(WANT))
def test_no_trace_or_no_record_reads_none(monkeypatch, name):
    read = harness.metric_reader(name)
    monkeypatch.setattr(spans, 'records', _records)
    assert read(_run(trace=False)) is None
    monkeypatch.setattr(spans, 'records', lambda: [])
    assert read(_run()) is None


@pytest.mark.parametrize('name', sorted(WANT))
def test_a_program_without_spans_reads_none(monkeypatch, name):
    """An older commit of the program has no spans module: the readers
    read nothing and raise nothing."""
    import ld_decode_tpu_torch.utils as U
    read = harness.metric_reader(name)
    monkeypatch.setattr(spans, 'records', _records)
    assert read(_run()) is not None
    monkeypatch.delattr(U, 'spans')
    monkeypatch.setitem(sys.modules, 'ld_decode_tpu_torch.utils.spans',
                        None)
    with pytest.raises(ImportError):
        from ld_decode_tpu_torch.utils import spans as _  # noqa: F401
    assert read(_run()) is None


def test_a_slice_without_a_swap(monkeypatch):
    """A slice in which no segment swapped has no swap reading; the
    frame readers still read."""
    keep = [r for r in _records()[11:14]]
    monkeypatch.setattr(spans, 'records',
                        lambda: [(n, a, b, p - 11 if p >= 0 else -1, f)
                                 for n, a, b, p, f in keep])
    run = _run()
    for name in ('segment.swap_ms', 'segment.unpack_ms', 'segment.copy_ms',
                 'segment.convert_ms', 'segment.idle_share'):
        assert harness.metric_reader(name)(run) is None
    assert harness.metric_reader('frame.self_ms')(run) == pytest.approx(25.0)
    assert harness.metric_reader('frame.outside_share')(run) \
        == pytest.approx(0.97)


def test_the_program_records_what_the_readers_read():
    """The program's own spans under a profiler give records the readers
    take: a swap with its parts, read in order."""
    import torch
    spans.reset()
    try:
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]):
            with spans.span('frame'):
                with spans.span('segment.swap'):
                    for part in ('load.read', 'load.unpack',
                                 'segment.convert', 'segment.copy'):
                        with spans.span(part):
                            torch.ones(1000).sum()
        run = SimpleNamespace(window_s=1.0, before={}, after={}, cell={},
                              trace={'window_s': 1.0, 'ops': []})
        swap = harness.metric_reader('segment.swap_ms')(run)
        parts = sum(harness.metric_reader(n)(run) for n in (
            'segment.unpack_ms', 'segment.convert_ms', 'segment.copy_ms'))
        assert 0 < parts < swap
        # no device operation: the swap is idle throughout (to the
        # quarter microsecond of an epoch time in microseconds)
        assert harness.metric_reader('segment.idle_share')(run) \
            == pytest.approx(swap / 1e3, abs=1e-6)
    finally:
        spans.reset()
