"""PyTorch port: the spans (utils/spans.py) and the decode's spans at its
layer boundaries.

Off (no torch profiler running), a span keeps its name's count, total and
self time, and nothing else.  Under torch.profiler it also opens a
record_function and keeps a record on the profiler's own clock.  A
segmented decode (the smallest segment over a small .lds file, as in
tests/test_torch_segmented.py) gives each swap one `segment.swap`: the
first with the read, the unpack, the fill of the staging buffer, the
conversion and the copy inside it, each later one the wait for the read
ahead and the take of its samples; the read ahead's read, unpack and fill
lie under a root `segment.readahead` of the worker's thread.  The
decode's timers are readings of their spans.  Spans opened on two threads
at once each nest under their own thread's, and the span metrics of the
read ahead read hand-made records.  The chain's comb and CX expander, as
ldchain_torch.py -F runs them, open `comb.feed` (holding `comb.levels`
and `comb.replay`) a window fed, `comb.collect` a window collected and
`cx.process` a frame, and touch nothing more with no profiler.  The card
test checks the shared clock against the device's own copy of a swap."""

import io
import sys
import threading
import time

import numpy as np
import pytest
import torch

from ld_decode_tpu_torch.io import loaders as TL
from ld_decode_tpu_torch.io import native_unpack as TNU
from ld_decode_tpu_torch.models import encode as TE
from ld_decode_tpu_torch.ops import filters as TF
from ld_decode_tpu_torch.tbc import cuda_widen as TCW
from ld_decode_tpu_torch.tbc import framer as TFR
from ld_decode_tpu_torch.utils import spans as S
from ld_decode_tpu_torch.utils.params import DecoderConfig
from ld_decode_tpu_torch.utils.spans import span

torch.set_num_threads(2)

CPU = [torch.profiler.ProfilerActivity.CPU]
START = 33046
LOAD_PARTS = ['load.read', 'load.unpack', 'segment.fill']
SWAP_PARTS = sorted(LOAD_PARTS + ['segment.convert', 'segment.copy'])
TAKE_PARTS = ['segment.convert', 'segment.copy']


@pytest.fixture(autouse=True)
def fresh():
    S.reset()
    yield
    S.reset()


def _walls(recs):
    """Each record's wall time and the wall time of its direct children,
    ns."""
    wall = [b - a for _, a, b, _, _ in recs]
    child = [0] * len(recs)
    for k, r in enumerate(recs):
        if r[3] >= 0:
            child[r[3]] += wall[k]
    return wall, child


def _totals_from(recs):
    out = {}
    wall, child = _walls(recs)
    for k, r in enumerate(recs):
        n, tot, own = out.get(r[0], (0, 0, 0))
        out[r[0]] = (n + 1, tot + wall[k], own + wall[k] - child[k])
    return out


def test_nesting_self_time_parents_and_frames():
    """Records nest as the spans did, a frame's number is shared by what it
    holds (a frame inside a frame keeps it), and the totals are the sums
    of the records: total the wall time, self the wall time less the
    direct children."""
    with torch.profiler.profile(activities=CPU):
        with span('frame'):
            with span('a'):
                time.sleep(0.002)
                with span('b'):
                    time.sleep(0.003)
            with span('c'):
                time.sleep(0.001)
        with span('frame'):
            with span('frame'):
                with span('a'):
                    pass
        with span('outside'):
            pass
    recs = S.records()
    assert [r[0] for r in recs] == ['frame', 'a', 'b', 'c', 'frame', 'frame',
                                    'a', 'outside']
    assert [r[3] for r in recs] == [-1, 0, 1, 0, -1, 4, 5, -1]
    assert [r[4] for r in recs] == [0, 0, 0, 0, 1, 1, 1, -1]
    for name, a, b, parent, _ in recs:
        assert a <= b
        if parent >= 0:
            assert recs[parent][1] <= a and b <= recs[parent][2]
    assert recs[2][2] - recs[2][1] >= 3e6
    assert recs[1][2] - recs[1][1] >= 5e6
    tot = S.totals()
    assert set(tot) == {'frame', 'a', 'b', 'c', 'outside'}
    for name, (n, total, own) in _totals_from(recs).items():
        assert tot[name][0] == n
        assert tot[name][1] == pytest.approx(total * 1e-9, rel=1e-12)
        assert tot[name][2] == pytest.approx(own * 1e-9, rel=1e-12)
    # 'b' has no child; 'a' holds 'b'
    assert tot['b'][2] == tot['b'][1]
    assert tot['a'][2] == pytest.approx(tot['a'][1] - tot['b'][1],
                                        rel=1e-12)


def test_off_keeps_totals_only(monkeypatch):
    """Without a profiler a span opens no record_function and keeps no
    record, and calls no operator; its totals are kept all the same."""
    from torch.utils._python_dispatch import TorchDispatchMode
    import torch.autograd.profiler as AP

    def refused(name):
        raise AssertionError(f'record_function({name!r}) with no profiler')

    monkeypatch.setattr(AP, 'record_function', refused)
    ops = []

    class Seen(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            ops.append(func)
            return func(*args, **(kwargs or {}))

    with Seen():
        with span('outer') as outer:
            with span('inner') as inner:
                time.sleep(0.001)
    assert ops == []
    assert S.records() == []
    tot = S.totals()
    assert tot['outer'][0] == tot['inner'][0] == 1
    assert inner.seconds >= 1e-3 and outer.seconds >= inner.seconds
    assert tot['inner'][1] == inner.seconds
    assert tot['outer'][2] == pytest.approx(outer.seconds - inner.seconds,
                                            rel=1e-12)


def test_on_each_span_is_a_record_and_an_event_on_one_clock():
    """Under torch.profiler every span is one record and one event of the
    profiler's, and the record starts and ends within 0.5 ms of the
    event: the records are on the trace's clock."""
    names = [f'span{k}' for k in range(12)]
    with torch.profiler.profile(activities=CPU) as prof:
        for k, name in enumerate(names):
            with span(name):
                x = torch.ones(64) * k
                if k % 3 == 0:
                    time.sleep(0.002)
                    with span(name + '.inner'):
                        x.add_(1)
    recs = S.records()
    events = {}
    for e in prof.profiler.kineto_results.events():
        events.setdefault(e.name(), []).append(e)
    assert len(recs) == len(names) + 4
    for name, a, b, _, _ in recs:
        assert len(events.get(name, [])) == 1, name
        e = events[name][0]
        assert abs(a - e.start_ns()) < 0.5e6, name
        assert abs(b - e.end_ns()) < 0.5e6, name


def test_the_ring_keeps_the_last_records():
    """Past RING records the oldest go, a span that outlived its place in
    the ring among them; a record whose parent went says -1.  The totals
    keep every span."""
    with torch.profiler.profile(activities=CPU):
        with span('outer'):
            for _ in range(S.RING + 5):
                with span('x'):
                    pass
    recs = S.records()
    assert len(recs) == S.RING
    assert all(r[0] == 'x' and r[3] == -1 for r in recs)
    assert S.totals()['x'][0] == S.RING + 5
    assert S.totals()['outer'][0] == 1


def test_spans_on_two_threads_nest_under_their_own_thread():
    """A worker opens spans while the decode's thread has its own open:
    each nests under its own thread's open span (the worker's root says
    -1 and lies in no frame), the decode's frames keep their numbers in
    turn, and the totals and the ring hold every span exactly."""
    opened, go_on = threading.Event(), threading.Event()

    def worker():
        with span('w.root'):
            with span('w.inner'):
                opened.set()
                assert go_on.wait(10)
            with span('w.after'):
                pass

    with torch.profiler.profile(activities=CPU):
        with span('frame'):
            with span('a'):
                t = threading.Thread(target=worker)
                t.start()
                assert opened.wait(10)
                with span('b'):
                    pass
                go_on.set()
                t.join(10)
            with span('c'):
                pass
        with span('frame'):
            with span('d'):
                pass
    assert not t.is_alive()
    recs = S.records()
    at = {r[0]: k for k, r in enumerate(recs)}
    assert len(recs) == len(at) + 1 == 9
    assert [r[0] for r in recs if r[0] != 'frame'] == [
        'a', 'w.root', 'w.inner', 'b', 'w.after', 'c', 'd']
    parent = {r[0]: (recs[r[3]][0] if r[3] >= 0 else None) for r in recs}
    assert parent == {'frame': None, 'a': 'frame', 'b': 'a', 'c': 'frame',
                      'd': 'frame', 'w.root': None, 'w.inner': 'w.root',
                      'w.after': 'w.root'}
    frame = {r[0]: r[4] for r in recs if r[0] != 'frame'}
    assert frame == {'a': 0, 'b': 0, 'c': 0, 'd': 1, 'w.root': -1,
                     'w.inner': -1, 'w.after': -1}
    assert [r[4] for r in recs if r[0] == 'frame'] == [0, 1]
    tot = S.totals()
    for name, (n, total, own) in _totals_from(recs).items():
        assert tot[name][0] == n
        assert tot[name][1] == pytest.approx(total * 1e-9, rel=1e-12)
        assert tot[name][2] == pytest.approx(own * 1e-9, rel=1e-12)
    # the worker's spans cover none of the decode's: 'a' less 'b' alone
    assert tot['a'][2] == pytest.approx(tot['a'][1] - tot['b'][1],
                                        rel=1e-12)


def test_spans_on_many_threads_lose_no_count_or_record():
    """Twelve threads (more than the cores a test worker has) open nested
    spans at once under a short switch interval: every count, record and
    parent is exact."""
    threads, each = 12, 150
    errors = []

    def worker(i):
        try:
            for _ in range(each):
                with span(f't{i}'):
                    with span(f't{i}.in'):
                        pass
        except Exception as e:          # reported by the test below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with torch.profiler.profile(activities=CPU):
            pool = [threading.Thread(target=worker, args=(i,))
                    for i in range(threads)]
            for t in pool:
                t.start()
            for t in pool:
                t.join(60)
    finally:
        sys.setswitchinterval(old)
    assert not errors and not any(t.is_alive() for t in pool)
    recs = S.records()
    assert len(recs) == 2 * threads * each
    tot = S.totals()
    for i in range(threads):
        assert tot[f't{i}'][0] == tot[f't{i}.in'][0] == each
    for name, _, _, p, frame in recs:
        assert frame == -1
        if name.endswith('.in'):
            assert recs[p][0] == name[:-3]
        else:
            assert p == -1


def test_the_debug_line_counts_the_swaps_that_took_the_read_ahead(capsys):
    """`lddecode_torch.py -d` says how many segment swaps took the samples
    read ahead: the `segment.take` spans of the `segment.swap` spans."""
    import lddecode_torch
    from ld_decode_tpu_torch.utils import log
    for took in (False, True, True):
        with span('segment.swap'):
            if took:
                with span('segment.take'):
                    pass
    level = log.get_level()
    try:
        log.set_level(log.DEBUG)
        lddecode_torch.log_spans()
    finally:
        log.set_level(level)
    assert 'segment read-ahead: 2 of 3 swaps took it' \
        in capsys.readouterr().err


def _ahead_records(hit_wait_ms=4, miss_wait_ms=10):
    """Hand-made records of two swaps, one a hit (its wait, then the take
    of the staged samples) and one a miss (its wait for a read that staged
    other samples, then the load on the decode's thread), and the two read
    aheads on the worker's thread, in ms from an epoch base."""
    base, ms = 1_760_000_000_000_000_000, 1_000_000
    rows = [('frame', 0, 100, -1, 0),                     # 0
            ('segment.swap', 10, 40, 0, 0),               # 1: a hit
            ('segment.wait', 10, 10 + hit_wait_ms, 1, 0),
            ('segment.take', 20, 40, 1, 0),               # 3
            ('segment.copy', 20, 21, 3, 0),
            ('segment.convert', 21, 22, 3, 0),
            ('segment.readahead', 41, 300, -1, -1),       # 6
            ('load.read', 41, 100, 6, -1),
            ('load.unpack', 100, 250, 6, -1),
            ('segment.fill', 250, 300, 6, -1),
            ('frame', 400, 800, -1, 1),                   # 10
            ('segment.swap', 410, 700, 10, 1),            # 11: a miss
            ('segment.wait', 410, 410 + miss_wait_ms, 11, 1),
            ('load.read', 430, 500, 11, 1),
            ('load.unpack', 500, 650, 11, 1),
            ('segment.fill', 650, 680, 11, 1),
            ('segment.copy', 680, 690, 11, 1),
            ('segment.convert', 690, 700, 11, 1)]
    return [(n, base + a * ms, base + b * ms, p, f)
            for n, a, b, p, f in rows]


def test_the_read_ahead_metrics_read_a_hit_and_a_miss(monkeypatch):
    """segment.wait_ms is the median of the swaps' waits; readahead_share
    the share of swaps that took staged samples; both read nothing
    without a trace, and nothing from a program with no read ahead (its
    swaps hold no wait and no take, and no read runs ahead)."""
    from types import SimpleNamespace
    from ldbench import harness
    wait = harness.metric_reader('segment.wait_ms')
    share = harness.metric_reader('segment.readahead_share')
    run = SimpleNamespace(window_s=1.0, before={}, after={}, cell={},
                          trace={'window_s': 1.0, 'busy_s': 0.0, 'ops': []})
    monkeypatch.setattr(S, 'records', _ahead_records)
    assert wait(run) == pytest.approx(7.0)
    assert share(run) == pytest.approx(0.5)
    monkeypatch.setattr(S, 'records', lambda: _ahead_records(4, 1)[:10])
    assert wait(run) == pytest.approx(4.0)
    assert share(run) == pytest.approx(1.0)
    bare = SimpleNamespace(**dict(run.__dict__, trace=None))
    assert wait(bare) is None and share(bare) is None
    # the parent's swap: the load on the decode's thread, nothing ahead
    parent = [r for r in _ahead_records()[10:] if r[0] != 'segment.wait']
    parent = [(n, a, b, p - 10 if p >= 0 else -1, f)
              for n, a, b, p, f in parent]
    parent = [(n, a, b, p - 1 if p > 1 else p, f)
              for n, a, b, p, f in parent]
    monkeypatch.setattr(S, 'records', lambda: parent)
    assert [r[0] for r in parent[:2]] == ['frame', 'segment.swap']
    assert all(r[3] == 1 for r in parent[2:])
    assert wait(run) is None
    assert share(run) is None


# ---------------------------------------------------------------------------
# the decode


@pytest.fixture(scope='module')
def segmented(tmp_path_factory):
    """A segmented decode of 8 frames of a 12-frame .lds file at the
    smallest segment (8 frames cross a swap), under torch.profiler, on a
    host of four usable cores, the Framer closed at its end: the records,
    the totals, the prefetcher's stats, the unpack seconds it added, the
    number of segment loads (swaps), the native unpacks (start and end on
    the spans' clock, threads), the split unpacks counted and whether
    the last segment reaches the file's end."""
    cfg = DecoderConfig(system='NTSC', freq_mhz=40.0)
    samples = TE.encode_frames(cfg, 12, TE.EncodeSpec(pattern='ramp',
                                                      cav_start_frame=900))
    path = tmp_path_factory.mktemp('spans') / 'cap.lds'
    path.write_bytes(TL.pack_data_4_40(samples).tobytes())
    bank = TF.make_demod_bank(cfg, device='cpu')
    fr = TFR.Framer(cfg, bank, TL.loader_for_path(str(path)), batch=2,
                    segment_samples=1, device='cpu')
    pf = fr.prefetcher
    loads = []
    set_capture = pf.set_capture

    def counted(*a, **k):
        loads.append(a[1])
        return set_capture(*a, **k)

    pf.set_capture = counted
    unpacks = []
    unpack = TNU.unpack_4_40

    def stamped(raw, readlen, offset):
        t0 = time.perf_counter_ns() + S._OFFSET_NS
        out = unpack(raw, readlen, offset)
        unpacks.append((t0, time.perf_counter_ns() + S._OFFSET_NS,
                        TNU.last_threads))
        return out

    route = TL.unpack_route()
    S.reset()
    before = TL.unpack_seconds[route]
    split = TL.unpack_threads['split']
    s, frames = START, 0
    with pytest.MonkeyPatch.context() as mp, \
            torch.profiler.profile(activities=CPU), open(path, 'rb') as fd:
        mp.setattr(TNU, 'unpack_4_40', stamped)
        mp.setattr(TNU.os, 'sched_getaffinity', lambda pid: set(range(4)))
        mp.setattr(TNU, 'quota_cpus', lambda: None)
        for i in range(8):
            rv = fr.readframe(fd, s, i == 0)
            assert rv[0] is not None
            s, frames = rv[2], frames + 1
        fr.close()
    out = dict(records=S.records(), totals=S.totals(), stats=dict(pf.stats),
               unpack=TL.unpack_seconds[route] - before, loads=len(loads),
               frames=frames, unpacks=unpacks,
               split=TL.unpack_threads['split'] - split,
               eof=fr._seg_eof)
    S.reset()
    return out


def _kids(recs, k):
    return sorted(r[0] for r in recs if r[3] == k)


def test_each_swap_is_one_span_with_its_parts(segmented):
    """The first swap loads on the decode's thread; every later one waits
    for the read ahead and takes its samples; each read ahead is a root
    span of the worker's thread, outside every frame, holding the
    loader's read and unpack and the fill of the staging buffer."""
    recs = segmented['records']
    swaps = [k for k, r in enumerate(recs) if r[0] == 'segment.swap']
    assert len(swaps) == segmented['loads'] >= 2
    assert segmented['totals']['segment.take'][0] == len(swaps) - 1
    for i, k in enumerate(swaps):
        assert recs[recs[k][3]][0] == 'frame'
        if i == 0:
            assert _kids(recs, k) == SWAP_PARTS
            continue
        assert [r[0] for r in recs if r[3] == k] == ['segment.wait',
                                                      'segment.take']
        take = next(j for j, r in enumerate(recs)
                    if r[3] == k and r[0] == 'segment.take')
        assert _kids(recs, take) == TAKE_PARTS
    ahead = [k for k, r in enumerate(recs) if r[0] == 'segment.readahead']
    # one a swap but the last, whose segment reaches the file's end
    assert segmented['eof'] and len(ahead) == len(swaps) - 1
    for k in ahead:
        assert recs[k][3] == -1 and recs[k][4] == -1
        assert _kids(recs, k) == LOAD_PARTS
        assert {recs[j][4] for j, r in enumerate(recs) if r[3] == k} == {-1}
    # every other span of the decode lies in one of its frames, numbered
    # in turn
    worker = set(ahead) | {j for j, r in enumerate(recs) if r[3] in ahead}
    assert sorted({r[4] for j, r in enumerate(recs) if j not in worker}) \
        == list(range(segmented['frames']))
    names = {r[0] for r in recs}
    assert {'frame', 'frame.weave', 'prefetch.refill', 'prefetch.dispatch',
            'prefetch.fetch', 'prefetch.unpack'} <= names
    for name in ('prefetch.fetch', 'prefetch.unpack', 'prefetch.dispatch'):
        assert {recs[r[3]][0] for r in recs if r[0] == name} \
            <= {'frame', 'prefetch.refill'}


def test_each_swap_unpacks_on_threads_inside_its_span(segmented):
    """Every segment read (over twice MIN_GROUPS_PER_THREAD groups: the
    first swap's and each read ahead's) is unpacked split across the four
    cores, and its `load.unpack` span holds the whole threaded call."""
    recs = segmented['records']
    spans_ = [(a, b) for name, a, b, _, _ in recs if name == 'load.unpack']
    reads = 1 + sum(1 for r in recs if r[0] == 'segment.readahead')
    assert TL.unpack_route() == 'native'
    assert len(spans_) == len(segmented['unpacks']) == reads
    assert segmented['split'] == reads >= 2
    for (a, b), (t0, t1, threads) in zip(spans_, segmented['unpacks']):
        assert threads == 4
        assert a <= t0 <= t1 <= b


def test_the_timers_read_their_spans(segmented):
    """stats' t_dispatch, t_fetch and t_unpack and the loader's
    unpack_seconds are the totals of the spans that bracket their code."""
    st, tot = segmented['stats'], segmented['totals']
    assert st['batches'] == tot['prefetch.dispatch'][0] > 0
    for key, name in (('t_dispatch', 'prefetch.dispatch'),
                      ('t_fetch', 'prefetch.fetch'),
                      ('t_unpack', 'prefetch.unpack')):
        assert st[key] == pytest.approx(tot[name][1], rel=1e-9), key
    assert segmented['unpack'] == pytest.approx(tot['load.unpack'][1],
                                                rel=1e-9)
    assert st['refills'] == tot['prefetch.refill'][0]
    assert 'skips' not in st and 'cache_hits' not in st


# ---------------------------------------------------------------------------
# the chain's comb and CX


def _chain_frames(n: int) -> np.ndarray:
    """n seeded 525 x 910 frames with a burst phase flag (column 0) and a
    burst level over 3 IRE (column 1) on every line."""
    rng = np.random.default_rng(17)
    fr = rng.integers(20000, 40000, (n, 525, 910)).astype(np.uint16)
    fr[:, :, 0] = np.where(np.arange(525) % 2 == 0, 16384, 32768)
    fr[:, :, 1] = 7168
    return fr


def _run_chain(n: int = 7):
    """The -F comb through CombWindows (windows of 3 frames, 1 in flight)
    and CX on each frame's audio, as ldchain_torch.py runs them: (the comb,
    the RGB frames emitted)."""
    from ld_decode_tpu_torch.audio.cx import CXExpander
    from ld_decode_tpu_torch.comb import batch as TB
    from ld_decode_tpu_torch.comb.comb_ntsc import CombConfig
    comb = TB.NTSCCombBatch(CombConfig(dim=3, opticalflow=False),
                            device='cpu', graphs=False)
    out = []
    loop = TB.CombWindows(comb, 3, 1, lambda rgb, words: out.append(rgb))
    cx = CXExpander(device='cpu')
    audio = np.random.default_rng(5).integers(-3000, 3000, 3204
                                              ).astype(np.int16)
    for f in _chain_frames(n):
        loop.push(f)
        cx.process(audio)
    loop.drain()
    return comb, out


def test_comb_and_cx_spans_nest_and_count():
    """`comb.feed` (one a window fed) holds `comb.levels` and then
    `comb.replay`; `comb.collect` opens once a window collected, outside
    the feeds; `cx.process` once a frame; the comb's counters are the
    frames fed and emitted and its timers the totals of its spans."""
    with torch.profiler.profile(activities=CPU):
        comb, out = _run_chain()
    recs, tot, st = S.records(), S.totals(), comb.stats
    feeds = [k for k, r in enumerate(recs) if r[0] == 'comb.feed']
    # 7 frames in windows of 3: fed 3, 3 and 1 (the drain)
    assert len(feeds) == 3
    for k in feeds:
        assert recs[k][3] == -1
        kids = [r[0] for r in recs if r[3] == k]
        assert kids in (['comb.levels', 'comb.replay'], []), kids
    assert sum(1 for r in recs if r[3] in feeds) == 2 * st['windows']
    collects = [r for r in recs if r[0] == 'comb.collect']
    assert len(collects) == st['windows'] == 3
    assert all(r[3] == -1 for r in collects)
    assert sum(1 for r in recs if r[0] == 'cx.process') == 7
    assert st['frames_fed'] == 7
    # the ring emits frames 1..5 (frame 0 opens it, frame 6 closes it)
    assert st['frames_emitted'] == len(out) == 5
    assert st['t_collect'] == pytest.approx(tot['comb.collect'][1],
                                            rel=1e-9)
    assert tot['comb.feed'][1] >= tot['comb.levels'][1] \
        + tot['comb.replay'][1]


def test_comb_and_cx_spans_touch_nothing_off(monkeypatch):
    """With no profiler the chain's spans open no record_function, keep no
    record and add no operator: the comb dispatches the same operators
    with its spans as with spans that do nothing."""
    from torch.utils._python_dispatch import TorchDispatchMode
    import torch.autograd.profiler as AP
    from ld_decode_tpu_torch.audio import cx as TCX
    from ld_decode_tpu_torch.comb import batch as TB

    def refused(name):
        raise AssertionError(f'record_function({name!r}) with no profiler')

    class Seen(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.ops.append(str(func))
            return func(*args, **(kwargs or {}))

    # a first run builds what every later one reuses (filter designs,
    # tensors made once), so both compared runs come after it
    _run_chain(5)
    S.reset()
    monkeypatch.setattr(AP, 'record_function', refused)
    with Seen() as on:
        _, out_on = _run_chain(5)
    assert S.records() == []
    assert S.totals()['comb.collect'][0] == 2
    assert S.totals()['cx.process'][0] == 5

    class Nothing:
        seconds = 0.0

        def __init__(self, name):
            pass

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(TB, 'span', Nothing)
    monkeypatch.setattr(TCX, 'span', Nothing)
    with Seen() as off:
        _, out_off = _run_chain(5)
    assert on.ops == off.ops and len(on.ops) > 0
    for a, b in zip(out_on, out_off):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# the card


@pytest.mark.cuda
def test_card_a_swaps_copy_starts_inside_its_copy_span():
    """On the card a swap reads and unpacks the samples, copies them as
    they are (128 M samples, 256 MiB of uint16) and widens them there: its
    parts come in that order; the pageable copy starts on the device
    inside the host's `segment.copy` record, each of the widening kernel's
    launches inside or after its `segment.convert` record; the spans and
    the swap allocate nothing on the card."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    n = 128 << 20
    out = torch.empty(n, dtype=torch.float32, device='cuda')
    lds = io.BytesIO(TL.pack_data_4_40(
        (np.arange(n) % 1024).astype(np.uint16)).tobytes())
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    acts = CPU + [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(3):
            with span('segment.swap'):
                samples = TL.load_packed_4_40(lds, 0, n)
                TFR.to_device_capture(samples, 'cuda', out=out)
        torch.cuda.synchronize()
    assert torch.cuda.memory_allocated() == held
    recs = S.records()
    swaps = [k for k, r in enumerate(recs) if r[0] == 'segment.swap']
    assert len(swaps) == 3
    for k in swaps:
        parts = sorted((r[1], r[0]) for r in recs if r[3] == k)
        assert [name for _, name in parts] == [
            'load.read', 'load.unpack', 'segment.copy', 'segment.convert']
    copies = [(a, b) for name, a, b, _, _ in recs if name == 'segment.copy']
    converts = sorted(a for name, a, _, _, _ in recs
                      if name == 'segment.convert')
    from torch.autograd import DeviceType
    dev = [e for e in prof.profiler.kineto_results.events()
           if e.device_type() == DeviceType.CUDA]
    memcpy = [e for e in dev if 'Memcpy HtoD' in e.name()
              and e.end_ns() - e.start_ns() > 10e6]
    assert len(copies) == 3 and len(memcpy) >= 3
    for e in memcpy:
        assert any(a <= e.start_ns() <= b for a, b in copies), e.name()
    # each kernel launch belongs to the last convert record that began
    # before it started: every record gets its own swap's launches
    widen = [e.start_ns() for e in dev if 'widen_kernel' in e.name()]
    per = len(TCW.widen_schedule(n, 2)) - 1
    assert len(widen) == 3 * per
    owner = [sum(a <= t for a in converts) - 1 for t in widen]
    assert sorted(owner) == [0] * per + [1] * per + [2] * per
