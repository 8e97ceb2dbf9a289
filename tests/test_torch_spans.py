"""PyTorch port: the spans (utils/spans.py) and the decode's spans at its
layer boundaries.

Off (no torch profiler running), a span keeps its name's count, total and
self time, and nothing else.  Under torch.profiler it also opens a
record_function and keeps a record on the profiler's own clock.  A
segmented decode (the smallest segment over a small .lds file, as in
tests/test_torch_segmented.py) gives each swap one `segment.swap` with the
read, the unpack, the conversion and the copy inside it, and the decode's
timers are readings of their spans.  The chain's comb and CX expander, as
ldchain_torch.py -F runs them, open `comb.feed` (holding `comb.levels`
and `comb.replay`) a window fed, `comb.collect` a window collected and
`cx.process` a frame, and touch nothing more with no profiler.  The card
test checks the shared clock against the device's own copy of a swap."""

import io
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
SWAP_PARTS = ['load.read', 'load.unpack', 'segment.convert', 'segment.copy']


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


# ---------------------------------------------------------------------------
# the decode


@pytest.fixture(scope='module')
def segmented(tmp_path_factory):
    """A segmented decode of 8 frames of a 12-frame .lds file at the
    smallest segment (8 frames cross a swap), under torch.profiler, on a
    host of four usable cores: the records, the totals, the prefetcher's
    stats, the unpack seconds it added, the number of segment loads, the
    native unpacks (start and end on the spans' clock, threads) and the
    split unpacks counted."""
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
    out = dict(records=S.records(), totals=S.totals(), stats=dict(pf.stats),
               unpack=TL.unpack_seconds[route] - before, loads=len(loads),
               frames=frames, unpacks=unpacks,
               split=TL.unpack_threads['split'] - split)
    S.reset()
    return out


def test_each_swap_is_one_span_with_its_parts(segmented):
    recs = segmented['records']
    swaps = [k for k, r in enumerate(recs) if r[0] == 'segment.swap']
    assert len(swaps) == segmented['loads'] >= 2
    for k in swaps:
        assert recs[recs[k][3]][0] == 'frame'
        parts = sorted(r[0] for r in recs if r[3] == k)
        assert parts == SWAP_PARTS
    # every span of the decode lies in one of its frames, numbered in turn
    assert sorted({r[4] for r in recs}) == list(range(segmented['frames']))
    names = {r[0] for r in recs}
    assert {'frame', 'frame.weave', 'prefetch.refill', 'prefetch.dispatch',
            'prefetch.fetch', 'prefetch.unpack'} <= names
    for name in ('prefetch.fetch', 'prefetch.unpack', 'prefetch.dispatch'):
        assert {recs[r[3]][0] for r in recs if r[0] == name} \
            <= {'frame', 'prefetch.refill'}


def test_each_swap_unpacks_on_threads_inside_its_span(segmented):
    """Every swap's segment (over twice MIN_GROUPS_PER_THREAD groups) is
    unpacked split across the four cores, and its `load.unpack` span holds
    the whole threaded call."""
    recs = segmented['records']
    spans_ = [(a, b) for name, a, b, _, _ in recs if name == 'load.unpack']
    assert TL.unpack_route() == 'native'
    assert len(spans_) == len(segmented['unpacks']) == segmented['loads']
    assert segmented['split'] == segmented['loads']
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
