"""PyTorch port, the segmented decode: a sliding device-resident window over
an .lds file too large to keep resident (tests/test_segmented.py), against
the port's whole-capture decode and against the JAX package's segmented
decode of the same file.

Budgets: CAV numbers, next samples, line-0 words and seek positions exact;
the segmented frames within p99.9 <= 2 LSB of the resident ones (rows
24+, the JAX package's own budget between its two paths) and within
tests/torch_parity.py's picture budget of the JAX package's.  The decode
of a file of several segments under the emulated graph protocol equals
the eager one exactly, with one batch-call key for the whole file.

The read ahead (tbc/framer.py::Framer._ensure_segment): a decode whose
swaps take the samples read ahead equals, bit for bit, the same decode with
every swap loading on the decode's thread; a seek past the staged samples
loads them itself; no two reads of the file, and no use of it on the
decode's thread, ever run at once; `close()` leaves no read in flight, and
a read that fails raises in the swap that needs it."""

import threading
import time

import jax
import numpy as np
import pytest
import torch

from ld_decode_tpu.io import loaders as JL
from ld_decode_tpu.models import encode as JE
from ld_decode_tpu.ops import filters as JF
from ld_decode_tpu.tbc import framer as JFR
from ld_decode_tpu.utils.params import DecoderConfig
from ld_decode_tpu_torch.io import loaders as TL
from ld_decode_tpu_torch.ops import filters as TF
from ld_decode_tpu_torch.ops import demod as TD
from ld_decode_tpu_torch.tbc import framer as TFR
from ld_decode_tpu_torch.tbc import fused as TFU
from ld_decode_tpu_torch.utils import spans as S
from ld_decode_tpu_torch.utils.graphs import GraphCache
from ld_decode_tpu_torch.utils.params import DecoderConfig as TConfig

from torch_parity import assert_picture_close

torch.set_num_threads(2)

START = 33046
NFRAMES = 8


@pytest.fixture(scope='module')
def capture(tmp_path_factory):
    cfg = DecoderConfig(system='NTSC', freq_mhz=40.0)
    # big enough that the chain horizon and several swaps fit inside it
    samples = JE.encode_frames(cfg, 12, JE.EncodeSpec(pattern='ramp',
                                                      cav_start_frame=900))
    path = tmp_path_factory.mktemp('seg') / 'cap.lds'
    path.write_bytes(JL.pack_data_4_40(samples).tobytes())
    tcfg = TConfig(system='NTSC', freq_mhz=40.0)
    return cfg, tcfg, samples, path, TF.make_demod_bank(tcfg, device='cpu')


@pytest.fixture(scope='module')
def tiled(capture):
    """The fixture's packed bytes written 3 times in a row: a 36-frame file
    of about 4 of the smallest segments (the FM carriers' phase steps at
    each join; the decode rides it)."""
    path = capture[3]
    tiled = path.with_name('tiled.lds')
    tiled.write_bytes(path.read_bytes() * 3)
    return tiled


def _decode_frames(fr, fd, n, start=START):
    out, s = [], start
    for i in range(n):
        rv = fr.readframe(fd, s, i == 0)
        if rv[0] is None:
            break
        out.append((np.asarray(rv[0]), fr.vbi.get('framenr'), rv[2]))
        s = rv[2]
    return out


def _segmented(tcfg, bank, path):
    # the smallest legal segment (2x the chain horizon, ~9.5 frames at
    # batch 2) is under the 12-frame file: 8 frames cross a swap
    return TFR.Framer(tcfg, bank, TL.loader_for_path(str(path)), batch=2,
                      segment_samples=1, device='cpu')


def test_segmented_matches_resident(capture):
    cfg, tcfg, samples, path, bank = capture
    ref = _decode_frames(TFR.Framer(tcfg, bank, capture=samples, batch=2,
                                    device='cpu'), None, NFRAMES)
    fr = _segmented(tcfg, bank, path)
    with open(path, 'rb') as fd:
        got = _decode_frames(fr, fd, NFRAMES)
    assert len(got) == len(ref) >= 6
    assert fr._seg_samples > 0
    assert fr._seg_base > START              # the window slid
    for (a, fa, na), (b, fb, nb) in zip(ref, got):
        assert fa == fb is not None and na == nb
        np.testing.assert_array_equal(a[:16], b[:16])
        d = np.abs(a.reshape(-1, 910)[24:].astype(np.int64)
                   - b.reshape(-1, 910)[24:])
        assert np.percentile(d, 99.9) <= 2, d.max()

    with jax.enable_x64(False):
        jfr = JFR.Framer(cfg, JF.make_demod_bank(cfg, np.complex64),
                         loader=JL.loader_for_path(str(path)), batch=2,
                         segment_samples=1, pic_mode='raw')
        with open(path, 'rb') as fd:
            want = _decode_frames(jfr, fd, NFRAMES)
    assert len(want) == len(got)
    for (a, fa, na), (b, fb, nb) in zip(want, got):
        assert (fa, na) == (fb, nb)
        np.testing.assert_array_equal(a[:16], b[:16])
        assert_picture_close(b.reshape(-1, 910), a.reshape(-1, 910))


def test_segmented_seek(capture):
    """findframe across segment boundaries lands where the JAX package's
    does."""
    cfg, tcfg, samples, path, bank = capture
    fr = _segmented(tcfg, bank, path)
    with open(path, 'rb') as fd:
        pos = TFR.findframe(fd, fr, 908, START)
        assert pos is not None
        rv = fr.readframe(fd, pos, False)
    assert rv[0] is not None and abs(fr.vbi['framenr'] - 908) <= 1
    with jax.enable_x64(False):
        jfr = JFR.Framer(cfg, JF.make_demod_bank(cfg, np.complex64),
                         loader=JL.loader_for_path(str(path)), batch=2,
                         segment_samples=1, pic_mode='raw')
        with open(path, 'rb') as fd:
            assert JFR.findframe(fd, jfr, 908, START) == pos


def _hops(fr, fd, spf, n_file):
    """Two frames from START, one after a jump into each of the next three
    (full) segments, and the frames from a short tail segment to the end
    of the file: (frame, CAV number, next sample) each, and the segment
    loads (base, valid_len, the cache's counts before the load)."""
    loads = []
    pf = fr.prefetcher
    set_capture = pf.set_capture
    graphs = getattr(pf, 'graphs', None)          # the JAX package: none

    def counted(capture, base, valid_len=None):
        loads.append((base, valid_len, graphs and dict(graphs.counts)))
        return set_capture(capture, base, valid_len)

    pf.set_capture = counted
    out = _decode_frames(fr, fd, 2)
    for k in (1, 2, 3):
        out += _decode_frames(fr, fd, 1, START + int(k * 8.2 * spf))
    # the tail: the last segment holds ~2.5 frames of file
    out += _decode_frames(fr, fd, 8, n_file - int(2.5 * spf))
    return out, loads


def test_tiled_file_keeps_one_key(capture, tiled):
    """A decode over 3 swaps and a zero-padded tail segment under the
    emulated graph protocol: one batch-call key for the whole file, warmed
    up and captured in the first segment and never again (the buffer is
    refilled in place and valid_len is a dynamic input, not a key); its
    frames, CAV numbers, next samples and line-0 words equal the eager
    decode's exactly, and its tail equals the JAX package's segmented
    Framer to the budgets above."""
    cfg, tcfg, samples, path, bank = capture
    spf = cfg.freq_hz / cfg.sys.fps
    n_file = tiled.stat().st_size // 5 * 4
    runs = {}
    for name in ('emulate', 'eager'):
        cache = GraphCache('cpu', 'emulate') if name == 'emulate' else False
        fr = TFR.Framer(tcfg, bank, TL.loader_for_path(str(tiled)),
                        batch=2, segment_samples=1, device='cpu',
                        graphs=cache)
        with open(tiled, 'rb') as fd:
            runs[name] = _hops(fr, fd, spf, n_file) + (fr,)
    (got, loads, fr), (ref, _, _) = runs['emulate'], runs['eager']
    seg = fr._seg_samples
    assert len(loads) >= 5                       # 3 swaps, then the tail
    assert all(v == seg for _, v, _ in loads[:4])
    assert loads[-1][1] < seg and fr._seg_eof     # a padded tail
    assert fr.prefetcher.capture is fr._seg_buf
    assert fr._seg_buf.shape == (seg,)
    assert not fr._seg_buf[fr._seg_valid:].any()
    cache = fr.prefetcher.graphs
    after_first = loads[1][2]
    assert after_first['eager_warmups'] == 1 and after_first['captures'] == 1
    for k in ('eager_warmups', 'captures'):
        assert cache.counts[k] == after_first[k]
    assert cache.counts['replays'] > after_first['replays']
    assert len(cache._seen) == len(cache._graphs) == 1
    key = next(iter(cache._seen))[0]
    assert not {seg, loads[-1][1]} & set(key)          # valid_len is no key
    assert len(got) == len(ref) >= 6
    assert got[-1][1] == 910             # the tile's last whole frame
    for (a, fa, na), (b, fb, nb) in zip(ref, got):
        assert (fa, na) == (fb, nb) and np.array_equal(a, b)

    with jax.enable_x64(False):
        jfr = JFR.Framer(cfg, JF.make_demod_bank(cfg, np.complex64),
                         loader=JL.loader_for_path(str(tiled)), batch=2,
                         segment_samples=1, pic_mode='raw')
        with open(tiled, 'rb') as fd:
            want, _ = _hops(jfr, fd, spf, n_file)
    assert len(want) == len(got)
    for (a, fa, na), (b, fb, nb) in zip(want, got):
        assert (fa, na) == (fb, nb)
        np.testing.assert_array_equal(a[:16], b[:16])
        assert_picture_close(b.reshape(-1, 910), a.reshape(-1, 910))


def test_batch_call_takes_valid_len_as_a_tensor(capture):
    """field_pipeline_batch with valid_len a device scalar (the
    prefetcher's dynamic input) equals the int form bit for bit, on a
    capture zero-padded past valid_len where the second window clamps at
    the real end."""
    cfg, tcfg, samples, path, bank = capture
    n = 3 * 1334667
    cap = torch.zeros(n + 2 ** 20)
    cap[:n] = torch.from_numpy(samples[:n].astype(np.float32))
    pitch = int(round(tcfg.freq_hz / tcfg.sys.fps / 2))
    s0 = n - TD.stream_len(tcfg, 52) + tcfg.blockcut - pitch // 2
    outs = []
    for vlen in (n, torch.tensor(n, dtype=torch.int32)):
        outs.append(TFU.field_pipeline_batch(
            cap, torch.tensor(s0, dtype=torch.int32), torch.zeros(()),
            torch.ones(()), bank, tcfg, 52, 52 * bank.a_stage1_keep, 2,
            pitch, valid_len=vlen))
    (a, sa, oa), (b, sb, ob) = outs
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k
    assert torch.equal(sa, sb) and torch.equal(oa, ob)
    starts = a['meta_i'][:, 6]
    assert int(starts[1]) == n - TD.stream_len(tcfg, 52) + tcfg.blockcut


# ---------------------------------------------------------------------------
# the read ahead


def _fields_of(fr):
    """Wrap fr.readfield to keep each field read with the audio carry it
    started from; returns the list it fills."""
    seen = []
    readfield = fr.readfield

    def logged(infile, sample):
        carry = fr.audio_offset
        f, rs, ns = readfield(infile, sample)
        if f is not None:
            seen.append((carry, rs, ns, f))
        return f, rs, ns

    fr.readfield = logged
    return seen


def _assert_fields_equal(got, want):
    assert len(got) == len(want) > 0
    for (ca, ra, na, fa), (cb, rb, nb, fb) in zip(got, want):
        assert (ca, ra, na) == (cb, rb, nb)
        assert fa.readsample == fb.readsample
        assert fa.audio_next_offset == fb.audio_next_offset
        for k in ('linelocs', 'dspicture', 'dsaudio'):
            a, b = getattr(fa, k), getattr(fb, k)
            assert (a is None) == (b is None), k
            if a is not None:
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                              err_msg=k)


def _swaps():
    """The segment swaps since the last spans reset: those that took the
    samples read ahead (their `segment.take` spans) and the others."""
    tot = S.totals()
    hits = tot.get('segment.take', (0,))[0]
    return {'hits': hits, 'misses': tot.get('segment.swap', (0,))[0] - hits}


def _ahead_or_not(tcfg, bank, path, hops):
    """The same decode twice over `path` at the smallest segment: with the
    read ahead, and with its take made to miss (every swap loads on the
    decode's thread).  `hops`: (start sample, frames) decoded in turn.
    Returns {mode: (frames, fields, swap counts)}."""
    runs = {}
    for mode in ('ahead', 'load'):
        S.reset()
        fr = TFR.Framer(tcfg, bank, TL.loader_for_path(str(path)), batch=2,
                        segment_samples=1, device='cpu')
        if mode == 'load':
            fr._staged = lambda ahead, base, n: None
        seen = _fields_of(fr)
        frames = []
        with open(path, 'rb') as fd:
            for start, n in hops:
                frames += _decode_frames(fr, fd, n, start)
            fr.close()
        runs[mode] = (frames, seen, _swaps())
    return runs


def test_read_ahead_is_bit_equal_to_loading_at_each_swap(capture, tiled):
    """14 frames over the smallest segment cross a swap every ~5 frames:
    with the read ahead every swap after the first takes the staged
    samples; every frame and every field's line locations, picture, audio,
    read sample and audio carry equal the decode's that loads at each
    swap, bit for bit."""
    cfg, tcfg, samples, path, bank = capture
    runs = _ahead_or_not(tcfg, bank, tiled, [(START, 14)])
    (fa, sa, ca), (fb, sb, cb) = runs['ahead'], runs['load']
    assert ca['misses'] == 1 and ca['hits'] >= 2
    assert cb == {'hits': 0, 'misses': ca['hits'] + 1}
    assert len(fa) == len(fb) == 14
    for (a, na, xa), (b, nb, xb) in zip(fa, fb):
        assert (na, xa) == (nb, xb)
        np.testing.assert_array_equal(a, b)
    _assert_fields_equal(sa, sb)


def test_a_seek_past_the_staged_samples_loads_them(capture, tiled):
    """A jump past what the read ahead staged misses, loads on the
    decode's thread and decodes the same fields as the decode that loads
    at every swap."""
    cfg, tcfg, samples, path, bank = capture
    spf = int(cfg.freq_hz / cfg.sys.fps)
    hops = [(START, 3), (START + 20 * spf, 3)]
    runs = _ahead_or_not(tcfg, bank, tiled, hops)
    (fa, sa, ca), (fb, sb, cb) = runs['ahead'], runs['load']
    assert ca == {'hits': 0, 'misses': 2}
    assert cb == {'hits': 0, 'misses': 2}
    assert [x[1] for x in fa] == [x[1] for x in fb] and len(fa) == 6
    assert fa[3][2] - fa[2][2] >= 15 * spf      # the jump
    for (a, _, _), (b, _, _) in zip(fa, fb):
        np.testing.assert_array_equal(a, b)
    _assert_fields_equal(sa, sb)


class _Timed:
    """A loader (or any callable) that records, for every call, its
    thread's name and the perf_counter it started and ended at; `pause`
    seconds inside each call widen the window in which another use of the
    file would overlap it."""

    def __init__(self, fn, pause=0.0, fail_on=None):
        self.fn, self.pause, self.fail_on = fn, pause, fail_on
        self.calls = []

    def __call__(self, *a, **kw):
        t0 = time.perf_counter()
        name = threading.current_thread().name
        try:
            if self.fail_on is not None and name.startswith(self.fail_on):
                raise OSError('the disc image could not be read')
            time.sleep(self.pause)
            return self.fn(*a, **kw)
        finally:
            self.calls.append((name, t0, time.perf_counter()))


def _overlap(a, b):
    return a[1] < b[2] and b[1] < a[2]


def _steps(fr, fd, samples):
    """Drive the Framer's swaps directly: make each sample resident in
    turn (no decode)."""
    for s in samples:
        assert fr._ensure_segment(fd, s)


def test_reads_never_overlap_each_other_or_the_file_s_other_uses(
        capture, tiled, monkeypatch):
    """Every read of the file (the decode thread's and the worker's) and
    every file_samples (which seeks the file) runs alone: none overlaps a
    read of another thread, though the reads ahead run on the worker; a
    findframe called while a read is under way waits for it before its
    first probe."""
    cfg, tcfg, samples, path, bank = capture
    reads = _Timed(TL.load_packed_4_40, pause=0.05)
    monkeypatch.setitem(TL._SAMPLES_PER_BYTE, reads, (4, 5))
    sizes = _Timed(TL.file_samples)
    monkeypatch.setattr(TL, 'file_samples', sizes)
    S.reset()
    fr = TFR.Framer(tcfg, bank, reads, batch=2, segment_samples=1,
                    device='cpu')
    pitch = fr.prefetcher.field_pitch
    probes = _Timed(fr.readframe)
    fr.readframe = probes
    with open(tiled, 'rb') as fd:
        _steps(fr, fd, range(START, START + 20 * 2 * pitch, pitch))
        assert fr._ahead is not None and not fr._ahead[2].done()
        pos = TFR.findframe(fd, fr, 908, START)
        assert pos is not None and probes.calls
        _steps(fr, fd, range(pos, pos + 6 * 2 * pitch, pitch))
        fr.close()
    worker = [c for c in reads.calls if c[0].startswith('segment-readahead')]
    assert len(worker) >= 3 and _swaps()['hits'] >= 3
    assert len(reads.calls) > len(worker)
    for i, a in enumerate(reads.calls):
        for b in reads.calls[i + 1:]:
            assert not _overlap(a, b), (a, b)
    assert sizes.calls
    for c in sizes.calls:
        assert c[0] == 'MainThread'
        assert not any(_overlap(c, w) for w in worker), c
    first = probes.calls[0][1]
    assert not any(w[1] <= first <= w[2] for w in worker)


def test_close_leaves_no_read_in_flight(capture, tiled):
    """close() returns after the read ahead in flight has ended, and no
    worker thread is left."""
    cfg, tcfg, samples, path, bank = capture
    reads = _Timed(TL.loader_for_path(str(tiled)), pause=0.3)
    reads.total_samples = tiled.stat().st_size // 5 * 4
    fr = TFR.Framer(tcfg, bank, reads, batch=2, segment_samples=1,
                    device='cpu')
    with open(tiled, 'rb') as fd:
        _steps(fr, fd, [START])
        read = fr._ahead[2]
        assert not read.done()
        workers = list(fr._pool._threads)
        fr.close()
        t_closed = time.perf_counter()
    assert read.done() and read.exception() is None
    assert fr._ahead is None and fr._pool is None
    assert reads.calls[-1][0].startswith('segment-readahead')
    assert reads.calls[-1][2] <= t_closed
    assert len(workers) == 1 and not workers[0].is_alive()


def test_a_read_that_fails_raises_in_the_swap_that_needs_it(capture, tiled):
    """The worker's loader raises: the swap that needs its samples raises
    the same error on the decode's thread; a seek elsewhere instead loads
    on the decode's thread, and the failed read it did not need is
    dropped."""
    cfg, tcfg, samples, path, bank = capture
    total = tiled.stat().st_size // 5 * 4
    for need in (True, False):
        reads = _Timed(TL.loader_for_path(str(tiled)),
                       fail_on='segment-readahead')
        reads.total_samples = total
        S.reset()
        fr = TFR.Framer(tcfg, bank, reads, batch=2, segment_samples=1,
                        device='cpu')
        pitch = fr.prefetcher.field_pitch
        with open(tiled, 'rb') as fd:
            _steps(fr, fd, [START])
            fr.wait_reads()
            assert isinstance(fr._ahead[2].exception(), OSError)
            nxt = fr._seg_base + fr._seg_valid - fr._seg_horizon + pitch
            if need:
                with pytest.raises(OSError, match='could not be read'):
                    fr._ensure_segment(fd, nxt)
            else:
                _steps(fr, fd, [nxt + 10 * 2 * pitch])
                assert _swaps() == {'hits': 0, 'misses': 2}
            fr.close()
