"""PyTorch port: the compile boundary (utils/graphs.py), the counterpart of
jax.jit's per-static-shape program cache.

On the CPU the cache runs eagerly; these tests construct it in its
'emulate' mode, which keeps the card's static-buffer protocol without a
graph: the first call of a key runs eagerly, the second copies its
dynamic inputs into static inputs and runs on them, and every call after
it copies its inputs in and writes its results into the same static
output tensors, which the next call overwrites.  So they show on the CPU
what a replay's aliasing would do to a caller that keeps an output too
long.  The decode and the comb under the protocol must equal their eager
runs bit for bit; the eager runs are held to the JAX package in
tests/test_torch_framer.py, test_torch_chain.py and test_torch_comb.py.
The card test replays real graphs."""

import gc
import types
import weakref

import numpy as np
import pytest
import torch
from scipy.ndimage import gaussian_filter

from ld_decode_tpu_torch.comb import batch as TB
from ld_decode_tpu_torch.comb import comb_ntsc as TC
from ld_decode_tpu_torch.io import loaders as TL
from ld_decode_tpu_torch.models import encode as TE
from ld_decode_tpu_torch.ops import filters as TF
from ld_decode_tpu_torch.tbc import field as TFD
from ld_decode_tpu_torch.tbc import framer as TFR
from ld_decode_tpu_torch.tbc import fused as FU
from ld_decode_tpu_torch.tbc import pipeline as TP
from ld_decode_tpu_torch.utils import graphs as G
from ld_decode_tpu_torch.utils.params import DecoderConfig

torch.set_num_threads(2)

NTSC = DecoderConfig(system='NTSC', freq_mhz=40.0)


def emulated():
    return G.GraphCache('cpu', 'emulate')


# ---------------------------------------------------------------------------
# the cache on its own


def test_modes_are_picked_by_device_and_never_emulate():
    assert G.GraphCache('cpu').mode == 'eager'
    assert G.GraphCache('cpu').aliased is False
    assert G.GraphCache('cuda').mode == 'graph'     # no CUDA call made
    assert G.GraphCache('cpu', 'emulate').aliased is True
    with pytest.raises(ValueError, match='for the CPU'):
        G.GraphCache('cuda', 'emulate')
    with pytest.raises(ValueError, match='CUDA device'):
        G.GraphCache('cpu', 'graph')
    with pytest.raises(ValueError, match='mode'):
        G.GraphCache('cpu', 'jit')


def test_counts_warmup_capture_replays():
    cache = emulated()
    fn = lambda x: {'y': x * 2, 'z': (x + 1, x.sum())}   # noqa: E731
    outs = [cache('k', fn, (torch.full((3,), float(v)),)) for v in range(5)]
    assert cache.counts == {'eager_warmups': 1, 'captures': 1,
                            'replays': 4}
    assert len(cache.capture_seconds) == 1
    # the first call's outputs are its own; from the second call on they
    # are the static outputs, overwritten by every later call
    assert torch.equal(outs[0]['y'], torch.full((3,), 0.))
    for o in outs[1:]:
        assert o['y'] is outs[-1]['y']
        assert torch.equal(o['y'], torch.full((3,), 8.))
        assert torch.equal(o['z'][1], torch.tensor(12.))


def test_eager_mode_runs_every_call():
    cache = G.GraphCache('cpu')
    outs = [cache('k', lambda x: x + 1, (torch.full((2,), float(v)),))
            for v in range(3)]
    assert [float(o[0]) for o in outs] == [1., 2., 3.]
    assert cache.counts == {'eager_warmups': 0, 'captures': 0,
                            'replays': 0}


def test_launch_counters_credited_on_replay():
    """A counter's increase during the capture is taken back (a capture
    launches nothing) and added on every replay: the counts equal an
    eager run's."""
    k = types.SimpleNamespace(launches=0, rows=0)
    G.register_counter(k, 'launches', 'rows')

    def fn(x):
        k.launches += 3
        k.rows += 1
        return x * 2

    try:
        cache = emulated()
        for i in range(6):
            cache('k', fn, (torch.ones(2),))
            assert (k.launches, k.rows) == (3 * (i + 1), i + 1)
        assert cache.counts['replays'] == 5
    finally:
        G._COUNTERS[:] = [c for c in G._COUNTERS if c[0] is not k]


def _fake_pipeline(calls):
    """A stand-in for fused.field_pipeline_batch that records its static
    arguments and returns outputs made from its dynamic inputs."""
    def fake(capture, s0, o0, mtf, bank, cfg, nblocks, n_audio1, batch,
             pitch, colorlevel, colorphase, valid_len):
        calls.append((capture.data_ptr(), batch, int(valid_len), colorlevel))
        out = {'meta_i': torch.zeros((batch, 8), dtype=torch.int32)
               + s0.to(torch.int32),
               'picture': mtf.expand(batch, 2).clone()}
        return out, s0 + 1, o0 * 2
    return fake


def test_prefetcher_key_rules(monkeypatch):
    """A new key on another static argument or another capture tensor; the
    same key on new start/offset/mtf/valid_len values, which the replay
    reads from its static inputs, and on a segment refilled in place."""
    calls = []
    monkeypatch.setattr(FU, 'field_pipeline_batch', _fake_pipeline(calls))
    bank = TF.make_demod_bank(NTSC, np.complex64, device='cpu')
    dec = TFD.FieldDecoder(NTSC, bank, 52, device='cpu')
    cap = torch.zeros(1 << 20)
    pf = TP.FieldPrefetcher(dec, cap, batch=2, graphs=emulated())

    def dispatch(s0, o0, mtf):
        pf._dispatch(torch.tensor(s0, dtype=torch.int32),
                     torch.tensor(o0, dtype=torch.float32), mtf)
        fl = pf._flight[-1]
        return (int(fl.out['meta_i'][0, 0]), float(fl.out['picture'][0, 0]),
                int(fl.next_start0), float(fl.next_offset0))

    assert dispatch(10, 0.5, 1.0) == (10, 1.0, 11, 1.0)
    assert dispatch(20, 0.25, 0.75) == (20, 0.75, 21, 0.5)
    assert dispatch(30, 1.5, 0.5) == (30, 0.5, 31, 3.0)
    c = pf.graphs.counts
    assert (c['eager_warmups'], c['captures'], c['replays']) == (1, 1, 2)

    # a segment refilled in place with a shorter real part (the file's
    # tail): valid_len is a dynamic input, so the key replays with it
    pf.set_capture(cap, 1 << 22, valid_len=cap.shape[0] - 4096)
    dispatch(10, 0.5, 1.0)
    assert calls[-1][2] == cap.shape[0] - 4096
    assert pf.graphs.counts['eager_warmups'] == 1
    assert pf.graphs.counts['replays'] == 3
    assert not any({cap.shape[0], cap.shape[0] - 4096} & set(full[0])
                   for full in pf.graphs._seen)       # not in the key
    pf.capture = torch.zeros(1 << 20)                  # another capture
    dispatch(10, 0.5, 1.0)
    dec.colorlevel = 1.5                               # a static argument
    dispatch(10, 0.5, 1.0)
    assert pf.graphs.counts['eager_warmups'] == 3
    assert pf.graphs.counts['captures'] == 1
    assert [cl[2] for cl in calls[-2:]] == [cap.shape[0] - 4096] * 2
    assert calls[-1][3] == 1.5

    # a swap keeps the graphs and their pools
    pf.set_capture(cap, 0)
    assert pf.graphs._graphs and pf.graphs._seen


def test_caller_freed_without_a_cycle_collection(monkeypatch):
    """A prefetcher and its graphs go when their last reference does: the
    cache keeps no reference back to its caller, so no graph waits for a
    cycle collection, which on the card could run inside another capture
    and invalidate it."""
    monkeypatch.setattr(FU, 'field_pipeline_batch', _fake_pipeline([]))
    bank = TF.make_demod_bank(NTSC, np.complex64, device='cpu')
    dec = TFD.FieldDecoder(NTSC, bank, 52, device='cpu')
    pf = TP.FieldPrefetcher(dec, torch.zeros(1 << 20), batch=2,
                            graphs=emulated())
    for s0 in (10, 20, 30):
        pf._dispatch(torch.tensor(s0, dtype=torch.int32), torch.zeros(()),
                     1.0)
    assert pf.graphs.counts['captures'] == 1
    refs = weakref.ref(pf), weakref.ref(pf.graphs)
    collecting = gc.isenabled()
    gc.disable()
    try:
        del pf
        assert refs[0]() is None and refs[1]() is None
    finally:
        if collecting:
            gc.enable()


# ---------------------------------------------------------------------------
# the decode under the protocol


@pytest.fixture(scope='module')
def capture():
    return TE.encode_frames(NTSC, 4, TE.EncodeSpec(pattern='ramp',
                                                   cav_start_frame=900))


def _decode(capture, graphs, mode):
    bank = TF.make_demod_bank(NTSC, np.complex64, device='cpu')
    fr = TFR.Framer(NTSC, bank, capture=capture, batch=6, device='cpu',
                    fetch_picture=mode != 'chain', pic_mode='raw',
                    graphs=graphs)
    out, s = [], 33046
    for i in range(3):
        rv = fr.readframe(None, s, i == 0)
        if rv[0] is None:
            break
        out.append(rv)
        s = rv[2]
    return fr, out


@pytest.mark.parametrize('mode', ['raw', 'chain'])
def test_framer_protocol_equals_eager(capture, mode):
    """The Framer's decode (test_torch_framer.py's capture and batch)
    through the emulated protocol equals the eager decode bit for bit:
    frames, audio, next samples, line locations and metadata, with the
    picture copied raw or kept on the device (chain mode).  In chain mode the fields' device pictures,
    read after every later batch has run, still hold their own fields:
    the prefetcher clones what outlives the next replay."""
    fe, eager = _decode(capture, False, mode)
    fg, graphed = _decode(capture, emulated(), mode)
    c = fg.prefetcher.graphs.counts
    assert c['eager_warmups'] == 1 and c['captures'] == 1
    assert c['replays'] >= 2
    assert fg.prefetcher.stats['batches'] == fe.prefetcher.stats['batches']
    assert len(graphed) == len(eager) >= 2
    held = 0
    for a, b in zip(eager, graphed):
        assert a[2] == b[2]
        fa, fb = np.asarray(a[0]), np.asarray(b[0])
        assert fa.dtype == fb.dtype and np.array_equal(fa, fb)
        assert np.array_equal(a[1], b[1])
        for x, y in zip(a[3], b[3]):
            assert np.array_equal(x.linelocs, y.linelocs)
            assert x.vbi == y.vbi
            assert (x.dev_picture is None) == (y.dev_picture is None)
            if x.dev_picture is not None:
                held += 1
                assert torch.equal(x.dev_picture[0][x.dev_picture[1]],
                                   y.dev_picture[0][y.dev_picture[1]])
    assert held >= (2 if mode == 'chain' else 0)


def test_segmented_protocol_equals_eager(tmp_path):
    """A segmented decode (a loader, the smallest legal segment, so 8
    frames cross a swap) through the emulated protocol equals the eager
    one bit for bit: the swap refills the resident buffer in place, so
    the first segment's key serves the second (no new warm-up or
    capture)."""
    samples = TE.encode_frames(NTSC, 12, TE.EncodeSpec(pattern='ramp',
                                                       cav_start_frame=900))
    path = tmp_path / 'cap.lds'
    path.write_bytes(TL.pack_data_4_40(samples).tobytes())
    bank = TF.make_demod_bank(NTSC, np.complex64, device='cpu')
    runs = []
    for graphs in (False, emulated()):
        fr = TFR.Framer(NTSC, bank, TL.loader_for_path(str(path)), batch=2,
                        segment_samples=1, device='cpu', graphs=graphs)
        out, s = [], 33046
        with open(path, 'rb') as fd:
            for i in range(8):
                rv = fr.readframe(fd, s, i == 0)
                assert rv[0] is not None
                out.append((rv[0], rv[1], rv[2]))
                s = rv[2]
        runs.append((fr, out))
    (fe, eager), (fg, graphed) = runs
    assert fg._seg_base > 33046                 # the window slid
    c = fg.prefetcher.graphs.counts
    assert c['eager_warmups'] == 1 and c['captures'] == 1
    assert c['replays'] >= 2
    for a, b in zip(eager, graphed):
        assert a[2] == b[2]
        assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])


@pytest.mark.parametrize('system', ['NTSC', 'PAL'])
def test_no_host_copies_after_warmup(capture, monkeypatch, system):
    """A host-to-device copy from pageable memory is illegal in a capture:
    after its first call, field_pipeline_batch creates no tensor from host
    data."""
    cfg = DecoderConfig(system=system, freq_mhz=40.0)
    cap = capture if system == 'NTSC' else TE.encode_frames(
        cfg, 2, TE.EncodeSpec(pattern='palbars', cav_start_frame=900))
    cap_t = torch.from_numpy(cap.astype(np.float32))
    bank = TF.make_demod_bank(cfg, np.complex64, device='cpu')
    nblocks = 52 if system == 'NTSC' else 56
    pitch = int(round(cfg.freq_hz / cfg.sys.fps / 2))

    start0 = torch.full((), 2560 * 14, dtype=torch.int32)
    offset0, mtf = torch.zeros(()), torch.ones(())

    def call():
        return FU.field_pipeline_batch(
            cap_t, start0, offset0, mtf, bank, cfg, nblocks,
            nblocks * bank.a_stage1_keep, 2, pitch)

    call()
    made = _count_host_tensors(monkeypatch)
    call()
    assert made == {'from_numpy': 0, 'as_tensor': 0, 'tensor': 0}


def _count_host_tensors(monkeypatch):
    made = {'from_numpy': 0, 'as_tensor': 0, 'tensor': 0}
    for name in made:
        real = getattr(torch, name)

        def counted(*a, _real=real, _name=name, **k):
            made[_name] += 1
            return _real(*a, **k)
        monkeypatch.setattr(torch, name, counted)
    return made


# ---------------------------------------------------------------------------
# the NTSC flow comb under the protocol


def _frames(n=6):
    """Textured 525 x 910 frames moving 1 px a frame, the phase flag in
    column 0 and a burst level in column 1 (the AGC's input)."""
    rng = np.random.default_rng(7)
    tex = gaussian_filter(rng.normal(0, 1, (560, 980)), 2.0)
    tex = tex / np.abs(tex).max() * 4000
    out = []
    for k in range(n):
        f = 0x4000 + np.roll(tex, (k // 2, k), axis=(0, 1))[:525, :910]
        f[:, 0] = np.where(np.arange(525) % 2, 16384, 32768)
        f[:, 1] = 20 * TC.IRESCALE + 300 * np.sin(k + np.arange(525) / 9)
        out.append(np.clip(f, 0, 65535).astype(np.int32))
    return torch.from_numpy(np.stack(out))


def _comb(frames, graphs):
    comb = TB.NTSCCombBatch(TC.CombConfig(dim=3), device='cpu',
                            graphs=graphs)
    rgb, words = [], []
    for k in range(frames.shape[0]):        # one frame a window: M = 2
        r, w = comb.collect(comb.feed(frames[k:k + 1]))
        rgb += r
        words += w
    return comb, rgb, words


def test_comb_flow_protocol_equals_eager():
    """NTSCCombBatch's flow mode over 6 frames fed one at a time (windows
    of M = 2: a warm-up, a capture and three replays) equals the eager
    comb bit for bit: RGB48, line-0 words, the flow carry and the AGC
    carry."""
    frames = _frames()
    ce, re_, we = _comb(frames, False)
    cg, rg, wg = _comb(frames, emulated())
    assert cg.graphs.counts == {'eager_warmups': 1, 'captures': 1,
                                'replays': 3}
    assert len(rg) == len(re_) == 4
    for a, b in zip(re_, rg):
        assert a.dtype == b.dtype == np.uint16 and np.array_equal(a, b)
    for a, b in zip(we, wg):
        assert np.array_equal(a, b)
    assert torch.equal(ce._flow, cg._flow)
    assert ce.aburstlev == cg.aburstlev


def test_comb_window_program_no_host_copies(monkeypatch):
    """The comb window's device program (after the AGC) creates no tensor
    from host data once warm."""
    cfg = TC.CombConfig(dim=3)
    win = _frames(3)
    levels, _ = TC.burst_levels(win[:-1], -1.0, cfg)
    flow0 = torch.zeros((2, TC._CYSIZE, TC._CXSIZE, 2))
    TB._comb_window_flow(win, flow0, levels, cfg)
    made = _count_host_tensors(monkeypatch)
    rgb, words, flow = TB._comb_window_flow(win, flow0, levels, cfg)
    assert made == {'from_numpy': 0, 'as_tensor': 0, 'tensor': 0}
    assert rgb.shape == (2, 480, 744, 3) and flow.shape == flow0.shape


# ---------------------------------------------------------------------------
# the card


@pytest.mark.cuda
def test_card_graphs_equal_eager(capture):
    """On the card: the Framer's batch calls replayed as CUDA graphs give
    the eager decode's frames bit for bit, with the same K1 launches."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device: CUDA graphs have no CPU mode')
    from ld_decode_tpu_torch.tbc import cuda_resample as CR
    res = {}
    for graphs in (False, True):
        CR.resample_lines_batch.launches = 0
        bank = TF.make_demod_bank(NTSC, np.complex64, device='cuda')
        fr = TFR.Framer(NTSC, bank, capture=capture, batch=6,
                        device='cuda', graphs=graphs)
        out, s = [], 33046
        for i in range(3):
            rv = fr.readframe(None, s, i == 0)
            if rv[0] is None:
                break
            out.append(rv)
            s = rv[2]
        res[graphs] = (out, CR.resample_lines_batch.launches,
                       fr.prefetcher.graphs.counts)
    (eager, k1e, _), (graphed, k1g, counts) = res[False], res[True]
    assert counts['replays'] >= 1
    assert k1e == k1g > 0
    for a, b in zip(eager, graphed):
        assert a[2] == b[2] and np.array_equal(a[0], b[0])
        assert np.array_equal(a[1], b[1])
