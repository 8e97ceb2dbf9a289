"""PyTorch port, the comb windows under the compile boundary
(utils/graphs.py): NTSCCombBatch's ring (dim 3 without flow, `-F`) and
simple (dims 1/2) windows, PALCombBatch's simple and 3D windows with frame
0's 2D head and the 2D flush frame, the streaming PALComb's
`comb_pal_frame` and the combs' codec=True RGB encode, each through a
GraphCache in the emulated protocol against the eager comb, bit for bit.

Every key serves at least 3 windows of changing frames (a warm-up, a
capture, then replays), so a static input left stale or a value frozen
into the capture would show; each window's output also differs from the
last.  The card test runs the same feeds with CUDA graphs."""

import numpy as np
import pytest
import torch
from scipy.ndimage import gaussian_filter

from ld_decode_tpu_torch.comb import batch as TB
from ld_decode_tpu_torch.comb import comb_ntsc as TC
from ld_decode_tpu_torch.comb import comb_pal as TP
from ld_decode_tpu_torch.utils.graphs import GraphCache

torch.set_num_threads(2)


def emulated():
    return GraphCache('cpu', 'emulate')


def _textured(shape, n, seed):
    """n frames of a smooth texture moving 1 px a frame about mid-level,
    seeded; (n, Y, X) int32 holding 16-bit samples."""
    rng = np.random.default_rng(seed)
    y, x = shape
    tex = gaussian_filter(rng.normal(0, 1, (y + 40, x + 70)), 2.0)
    tex = tex / np.abs(tex).max() * 6000
    return np.stack([0x5000 + np.roll(tex, (k // 2, k), axis=(0, 1))[:y, :x]
                     for k in range(n)])


def _ntsc_frames(n=6):
    """NTSC frames with the phase flag in column 0 and a burst level that
    changes from frame to frame in column 1 (the AGC's input)."""
    f = _textured((TC.IN_Y, TC.IN_X), n, 11)
    f[:, :, 0] = np.where(np.arange(TC.IN_Y) % 2, 16384, 32768)
    for k in range(n):
        f[k, :, 1] = 20 * TC.IRESCALE + 300 * np.sin(k + np.arange(TC.IN_Y)
                                                     / 9)
    return torch.from_numpy(np.clip(f, 0, 65535).astype(np.int32))


def _pal_frames(n=6):
    return torch.from_numpy(np.clip(_textured((TP.PAL_Y, TP.PAL_X), n, 12),
                                    0, 65535).astype(np.int32))


def _counts(cache, name):
    """(warm-ups, captures) of the keys named `name`, and their replays
    (the capture's own included)."""
    full = [k for k in cache._seen if k[0][0] == name]
    return len(full), sum(k in cache._graphs for k in full)


def _ntsc_run(cfg, frames, graphs, device='cpu'):
    comb = TB.NTSCCombBatch(cfg, device=device, graphs=graphs)
    rgb, words = [], []
    for k in range(frames.shape[0]):         # one frame a feed
        r, w = comb.collect(comb.feed(frames[k:k + 1]))
        rgb += r
        words += w
    return comb, rgb, words


def _pal_batch_run(cfg, frames, graphs, device='cpu'):
    """dim 3: the first feed holds 3 frames (the 2D head and a 3D window
    of one frame), then one frame a feed; the 2D flush frame last."""
    comb = TB.PALCombBatch(cfg, device=device, graphs=graphs)
    first = 3 if cfg.dim == 3 else 1
    feeds = [frames[:first]] + [frames[k:k + 1]
                                for k in range(first, frames.shape[0])]
    rgb = []
    for f in feeds:
        rgb += comb.collect(comb.feed(f))[0]
    tail = comb.flush()
    return comb, rgb + ([tail] if tail is not None else [])


def _pal_stream_run(cfg, frames, graphs, device='cpu'):
    comb = TP.PALComb(cfg, device=device, graphs=graphs)
    out = [comb.process(f.numpy()) for f in frames]
    out = [r for r in out if r is not None]
    tail = comb.flush()
    return comb, out + ([tail] if tail is not None else [])


def _equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and np.array_equal(x, y)
    # consecutive windows differ: a stale input or frozen value would show
    assert all(not np.array_equal(x, y) for x, y in zip(a, a[1:]))


@pytest.mark.parametrize('name,cfg', [
    ('comb_window_ring', TC.CombConfig(dim=3, opticalflow=False)),
    ('comb_window_simple', TC.CombConfig(dim=2)),
    ('comb_window_simple', TC.CombConfig(dim=1))])
def test_ntsc_batch_windows_equal_eager(name, cfg):
    """NTSCCombBatch `-F` (the ring from the third frame) and dims 2/1,
    one frame a feed: 4 windows of one key (1 warm-up, 1 capture, 3
    replays) equal the eager comb bit for bit, RGB48, words and the AGC
    carry, which stays on the host."""
    frames = _ntsc_frames()
    ce, re_, we = _ntsc_run(cfg, frames, False)
    cg, rg, wg = _ntsc_run(cfg, frames, emulated())
    n = 4 if cfg.dim == 3 else 6
    assert len(rg) == n
    _equal(re_, rg)
    assert all(np.array_equal(a, b) for a, b in zip(we, wg))
    assert ce.aburstlev == cg.aburstlev
    assert _counts(cg.graphs, name) == (1, 1)
    assert cg.graphs.counts == {'eager_warmups': 1, 'captures': 1,
                                'replays': n - 1}


@pytest.mark.parametrize('dim', [3, 2])
def test_pal_batch_windows_equal_eager(dim):
    """PALCombBatch: dim 3 fed 3 frames (frame 0's 2D head and a 3D window
    of one frame), then one frame a feed (3D windows of 3 frames: a
    capture and replays), and the final frame 2D from flush (the head's
    key, captured); dim 2 one frame a feed.  Bit-equal to eager."""
    cfg = TP.CombPALConfig(dim=dim)
    frames = _pal_frames()
    _, re_ = _pal_batch_run(cfg, frames, False)
    cg, rg = _pal_batch_run(cfg, frames, emulated())
    assert len(rg) == 6
    _equal(re_, rg)
    c = cg.graphs
    if dim == 3:
        # the 3D key: 4 windows; the 2D key: the head, then the flush
        assert _counts(c, '_pal_window_3d') == (1, 1)
        assert _counts(c, '_pal_window_simple') == (1, 1)
        assert c.counts == {'eager_warmups': 2, 'captures': 2,
                            'replays': 4}
    else:
        assert c.counts == {'eager_warmups': 1, 'captures': 1,
                            'replays': 5}


@pytest.mark.parametrize('dim', [3, 2])
def test_streaming_pal_comb_equals_eager(dim):
    """PALComb over 6 frames (dim 3: frame 0 2D, frames 1-4 3D, the flush
    2D): one key for the 2D frames and one for the 3D ones, each replayed
    on later frames, bit-equal to eager; the read-back copies, so earlier
    frames keep their values."""
    cfg = TP.CombPALConfig(dim=dim)
    frames = _pal_frames()
    _, oe = _pal_stream_run(cfg, frames, False)
    cg, og = _pal_stream_run(cfg, frames, emulated())
    assert len(og) == 6
    _equal(oe, og)
    c = cg.graphs
    if dim == 3:
        keys = {k[0] for k in c._graphs}
        assert keys == {('comb_pal_frame', cfg, False),
                        ('comb_pal_frame', cfg, True)}
        assert c.counts == {'eager_warmups': 2, 'captures': 2,
                            'replays': 4}
    else:
        assert c.counts == {'eager_warmups': 1, 'captures': 1,
                            'replays': 5}


def _count_host_tensors(monkeypatch):
    made = {'from_numpy': 0, 'as_tensor': 0, 'tensor': 0}
    for name in made:
        real = getattr(torch, name)

        def counted(*a, _real=real, _name=name, **k):
            made[_name] += 1
            return _real(*a, **k)
        monkeypatch.setattr(torch, name, counted)
    return made


@pytest.mark.parametrize('program', ['ring', 'simple', 'pal_simple',
                                     'pal_3d', 'pal_frame'])
def test_window_programs_no_host_copies(monkeypatch, program):
    """A host-to-device copy from pageable memory is illegal in a capture:
    once warm, each new key's program creates no tensor from host data."""
    ntsc, pal = _ntsc_frames(3), _pal_frames(3)
    ncfg = TC.CombConfig(dim=3, opticalflow=False)
    pcfg = TP.CombPALConfig(dim=3)
    levels, _ = TC.burst_levels(ntsc, -1.0, ncfg)
    call = {
        'ring': lambda: TB._comb_window_ring(ntsc, levels[1:2], ncfg),
        'simple': lambda: TB._comb_window_simple(ntsc, levels, ncfg),
        'pal_simple': lambda: TB._pal_window_simple(pal, pcfg),
        'pal_3d': lambda: TB._pal_window_3d(pal, pcfg),
        'pal_frame': lambda: TP.comb_pal_frame(pal[1], pcfg, pal[0],
                                               pal[2])}[program]
    call()
    made = _count_host_tensors(monkeypatch)
    call()
    assert made == {'from_numpy': 0, 'as_tensor': 0, 'tensor': 0}


def _codec_run(system, out8, graphs, codec=True):
    """dim 2, one frame a feed, every window fed before the first is
    collected: each window's prefix top-up (the first windows' estimate is
    empty, so every window tops up) reads its dense buffers after the
    later windows' replays of the encode key."""
    if system == 'NTSC':
        comb = TB.NTSCCombBatch(TC.CombConfig(dim=2), out8=out8,
                                device='cpu', codec=codec, graphs=graphs)
        frames = _ntsc_frames()
    else:
        comb = TB.PALCombBatch(TP.CombPALConfig(dim=2), out8=out8,
                               device='cpu', codec=codec, graphs=graphs)
        frames = _pal_frames()
    handles = [comb.feed(frames[k:k + 1]) for k in range(frames.shape[0])]
    rgb, words = [], []
    for h in handles:
        r, w = comb.collect(h)
        rgb += r
        words += w
    return comb, rgb, words


@pytest.mark.parametrize('system,out8', [('NTSC', False), ('NTSC', True),
                                         ('PAL', False)])
def test_codec_encode_equals_eager(system, out8):
    """codec=True: the RGB encode (JAX's `_rgb_encode`) through the comb's
    emulated cache, one key a window shape and depth (a warm-up, a
    capture, 4 replays), gives the eager codec's frames and words bit for
    bit, and the raw copy's; no frame fell back to black.  With out8 the
    raw copy's cut to 8 bits replays as well."""
    _, raw, raw_w = _codec_run(system, out8, False, codec=False)
    _, re_, we = _codec_run(system, out8, False)
    cg, rg, wg = _codec_run(system, out8, emulated())
    assert len(rg) == 6
    _equal(re_, rg)
    _equal(raw, rg)
    # the raw copy's cut to 8 bits (JAX's `_to_rgb8`) replays too
    cr, rr, _ = _codec_run(system, out8, emulated(), codec=False)
    _equal(raw, rr)
    assert cr.graphs.counts['captures'] == (2 if out8 else 1)
    assert all(np.array_equal(a, b) for a, b in zip(we + raw_w, wg + wg))
    assert cg.stats['rgb_decode_fallback'] == 0
    assert cg.stats['rgb_topups'] == 12
    enc = [k for k in cg.graphs._graphs if k[0][0] == 'rgb_encode']
    assert len(enc) == 1
    assert cg.graphs.counts == {'eager_warmups': 2, 'captures': 2,
                                'replays': 10}


@pytest.mark.cuda
def test_card_comb_graphs_equal_eager():
    """On the card: the four new keys replayed as CUDA graphs give the
    eager combs' output bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device: CUDA graphs have no CPU mode')
    ntsc, pal = _ntsc_frames(), _pal_frames()
    for cfg in (TC.CombConfig(dim=3, opticalflow=False),
                TC.CombConfig(dim=2)):
        (_, a, wa), (cg, b, wb) = (_ntsc_run(cfg, ntsc, g, 'cuda')
                                   for g in (False, True))
        _equal(a, b)
        assert all(np.array_equal(x, y) for x, y in zip(wa, wb))
        assert cg.graphs.counts['replays'] >= 3
    for dim in (3, 2):
        cfg = TP.CombPALConfig(dim=dim)
        (_, a), (cg, b) = (_pal_batch_run(cfg, pal, g, 'cuda')
                           for g in (False, True))
        _equal(a, b)
        assert cg.graphs.counts['replays'] >= 3
    cfg = TP.CombPALConfig(dim=3)
    (_, a), (cg, b) = (_pal_stream_run(cfg, pal, g, 'cuda')
                       for g in (False, True))
    _equal(a, b)
    assert cg.graphs.counts['replays'] >= 3
    # the codec=True encode key, both depths
    for out8 in (False, True):
        comb = TB.NTSCCombBatch(TC.CombConfig(dim=2), out8=out8,
                                device='cuda', codec=True)
        hs = [comb.feed(ntsc[k:k + 1].cuda()) for k in range(ntsc.shape[0])]
        b = [f for h in hs for f in comb.collect(h)[0]]
        _, a, _ = _ntsc_run(TC.CombConfig(dim=2), ntsc, False, 'cuda')
        a = [(x >> 8).astype(np.uint8) if out8 else x for x in a]
        _equal(a, b)
        assert comb.stats['rgb_decode_fallback'] == 0
