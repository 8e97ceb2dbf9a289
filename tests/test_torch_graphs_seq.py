"""PyTorch port: the sequential paths through the CUDA-graph cache
(utils/graphs.py) under its emulated static-buffer protocol on the CPU --
the `--batch 1` decode (`FieldDecoder.process`, `Framer(loader, batch=1)`),
the resident sequential decode (`process_resident`, `Framer(capture,
batch=1)`) and the streaming NTSC comb (`NTSCComb`) -- each bit-equal to
its eager run, with the kernels' launch counts equal.  On the CPU the
kernels' dispatchers take their plain versions, which launch nothing, so
the tests count each plain call in the kernel's counter: a replay must
credit the launches its capture recorded, as on the card.

A value a call varies (the samples, the window start, mtf_level,
audio_offset) must reach a replay as a dynamic input, never as a constant
of the capture: `test_values_follow_eager` changes them between calls of
one key and holds every call to an eager decoder's.  The emulated replay
runs the call's own function, so there the cache's check of the plain
values a captured function closes over (`graphs.FrozenValueError`) is
what catches a frozen value; on the card the replay itself would repeat
it (`test_card_sequential_graphs_equal_eager`)."""

import numpy as np
import pytest
import torch

from ld_decode_tpu_torch.comb import comb_ntsc as TC
from ld_decode_tpu_torch.io import loaders as TL
from ld_decode_tpu_torch.models import encode as TE
from ld_decode_tpu_torch.ops import cuda_gather as CG
from ld_decode_tpu_torch.ops import demod as TD
from ld_decode_tpu_torch.ops import filters as TF
from ld_decode_tpu_torch.ops import gather as TG
from ld_decode_tpu_torch.tbc import cuda_resample as CR
from ld_decode_tpu_torch.tbc import field as TFD
from ld_decode_tpu_torch.tbc import framer as TFR
from ld_decode_tpu_torch.utils import graphs as G
from ld_decode_tpu_torch.utils.graphs import GraphCache
from ld_decode_tpu_torch.utils.params import DecoderConfig

torch.set_num_threads(2)

SYSTEMS = {'NTSC': dict(pattern='ramp', start=33046),
           'PAL': dict(pattern='palbars', start=2560 * 14)}


def emulated():
    return GraphCache('cpu', 'emulate')


@pytest.fixture
def counted(monkeypatch):
    """Count each plain K1/K2 call in the kernel's launch counter."""
    k1_plain, k2_plain = CR.resample_lines_batch_plain, TG.take_along_axis_plain

    def k1(*a, **kw):
        CR.resample_lines_batch.launches += 1
        return k1_plain(*a, **kw)

    def k2(*a, **kw):
        CG.take_along_axis.launches += 1
        return k2_plain(*a, **kw)

    monkeypatch.setattr(CR, 'resample_lines_batch_plain', k1)
    monkeypatch.setattr(TG, 'take_along_axis_plain', k2)


@pytest.fixture(scope='module')
def captures():
    out = {}
    for system, p in SYSTEMS.items():
        cfg = DecoderConfig(system=system, freq_mhz=40.0)
        cap = TE.encode_frames(cfg, 6, TE.EncodeSpec(pattern=p['pattern'],
                                                     cav_start_frame=900))
        out[system] = (cfg, cap,
                       TF.make_demod_bank(cfg, np.complex64, device='cpu'))
    return out


def _frames(framer, start, n):
    out, s = [], start
    for i in range(n):
        rv = framer.readframe(None, s, i == 0)
        assert rv[0] is not None, f'decode ended at frame {i}'
        out.append(rv)
        s = rv[2]
    return out


def _assert_frames_equal(eager, graphed):
    assert len(eager) == len(graphed)
    for a, b in zip(eager, graphed):
        assert a[2] == b[2]
        assert a[0].dtype == b[0].dtype and np.array_equal(a[0], b[0])
        assert np.array_equal(a[1], b[1])
        for x, y in zip(a[3], b[3]):
            _assert_fields_equal(x, y)


def _assert_fields_equal(x, y):
    assert (x.valid, x.nextfieldoffset, x.istop, x.linecount,
            x.audio_next_offset) == (y.valid, y.nextfieldoffset, y.istop,
                                     y.linecount, y.audio_next_offset)
    for k in ('linelocs', 'burstlevel', 'dspicture', 'dsaudio'):
        a, b = getattr(x, k), getattr(y, k)
        assert (a is None) == (b is None), k
        if a is not None:
            assert a.dtype == b.dtype and np.array_equal(a, b), k
    assert x.vbi == y.vbi and x.linecode == y.linecode


def _decode_both(framer_of, start, n):
    """The frames of framer_of(graphs) eager and emulated, with the K1
    launches of each run and the emulated cache."""
    runs = []
    for graphs in (False, emulated()):
        CR.resample_lines_batch.launches = 0
        fr = framer_of(graphs)
        runs.append((_frames(fr, start, n), CR.resample_lines_batch.launches,
                     fr.graphs))
    return runs


@pytest.mark.parametrize('system', list(SYSTEMS))
def test_process_protocol_equals_eager(captures, counted, system):
    """The `--batch 1` decode of 4 frames: frames, audio, next samples and
    every field's line locations, burst levels, picture, audio and VBI
    bit-equal to eager; K1 3 a field (NTSC) or 1 (PAL) both ways, with
    every segment's key replayed."""
    cfg, cap, bank = captures[system]
    (eager, k1e, _), (graphed, k1g, cache) = _decode_both(
        lambda g: TFR.Framer(cfg, bank, loader=TL.make_array_loader(cap),
                             batch=1, device='cpu', graphs=g),
        SYSTEMS[system]['start'], 4)
    _assert_frames_equal(eager, graphed)
    # (the first frame may decode a field more than it keeps)
    nfields = sum(len(rv[3]) for rv in eager)
    per_field = 3 if system == 'NTSC' else 1
    assert k1e == k1g and k1g % per_field == 0
    assert k1g >= per_field * nfields
    keys = {full[0][0] for full in cache._graphs}
    want = {'demod_stream', 'find_sync_peaks', 'refine_hsync_zc', 'picture',
            'audio_stage2'}
    want |= {'burst_window'} if system == 'NTSC' else {'refine_pilot'}
    assert keys == want
    assert cache.counts['replays'] >= 3 * nfields
    # both line counts of the system (262/263, 312/313) have their keys
    assert len({full for full in cache._graphs
                if full[0][0] == 'picture'}) == 2


def test_process_resident_protocol_equals_eager(captures, counted):
    """The resident sequential decode (the prefetcher's fallback, and
    Framer(capture, batch=1)): two keys, `field_analyze` and
    `field_finish`, bit-equal to eager over 3 NTSC frames, K1 equal."""
    cfg, cap, bank = captures['NTSC']
    (eager, k1e, _), (graphed, k1g, cache) = _decode_both(
        lambda g: TFR.Framer(cfg, bank, capture=cap, batch=1, device='cpu',
                             graphs=g),
        SYSTEMS['NTSC']['start'], 3)
    _assert_frames_equal(eager, graphed)
    assert k1e == k1g and k1g % 3 == 0
    assert k1g >= 3 * sum(len(rv[3]) for rv in eager)
    assert {full[0][0] for full in cache._graphs} == {'field_analyze',
                                                      'field_finish'}
    assert cache.counts['replays'] >= 4


def test_batched_framer_gives_its_fallback_its_own_cache(captures):
    """At batch > 1 the given cache serves the prefetcher; the decoder's
    fallback (the first field of a segment, a resync) gets an eager cache
    of its own, which captures nothing."""
    cfg, cap, bank = captures['NTSC']
    cache = emulated()
    fr = TFR.Framer(cfg, bank, capture=cap, batch=2, device='cpu',
                    graphs=cache)
    assert fr.prefetcher.graphs is cache
    assert fr.decoder.graphs is not cache
    assert fr.decoder.graphs.mode == 'eager'
    fr.readframe(None, SYSTEMS['NTSC']['start'], True)
    assert not fr.decoder.graphs._seen and not fr.decoder.graphs._graphs
    assert cache._seen
    fr.prefetcher.set_capture(fr.prefetcher.capture, 0)
    assert not cache._seen


# (mtf_level, audio_offset) of the values case's calls
VALUE_CALLS = ((1.0, 0.0), (0.5, 1e-4), (0.8, 2e-5), (0.0, 7e-5), (1.0, 0.0))


def _values_follow_eager(cfg, cap, eager, graphed):
    """Calls of one key with other samples, window starts, mtf_level and
    audio_offset through `graphed`: every call equals `eager`'s with the
    same values, and the values move the outputs.  Returns the graphed
    cache's counts."""
    n = TD.stream_len(cfg, eager.nblocks)
    capt = torch.from_numpy(cap.astype(np.float32)).to(eager.device)
    # the window starts of whole fields, found as the framer finds them
    starts, rs = [], SYSTEMS[cfg.system]['start']
    while len(starts) < len(VALUE_CALLS):
        r = eager.process_resident(capt, rs)
        assert r is not None, 'the capture ended'
        if r.valid:
            starts.append(rs)
        rs += r.nextfieldoffset
    firsts = []
    for rs, (mtf, aoff) in zip(starts, VALUE_CALLS):
        window = cap[rs - cfg.blockcut:rs - cfg.blockcut + n]
        a = eager.process(window, mtf, aoff)
        b = graphed.process(window, mtf, aoff)
        assert a.valid
        _assert_fields_equal(a, b)
        a = eager.process_resident(capt, rs, mtf, aoff)
        b = graphed.process_resident(capt, rs, mtf, aoff)
        assert a.valid
        _assert_fields_equal(a, b)
        firsts.append(a)
    # the values did move the outputs: fields 0 and 2 (one parity) differ
    assert not np.array_equal(firsts[0].dspicture, firsts[2].dspicture)
    assert firsts[0].audio_next_offset != firsts[2].audio_next_offset
    return dict(graphed.graphs.counts)


def test_values_follow_eager(captures):
    """Calls of one key with other samples, window starts, mtf_level and
    audio_offset: every replay equals an eager decoder's call with the
    same values.  The emulated replay runs the call's own function, so a
    value closed over as a Python scalar would follow eager here; the
    cache's check of the captured function's plain values
    (`graphs.FrozenValueError`) is what fails it, as a real replay would
    repeat the captured value (test_card_sequential_graphs_equal_eager
    runs this case with real graphs)."""
    cfg, cap, bank = captures['NTSC']
    eager = TFD.FieldDecoder(cfg, bank, 66, device='cpu', graphs=False)
    graphed = TFD.FieldDecoder(cfg, bank, 66, device='cpu',
                               graphs=emulated())
    c = _values_follow_eager(cfg, cap, eager, graphed)
    assert c['captures'] >= 2 and c['replays'] >= 10


def test_a_value_frozen_into_a_capture_raises():
    """A function that closes over a plain Python value (or is other
    code) than at its key's capture raises on the card and in the
    emulated mode alike; a value that does not change, or one passed as a
    tensor input, replays."""
    x = torch.arange(4.0)
    for mode in ('emulate',) + (('graph',) if torch.cuda.is_available()
                                else ()):
        dev = 'cpu' if mode == 'emulate' else 'cuda'
        cache, xd = GraphCache(dev, mode), x.to(dev)
        scale = 2.0

        def times(t):
            return t * scale

        for _ in range(3):
            out = cache('scale', times, (xd,))
        assert torch.equal(out.cpu(), x * 2.0)
        scale = 3.0
        with pytest.raises(G.FrozenValueError):
            cache('scale', times, (xd,))
        with pytest.raises(G.FrozenValueError):
            cache('scale', lambda t: t * 2.0 + 0.0, (xd,))
        for s in (2.0, 3.0, 5.0):
            out = cache('scale_in', lambda t, k: t * k,
                        (xd, torch.tensor(s, device=dev)))
            assert torch.equal(out.cpu(), x * s)


def test_cpu_defaults_stay_eager(captures):
    cfg, _, bank = captures['NTSC']
    assert TFD.FieldDecoder(cfg, bank, 66, device='cpu').graphs.mode == \
        'eager'
    assert TC.NTSCComb(TC.CombConfig(), device='cpu').graphs.mode == 'eager'


# ---------------------------------------------------------------------------
# the streaming NTSC comb


@pytest.fixture(scope='module')
def textured(captures):
    """A port-decoded `ramp` frame under a smooth texture moving 1 px a
    frame sideways and a line every other frame (tests/test_torch_comb.py's
    textured frames): content on which the flow is well posed."""
    from scipy.ndimage import gaussian_filter
    cfg, cap, bank = captures['NTSC']
    fr = TFR.Framer(cfg, bank, loader=TL.make_array_loader(cap), batch=1,
                    device='cpu', graphs=False)
    base = np.asarray(_frames(fr, SYSTEMS['NTSC']['start'], 1)[0][0])
    base = base.reshape(525, 910)
    rng = np.random.default_rng(11)
    tex = gaussian_filter(rng.normal(0, 1, (560, 960)), 2.0)
    tex = tex / np.abs(tex).max() * 4000
    out = []
    for k in range(6):
        f = base.astype(np.int64)
        t = np.roll(tex, (k // 2, k), axis=(0, 1))[:525, :910]
        f[20:, 60:] = np.clip(f[20:, 60:] + t[20:, 60:], 0, 65535)
        out.append(f.astype(np.uint16).reshape(-1))
    return out


def _stream_both(frames, **kw):
    """NTSCComb(CombConfig(**kw)) over frames eager and emulated: per run
    the emitted (RGB, words, -D stats, -l row) and the K2 launches."""
    runs = []
    for graphs in (False, emulated()):
        CG.take_along_axis.launches = 0
        comb = TC.NTSCComb(TC.CombConfig(**kw), device='cpu', graphs=graphs)
        out = []
        for f in frames:
            rgb = comb.process(f)
            if rgb is not None:
                out.append((rgb, comb.last_frame_words.copy(),
                            comb.last_debug2d, comb.last_debugline))
        runs.append((out, CG.take_along_axis.launches, comb))
    return runs


def _same(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif a is None or isinstance(a, float):
        assert a == b
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_stream_flow_protocol_equals_eager(textured, counted):
    """Dim 3 with the Farnebäck flow over 6 textured frames: the flow luma,
    the Farnebäck step (without, then with the initial flow) and the
    frame's comb replay; RGB48, words and the flow carry bit-equal to
    eager, K2 9 launches an emitted frame both ways."""
    (eager, k2e, ce), (graphed, k2g, cg) = _stream_both(textured, dim=3)
    _same(eager, graphed)
    assert len(graphed) == 4
    assert k2e == k2g == 9 * len(graphed)
    for f in (0, 1):
        assert torch.equal(ce._of_flows[f], cg._of_flows[f])
        assert torch.equal(ce._of_prev[f], cg._of_prev[f])
    keys = {full[0][:2] for full in cg.graphs._graphs}
    assert {('flow_luma', TC.CombConfig(dim=3)),
            ('farneback_combk2', True),
            ('frame_core', TC.CombConfig(dim=3))} <= keys
    assert cg.graphs.counts['replays'] >= 8


def test_stream_debug_protocol_equals_eager(textured):
    """Dim 2 with -D and -l: RGB48 (the -l line blacked out), the per-line
    and total MSE/ME and the exposed YIQ row bit-equal to eager."""
    frames = [textured[0], textured[3]] * 2
    (eager, _, _), (graphed, _, cg) = _stream_both(
        frames, dim=2, debug2d=True, debugline=100)
    _same(eager, graphed)
    assert len(graphed) == 4 and graphed[0][2] is not None \
        and graphed[0][3] is not None
    assert cg.graphs.counts['replays'] == 3


@pytest.mark.cuda
def test_card_sequential_graphs_equal_eager(captures, textured):
    """On the card: the --batch 1 decode and the streaming comb replayed as
    CUDA graphs give the eager runs' outputs bit for bit, with the same K1
    and K2 launches (credited on replay); and calls of one key with other
    window starts, mtf_level and audio_offset each equal eager's, which a
    value frozen into a capture would not."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device: CUDA graphs have no CPU mode')
    cfg, cap, _ = captures['NTSC']
    bank = TF.make_demod_bank(cfg, np.complex64, device='cuda')
    runs = []
    for graphs in (False, True):
        CR.resample_lines_batch.launches = 0
        CG.take_along_axis.launches = 0
        fr = TFR.Framer(cfg, bank, loader=TL.make_array_loader(cap),
                        batch=1, device='cuda', graphs=graphs)
        frames = _frames(fr, SYSTEMS['NTSC']['start'], 3)
        comb = TC.NTSCComb(TC.CombConfig(dim=3), device='cuda',
                           graphs=graphs)
        rgb = [comb.process(f) for f in textured]
        runs.append((frames, rgb, CR.resample_lines_batch.launches,
                     CG.take_along_axis.launches, fr.graphs.counts,
                     comb.graphs.counts))
    (fe, re, k1e, k2e, _, _), (fg, rg, k1g, k2g, cd, cc) = runs
    _assert_frames_equal(fe, fg)
    _same(re, rg)
    assert cd['replays'] >= 1 and cc['replays'] >= 1
    assert k1e == k1g > 0 and k2e == k2g == 9 * (len(textured) - 2)
    c = _values_follow_eager(
        cfg, cap, TFD.FieldDecoder(cfg, bank, 66, device='cuda',
                                   graphs=False),
        TFD.FieldDecoder(cfg, bank, 66, device='cuda'))
    assert c['captures'] >= 2 and c['replays'] >= 10
