"""PyTorch port: the last JAX `jax.jit` sites through the CUDA-graph cache
(utils/graphs.py) under its emulated static-buffer protocol on the CPU --
the chain's device weave with its line-0 words (`tbc/framer.py::
weave_device`, the JAX package's `_weave_go` and `_set_words`), the API's
`field_analyze_batch` / `field_finish_batch` (tbc/fused.py),
`tape/vhs.py::decode_vhs` and the legacy PAL comb
(`comb/comb_pal_legacy.py`) -- each bit-equal to its eager run over calls
whose dynamic values differ (the first call warms up, the second
captures, later calls replay), with K1's launches equal.  On the CPU K1's
dispatcher takes its plain version, which launches nothing, so the tests
count each plain call in the kernel's counter (tests/
test_torch_graphs_seq.py does the same)."""

import numpy as np
import pytest
import torch

from ld_decode_tpu_torch.comb import comb_pal_legacy as LP
from ld_decode_tpu_torch.models import encode as TE
from ld_decode_tpu_torch.ops import demod as TD
from ld_decode_tpu_torch.ops import filters as TF
from ld_decode_tpu_torch.tape import vhs as TV
from ld_decode_tpu_torch.tbc import cuda_resample as CR
from ld_decode_tpu_torch.tbc import framer as TFR
from ld_decode_tpu_torch.tbc import fused as TFU
from ld_decode_tpu_torch.tbc.field import FieldResult
from ld_decode_tpu_torch.utils import graphs as G
from ld_decode_tpu_torch.utils.graphs import GraphCache
from ld_decode_tpu_torch.utils.params import DecoderConfig
from ld_decode_tpu_torch.vbi import metadata as TM
from torch.utils._pytree import tree_flatten

from test_comb_pal_legacy import synth_frame

torch.set_num_threads(2)

NTSC = DecoderConfig(system='NTSC', freq_mhz=40.0)


def emulated():
    return GraphCache('cpu', 'emulate')


def _assert_same(a, b):
    """Two (nested) results equal bit for bit, tensor for tensor."""
    la, sa = tree_flatten(a)
    lb, sb = tree_flatten(b)
    assert sa == sb
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y)


@pytest.fixture
def counted(monkeypatch):
    """Count each plain K1 call in the kernel's launch counter."""
    plain = CR.resample_lines_batch_plain

    def k1(*a, **kw):
        CR.resample_lines_batch.launches += 1
        return plain(*a, **kw)

    monkeypatch.setattr(CR, 'resample_lines_batch_plain', k1)


def test_api_cache_rules():
    """graphs=True takes the device's process-wide cache (eager on the
    CPU: nothing to clone), False an eager cache, a GraphCache itself."""
    cache, clone = G.api_cache(True, 'cpu')
    assert cache.mode == 'eager' and not clone
    assert cache.max_keys == G.API_KEYS
    assert G.api_cache(True, 'cpu')[0] is cache
    assert G.api_cache(False, 'cpu')[0].mode == 'eager'
    mine = emulated()
    assert G.api_cache(mine, 'cpu') == (mine, False)
    x = {'a': torch.arange(3), 'b': [torch.ones(2), 7]}
    y = G.owned(x)
    assert torch.equal(y['a'], x['a']) and y['b'][1] == 7
    assert y['a'].data_ptr() != x['a'].data_ptr()


def test_bounded_cache_drops_the_least_recently_called():
    """A cache of max_keys 2 fed another tensor to read in place on each
    key (a key each) holds at most 2 keys, warmed up or captured, and
    drops the one called least recently; a key it dropped warms up again,
    and every call's result is right."""
    cache = GraphCache('cpu', 'emulate', max_keys=2)
    x = torch.arange(4.0)
    rs = [torch.full((4,), float(k)) for k in range(4)]

    def call(k):
        out = cache('scale', lambda x, r=rs[k]: r * x, (x,), reads=(rs[k],))
        assert torch.equal(out, k * x)
        assert len(cache._order) <= 2 and len(cache._seen) <= 2
        assert len(cache._graphs) <= 2 and len(cache.capture_seconds) <= 2

    for k in (0, 0, 1, 1, 0, 2, 2):
        call(k)
    held = [full[1][0][0] for full in cache._order]
    assert held == [rs[0].data_ptr(), rs[2].data_ptr()]   # 1 went
    c = cache.counts
    assert (c['eager_warmups'], c['captures'], c['replays']) == (3, 3, 4)
    for k in (1, 1, 3):
        call(k)
    assert cache.counts['eager_warmups'] == 5
    assert cache.counts['captures'] == 4


# ---------------------------------------------------------------------------
# the device weave


def _fields(rng, nbatches=6, per=3):
    """Batch pictures (per, 263, 910) int32 of random 16-bit samples (of
    every other batch below the white-flag level) and the fields of 8
    frames with their merged VBI: pairs (1, 2), (3, 4), ... of the fields
    in batch order, so the pairs of fields 5-6 and 11-12 straddle two
    batches of 3; the line counts vary, so do half, the longer field and
    the tail, and the VBI varies the frame number, CLV/CAV and CX.  Each
    field carries the white flag the host reads from its picture, as the
    batch call computes it on the device."""
    pics = [torch.from_numpy(rng.integers(0, 40000 if k % 2 else 1 << 16,
                                          (per, 263, 910)).astype(np.int32))
            for k in range(nbatches)]
    counts = [(263, 262), (262, 263), (262, 262)]
    scale = (0xc800 - 0x0400) / (100 - NTSC.sys.vsync_ire)
    frames = []
    for j in range(8):
        pair = []
        for n, istop in ((2 * j + 1, True), (2 * j + 2, False)):
            b, i = divmod(n, per)
            lc = counts[j % 3][0 if istop else 1]
            white = TM.white_flag(
                pics[b][i].reshape(-1)[:lc * 910].numpy().astype(np.uint16),
                910, lc, 11, scale, 1024, NTSC.sys.vsync_ire)
            pair.append(FieldResult(True, 0, istop=istop, linecount=lc,
                                    dev_picture=(pics[b], i),
                                    white_flag=white))
        vbi = {'framenr': int(rng.integers(0, 1 << 20)),
               'isclv': j % 4 == 3,
               'status': 0x8DC000 if j % 2 else None}
        frames.append((pair, vbi))
    return frames


def _framer(graphs):
    bank = TF.make_demod_bank(NTSC, np.complex64, device='cpu')
    return TFR.Framer(NTSC, bank, capture=np.zeros(1 << 20, np.int16),
                      batch=1, device='cpu', graphs=graphs)


def _host_pair(pair):
    """The pair with its device pictures fetched: the host weave's input."""
    out = []
    for f in pair:
        pics, i = f.dev_picture
        out.append(FieldResult(True, 0, istop=f.istop, linecount=f.linecount,
                               dspicture=pics[i].reshape(-1)[
                                   :f.linecount * 910].numpy().astype(
                                       np.uint16)))
    return out


def test_weave_protocol_equals_eager():
    """8 frames woven with their words, 2 of them from pairs that straddle
    two batches, all kept until the end (as CombWindows keeps a window of
    8): through the emulated protocol (1 warm-up, then 7 replays, the
    first of them the capture's)
    equal to eager and to the host weave, bit for bit.  The Framer clones
    each replay's frame; the function alone returns the graph's static
    output, which the next call overwrites."""
    frames = _fields(np.random.default_rng(5))
    fe, fg = _framer(False), _framer(emulated())
    eager = [fe.formatoutput(p, v) for p, v in frames]
    graphed = [fg.formatoutput(p, v) for p, v in frames]
    c = fg.weave_graphs.counts
    assert (c['eager_warmups'], c['captures'], c['replays']) == (1, 1, 7)
    assert fe.weave_graphs.counts['replays'] == 0
    assert sum(p[0].dev_picture[0] is not p[1].dev_picture[0]
               for p, _ in frames) == 2
    whites = set()
    for (pair, vbi), e, g in zip(frames, eager, graphed):
        assert e.dtype == g.dtype == torch.int32 and torch.equal(e, g)
        host = fe.formatoutput(_host_pair(pair), vbi)
        assert host.dtype == np.uint16
        np.testing.assert_array_equal(g.numpy().astype(np.uint16), host)
        np.testing.assert_array_equal(
            g[:16].numpy(), TM.frame_metadata_words(pair, vbi, NTSC))
        whites.add(tuple(f.white_flag for f in pair))
    assert len(whites) > 1

    cache = emulated()
    (pa, ia), (pb, ib) = (f.dev_picture for f in frames[1][0])
    outs = [TFR.weave_device(pa, ia, pb, ib, 262, 0, True, 525, w, cache)
            for w in ([1] * 16, [2] * 16, [3] * 16)]
    assert outs[1].data_ptr() == outs[2].data_ptr()
    assert outs[1][0] == 3


# ---------------------------------------------------------------------------
# field_analyze_batch / field_finish_batch


@pytest.fixture(scope='module')
def ntsc_batches():
    """Framer-locked 2-field windows of a 3-frame NTSC capture at field
    offsets 0, 1 and 2, with their host line tables."""
    cap = TE.encode_frames(NTSC, 3, TE.EncodeSpec(pattern='ramp',
                                                  cav_start_frame=900))
    bank = TF.make_demod_bank(NTSC, np.complex64, device='cpu')
    capt = torch.from_numpy(cap.astype(np.float32))
    nblk, pitch = 52, int(round(NTSC.freq_hz / NTSC.sys.fps / 2))
    fr = TFR.Framer(NTSC, bank, capture=cap, batch=1, nblocks=nblk,
                    device='cpu')
    f0, rs0, _ = fr.readfield(None, 33046)
    rs0 = int(f0.readsample if f0.readsample >= 0 else rs0)
    calls = []
    for k in range(3):
        starts = TFU.pipeline_starts(rs0, k, 2, pitch, cap.shape[0], NTSC,
                                     nblk)
        _v, _a, lld, lc, valid, *_ = TFU.pipeline_analyze(
            capt, starts, 1.0, bank, NTSC, nblk)
        assert valid.all()
        calls.append((starts, lld.lli, lld.llf, lld.bad, lc,
                       torch.tensor([1e-5 * k, 2e-5], dtype=torch.float32),
                       1.0 - 0.1 * k))
    return capt, bank, nblk, calls


def test_analyze_finish_protocol_equals_eager(ntsc_batches, counted):
    """field_analyze_batch and field_finish_batch at B = 2 over 3 calls
    whose starts, tables, audio offsets and mtf_level differ: through one
    emulated cache (the finish fed the analyze's static outputs) equal to
    eager bit for bit, 2 keys each warmed up, then captured and replayed,
    K1's 3 launches a call (the picture and the two burst windows) the
    same both ways."""
    capt, bank, nblk, calls = ntsc_batches
    n_audio1 = nblk * bank.a_stage1_keep
    cache = emulated()
    launches = []
    for graphs in (False, cache):
        CR.resample_lines_batch.launches = 0
        per = []
        for starts, lli, llf, bad, lc, offs, mtf in calls:
            video, audio1, idx, val = TFU.field_analyze_batch(
                capt, starts, bank, NTSC, nblk, mtf, graphs=graphs)
            fin = TFU.field_finish_batch(video, audio1, lli, llf, bad, lc,
                                         offs, bank, NTSC, n_audio1,
                                         graphs=graphs)
            per.append(G.owned(((video, audio1, idx, val), fin)))
        launches.append(CR.resample_lines_batch.launches)
        if graphs is False:
            eager = per
    for e, g in zip(eager, per):
        _assert_same(e, g)
    assert launches == [9, 9]
    c = cache.counts
    assert (c['eager_warmups'], c['captures'], c['replays']) == (2, 2, 4)
    assert not torch.equal(eager[0][1]['picture'], eager[1][1]['picture'])


def test_analyze_with_fresh_captures_holds_bounded_keys(ntsc_batches):
    """field_analyze_batch called twice on each of 3 fresh copies of the
    capture (each a key: the capture is read in place) through a cache
    bounded as the process-wide one is, here to 2 keys: at most 2 held,
    each result equal to eager bit for bit."""
    capt, bank, nblk, calls = ntsc_batches
    starts, mtf = calls[0][0], calls[0][-1]
    want = TFU.field_analyze_batch(capt, starts, bank, NTSC, nblk, mtf,
                                   graphs=False)
    cache = GraphCache('cpu', 'emulate', max_keys=2)
    for _ in range(3):
        fresh = capt.clone()
        for _ in range(2):
            _assert_same(want, G.owned(TFU.field_analyze_batch(
                fresh, starts, bank, NTSC, nblk, mtf, graphs=cache)))
        assert len(cache._order) <= 2 and len(cache._graphs) <= 2
    assert cache.counts['captures'] == 3


# ---------------------------------------------------------------------------
# decode_vhs and the legacy PAL comb


def test_decode_vhs_protocol_equals_eager():
    """decode_vhs on 3 short windows (nblocks 8) of a seeded signal: the
    emulated protocol equals eager, luma, demod taps and audio carriers."""
    cfg = TV.vhs_config()
    bank = TV.make_vhs_bank(cfg, device='cpu')
    n = TD.stream_len(cfg, 8)
    rng = np.random.default_rng(9)
    cache = emulated()
    for _ in range(3):
        x = torch.from_numpy(rng.normal(32768, 6000, n).astype(np.float32))
        want = TV.decode_vhs(x, bank, cfg, 8, graphs=False)
        got = G.owned(TV.decode_vhs(x, bank, cfg, 8, graphs=cache))
        _assert_same(want, got)
        assert set(got[0]) >= {'luma', 'demod', 'demod_sync'}
    c = cache.counts
    assert (c['eager_warmups'], c['captures'], c['replays']) == (1, 1, 2)


def test_legacy_pal_comb_protocol_equals_eager():
    """LegacyPALComb at dim 3 (the primer frame, then the one-frame-old
    slot) over 3 seeded frames, and comb_pal_legacy_frame at dim 2: the
    emulated protocol equals eager bit for bit."""
    frames = [synth_frame(seed=i) for i in range(3)]
    cfg = LP.LegacyPALConfig(dim=3)
    eager = LP.LegacyPALComb(cfg, device='cpu', graphs=False)
    graphed = LP.LegacyPALComb(cfg, device='cpu', graphs=emulated())
    for f in frames:
        np.testing.assert_array_equal(graphed.process(f), eager.process(f))
    c = graphed.graphs.counts
    assert (c['eager_warmups'], c['captures'], c['replays']) == (1, 1, 2)

    cache = emulated()
    cfg2 = LP.LegacyPALConfig(dim=2)
    for f in frames:
        raw = torch.from_numpy(f.reshape(LP.L_Y, LP.L_X).astype(np.int32))
        _assert_same(LP.comb_pal_legacy_frame(raw, cfg2, graphs=False),
                     LP.comb_pal_legacy_frame(raw, cfg2, graphs=cache))
