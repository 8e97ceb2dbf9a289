"""PyTorch port: the capture widening (tbc/cuda_widen.py and
tbc/framer.py::to_device_capture), a capture's integer samples to the
float32 device capture.

On the CPU: the host route is the float32 conversion and the signed
recentre for every loader's type; the kernel's in-place schedule covers
[0, n) once and never overwrites a sample before it is read (checked byte
by byte at small n and by its closed form up to 2^28); an emulation of the
kernel on a byte buffer gives the host route's bits; the host route is
counted; a card output refuses samples the kernel does not take, with no
host fallback.  On the card (marked `cuda`): the kernel is bit-equal to
the host route, allocates nothing, counts its launches and raises on a
launch it refuses, and a segmented decode gives the same frames, audio
and line locations as one through the host route, and as one whose swaps
all load on the decode's thread instead of taking the samples read ahead
into pinned memory."""

import gc
import math

import numpy as np
import pytest
import torch

import lddecode_torch
from ld_decode_tpu_torch.io import loaders as TL
from ld_decode_tpu_torch.models import encode as TE
from ld_decode_tpu_torch.ops import filters as TF
from ld_decode_tpu_torch.tbc import cuda_widen as CW
from ld_decode_tpu_torch.tbc import framer as TFR
from ld_decode_tpu_torch.utils import log
from ld_decode_tpu_torch.utils import spans as S
from ld_decode_tpu_torch.utils.params import DecoderConfig

torch.set_num_threads(2)

DTYPES = [np.uint8, np.int8, np.uint16, np.int16]
# odd, not a multiple of 4, a multiple of 4, one sample
LENGTHS = [1, 7, 1001, 4096, 65535]


def _samples(dtype, n, seed=0):
    info = np.iinfo(dtype)
    rng = np.random.default_rng(seed)
    return rng.integers(info.min, info.max + 1, n, dtype=np.int64).astype(
        dtype)


def _expected(arr):
    """The recentre and conversion, written out apart from the module."""
    if np.issubdtype(arr.dtype, np.signedinteger):
        return (arr.astype(np.int64) + 32768).astype(np.float32)
    return arr.astype(np.float32)


# ---------------------------------------------------------------------------
# the host route


@pytest.mark.parametrize('n', LENGTHS)
@pytest.mark.parametrize('dtype', DTYPES, ids=lambda d: np.dtype(d).name)
def test_host_route_is_the_float32_conversion(dtype, n):
    """to_device_capture on the CPU: out[:n] the samples' float32 (signed
    ones recentred), out[n:] zeroed over the old contents; without out a
    tensor of the samples' length; the plain version the same bits."""
    arr = _samples(dtype, n, seed=n)
    want = _expected(arr)
    assert np.array_equal(CW.widen_plain(arr).view(np.uint32),
                          want.view(np.uint32))
    out = torch.full((n + 37,), float('nan'))
    got = TFR.to_device_capture(arr, 'cpu', out=out)
    assert got is out
    assert np.array_equal(out[:n].numpy().view(np.uint32),
                          want.view(np.uint32))
    assert not out[n:].any()
    whole = TFR.to_device_capture(arr, 'cpu')
    assert whole.dtype == torch.float32 and whole.shape == (n,)
    assert np.array_equal(whole.numpy(), want)


def test_host_route_is_counted(capsys):
    """Each widening on the host adds one to routes['host'] and none to
    'card'; `lddecode_torch.py -d` prints the counts with the spans."""
    card, host = CW.routes['card'], CW.routes['host']
    arr = _samples(np.uint16, 100)
    TFR.to_device_capture(arr, 'cpu', out=torch.empty(128))
    TFR.to_device_capture(arr.astype(np.float64), 'cpu')
    assert CW.routes == {'card': card, 'host': host + 2}
    level = log.get_level()
    try:
        log.set_level(log.DEBUG)
        lddecode_torch.log_spans()
    finally:
        log.set_level(level)
    assert (f'capture widening: {card} on the card '
            f'({CW.widen.launches} launches), {host + 2} on the host'
            in capsys.readouterr().err)


@pytest.mark.parametrize('dtype,kind', [
    (np.uint8, 0), (np.int8, 1), (np.uint16, 2), (np.int16, 3),
    ('<i2', 3), ('>i2', None), ('>u2', None), (np.int32, None),
    (np.uint32, None), (np.float32, None), (np.float64, None),
    (np.bool_, None)])
def test_the_kernel_takes_native_small_integers(dtype, kind):
    assert CW.card_kind(dtype) == kind


@pytest.mark.parametrize('dtype', [np.float32, np.float64, '>u2', '>i2',
                                   np.int32, np.uint32])
def test_a_card_output_refuses_samples_the_kernel_cannot_take(dtype):
    """The card has one route: samples it does not take raise, before any
    allocation or launch (so this holds on the CPU too), and nothing is
    widened on the host in their place."""
    arr = np.arange(64).astype(dtype)
    routes = dict(CW.routes)
    with pytest.raises(ValueError, match='native byte order'):
        TFR.to_device_capture(arr, 'cuda')
    with pytest.raises(ValueError, match='native byte order'):
        TFR.to_device_capture(np.zeros((2, 8), np.uint16), 'cuda')
    assert CW.routes == routes


def test_the_card_route_refuses_what_it_cannot_take():
    """The checks come before any launch, so they hold on the CPU too."""
    arr = _samples(np.uint16, 10)
    with pytest.raises(ValueError, match='CUDA'):
        CW.stage(arr, torch.empty(10))
    with pytest.raises(ValueError, match='CUDA'):
        CW.widen(torch.empty(10), 10, 2)
    with pytest.raises(ValueError, match='1-D'):
        CW.stage(arr.reshape(2, 5), torch.empty(10))
    with pytest.raises(ValueError, match='1-D'):
        CW.stage(arr.astype(np.float32), torch.empty(10))
    with pytest.raises(ValueError, match='itemsize'):
        CW.widen_schedule(10, 4)


# ---------------------------------------------------------------------------
# the in-place schedule


def _overwritten(i, n, s):
    """The inputs other than i whose bytes output i overwrites: input j
    lies at bytes [(4-s)n + s*j, +s), output i at [4i, 4i+4)."""
    base = (4 - s) * n
    lo = max(0, (4 * i - base) // s)
    hi = min(n - 1, (4 * i + 3 - base) // s)
    return [j for j in range(lo, hi + 1) if j != i
            and base + s * j < 4 * i + 4 and base + s * j + s > 4 * i]


def _check_bounds(bounds, n, s):
    """The ranges tile [0, n) in order, each one's overwritten inputs lie
    before it (the last sample alone may overwrite its own), and there are
    at most 2 + log2(n) of them."""
    assert bounds[0] == 0 and bounds[-1] == n
    assert all(a < b for a, b in zip(bounds, bounds[1:]))
    base = (4 - s) * n
    for a, b in zip(bounds, bounds[1:]):
        if (a, b) == (n - 1, n):
            # the last sample's other overwritten inputs lie below it
            continue
        # writes [4a, 4b) against the range's reads [base + s*a, ...)
        assert 4 * b <= base + s * a, (n, s, a, b)
    assert len(bounds) - 1 <= 2 + math.log2(n)


@pytest.mark.parametrize('s', [1, 2])
def test_schedule_overwrites_only_inputs_already_read_small_n(s):
    """Byte by byte: for every n up to 300, each output's overwritten
    inputs belong to earlier ranges."""
    for n in range(1, 301):
        bounds = CW.widen_schedule(n, s)
        _check_bounds(bounds, n, s)
        for a, b in zip(bounds, bounds[1:]):
            for i in range(a, b):
                assert all(j < a for j in _overwritten(i, n, s)), (n, i)


@pytest.mark.parametrize('s', [1, 2])
def test_schedule_overwrites_only_inputs_already_read_up_to_2_28(s):
    """By the closed form: every n up to 2^14, 400 drawn up to 2^20, and
    the powers of two to 2^28 and their neighbours (2^28: the cells'
    segment)."""
    rng = np.random.default_rng(7)
    ns = list(range(1, 1 << 14)) \
        + [int(x) for x in rng.integers(1 << 14, 1 << 20, 400)] \
        + [(1 << k) + d for k in range(14, 29) for d in (-3, -1, 0, 1, 5)]
    for n in ns:
        _check_bounds(CW.widen_schedule(n, s), n, s)
    assert len(CW.widen_schedule(1 << 28, 2)) - 1 == 29
    assert CW.widen_schedule(0, 2) == []


def _emulate(arr, total):
    """The kernel on a byte buffer: stage's placement, then each range in
    turn reads all of its inputs from the buffer as it stands before
    writing any output (a launch's threads in any order), then the
    memset of the tail.  Returns the float32 buffer."""
    n, s = arr.shape[0], arr.dtype.itemsize
    buf = np.full(4 * total, 0xA5, np.uint8)
    buf[(4 - s) * n:4 * n] = arr.view(np.uint8)
    bias = 32768 if np.issubdtype(arr.dtype, np.signedinteger) else 0
    bounds = CW.widen_schedule(n, s)
    for a, b in zip(bounds, bounds[1:]):
        x = buf[(4 - s) * n + s * a:(4 - s) * n + s * b].copy().view(
            arr.dtype)
        buf[4 * a:4 * b] = (x.astype(np.int32) + bias).astype(
            np.float32).view(np.uint8)
    buf[4 * n:] = 0
    return buf.view(np.float32)


@pytest.mark.parametrize('n', LENGTHS + [3, 5, 262147])
@pytest.mark.parametrize('dtype', DTYPES, ids=lambda d: np.dtype(d).name)
def test_emulated_kernel_gives_the_host_routes_bits(dtype, n):
    arr = _samples(dtype, n, seed=n + 1)
    got = _emulate(arr, n + 13)
    assert np.array_equal(got[:n].view(np.uint32),
                          CW.widen_plain(arr).view(np.uint32))
    assert not got[n:].any()


# ---------------------------------------------------------------------------
# the card


def _card():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device (the kernel has no CPU mode)')


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', DTYPES, ids=lambda d: np.dtype(d).name)
def test_card_kernel_equals_the_host_route(dtype):
    """The kernel against the plain version, bit for bit: one buffer
    reused (its old contents left in it) for n equal to it, shorter, odd,
    and 1; each call adds its schedule's launches and one card route; the
    whole-capture path (no out) too."""
    _card()
    total = (1 << 26) + 5
    out = torch.full((total,), float('nan'), device='cuda')
    s = np.dtype(dtype).itemsize
    for k, n in enumerate((total, total - 12345, 1001, 1)):
        arr = _samples(dtype, n, seed=k)
        launches, routes = CW.widen.launches, dict(CW.routes)
        got = TFR.to_device_capture(arr, 'cuda', out=out)
        torch.cuda.synchronize()
        assert got is out
        assert CW.widen.launches == launches + len(
            CW.widen_schedule(n, s)) - 1
        assert CW.routes == {'card': routes['card'] + 1,
                             'host': routes['host']}
        host = out.cpu().numpy()
        assert np.array_equal(host[:n].view(np.uint32),
                              CW.widen_plain(arr).view(np.uint32)), n
        assert not host[n:].any(), n
    arr = _samples(dtype, 100003, seed=9)
    whole = TFR.to_device_capture(arr, 'cuda')
    assert whole.device.type == 'cuda' and whole.shape == (100003,)
    assert np.array_equal(whole.cpu().numpy(), CW.widen_plain(arr))


@pytest.mark.cuda
def test_card_swap_allocates_nothing():
    """A swap into the resident buffer leaves the card's allocation as it
    was and never rises above it, even for a moment."""
    _card()
    out = torch.empty(1 << 26, device='cuda')
    arr = _samples(np.uint16, (1 << 26) - 99)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    TFR.to_device_capture(arr, 'cuda', out=out)
    torch.cuda.synchronize()
    assert torch.cuda.memory_allocated() == held
    assert torch.cuda.max_memory_allocated() == held


@pytest.mark.cuda
def test_card_refused_launch_raises(monkeypatch):
    """A schedule that would overwrite samples before they are read, one
    that misses the samples' end, and an unknown kind: the launcher
    refuses each before any launch and the wrapper raises."""
    _card()
    n = 4096
    out = torch.empty(n, device='cuda')
    arr = _samples(np.uint16, n)
    CW.stage(arr, out)
    launches, card = CW.widen.launches, CW.routes['card']
    with pytest.raises(RuntimeError, match='cudaError'):
        CW.widen(out, n, 7)
    for bounds in ([0, n], [0, n // 2, n - 1], [0, n // 2, n // 2, n]):
        with monkeypatch.context() as m:
            m.setattr(CW, 'widen_schedule', lambda *a, b=bounds: b)
            with pytest.raises(RuntimeError, match='cudaError'):
                CW.widen(out, n, 2)
    assert (CW.widen.launches, CW.routes['card']) == (launches, card)
    CW.widen(out, n, 2)
    assert np.array_equal(out.cpu().numpy(), CW.widen_plain(arr))


def _decode(path, frames=8):
    cfg = DecoderConfig(system='NTSC', freq_mhz=40.0)
    bank = TF.make_demod_bank(cfg, device='cuda')
    fr = TFR.Framer(cfg, bank, TL.loader_for_path(str(path)), batch=2,
                    segment_samples=1, device='cuda')
    out, s = [], 33046
    with open(path, 'rb') as fd:
        for i in range(frames):
            combined, audio, nxt, fields = fr.readframe(fd, s, i == 0)
            assert combined is not None
            out.append((np.asarray(combined), np.asarray(audio),
                        [np.asarray(f.linelocs) for f in fields], nxt))
            s = nxt
    return out


def _host_route(samples, device, out=None):
    """to_device_capture through the plain version: the float32 conversion
    on the host, then the copy into out and the tail's zeroing."""
    host = torch.from_numpy(CW.widen_plain(samples))
    n = host.shape[0]
    out[:n].copy_(host)
    out[n:].zero_()
    return out


@pytest.mark.cuda
def test_card_segmented_decode_equals_the_host_route(tmp_path, monkeypatch):
    """A segmented decode on the card (8 frames over the smallest segment,
    so they cross swaps) gives the same frames, audio and line locations
    with the kernel as with each segment widened by the plain version on
    the host, and every swap took the kernel."""
    _card()
    cfg = DecoderConfig(system='NTSC', freq_mhz=40.0)
    samples = TE.encode_frames(cfg, 12, TE.EncodeSpec(pattern='ramp',
                                                      cav_start_frame=900))
    path = tmp_path / 'cap.lds'
    path.write_bytes(TL.pack_data_4_40(samples).tobytes())
    card = CW.routes['card']
    got = _decode(path)
    swaps = CW.routes['card'] - card
    assert swaps >= 2
    monkeypatch.setattr(TFR, 'to_device_capture', _host_route)
    host = CW.routes['host']
    want = _decode(path)
    assert CW.routes['host'] - host == swaps
    for (fa, aa, la, na), (fb, ab, lb, nb) in zip(got, want):
        assert na == nb
        assert np.array_equal(fa, fb)
        assert np.array_equal(aa, ab)
        assert all(np.array_equal(x, y) for x, y in zip(la, lb))


@pytest.mark.cuda
def test_card_read_ahead_equals_loading_at_each_swap(tmp_path):
    """A segmented decode on the card (8 frames over the smallest segment)
    whose later swaps take the samples read ahead, copied asynchronously
    from the pinned staging buffer, gives the same frames, audio and line
    locations as the same decode with every swap loading on the decode's
    thread.  Both Framers are collected before it returns: their device
    buffers are not left to a later test's count."""
    _card()
    cfg = DecoderConfig(system='NTSC', freq_mhz=40.0)
    samples = TE.encode_frames(cfg, 12, TE.EncodeSpec(pattern='ramp',
                                                      cav_start_frame=900))
    path = tmp_path / 'cap.lds'
    path.write_bytes(TL.pack_data_4_40(samples).tobytes())
    bank = TF.make_demod_bank(cfg, device='cuda')
    runs = {}
    for mode in ('ahead', 'load'):
        S.reset()
        fr = TFR.Framer(cfg, bank, TL.loader_for_path(str(path)), batch=2,
                        segment_samples=1, device='cuda')
        if mode == 'load':
            fr._staged = lambda ahead, base, n: None
        out, s = [], 33046
        with open(path, 'rb') as fd:
            for i in range(8):
                combined, audio, nxt, fields = fr.readframe(fd, s, i == 0)
                assert combined is not None
                out.append((np.asarray(combined), np.asarray(audio),
                            [np.asarray(f.linelocs) for f in fields], nxt))
                s = nxt
            fr.close()
        assert fr._stage.is_pinned()
        runs[mode] = (out, S.totals().get('segment.take', (0,))[0])
        del fr
        gc.collect()
    (got, ahead), (want, load) = runs['ahead'], runs['load']
    assert ahead >= 1 and load == 0
    for (fa, aa, la, na), (fb, ab, lb, nb) in zip(got, want):
        assert na == nb
        assert np.array_equal(fa, fb)
        assert np.array_equal(aa, ab)
        assert all(np.array_equal(x, y) for x, y in zip(la, lb))
