"""PyTorch port: its copies of the JAX package's numpy host modules (the
port imports nothing of the JAX package) behave exactly as the originals:
every output equal in memory."""

import contextlib
import ctypes
import dataclasses
import io
import mmap
import os
import types

import numpy as np
import pytest
import scipy.signal as sps

from ld_decode_tpu.audio import cx as JCX
from ld_decode_tpu.audio.downscale import downscale_audio as j_downscale
from ld_decode_tpu.comb.comb_ntsc import PulldownAssembler as JPulldown
from ld_decode_tpu.io import export_sink as JS
from ld_decode_tpu.io import loaders as JL
from ld_decode_tpu.models import encode as JE
from ld_decode_tpu.tbc.despackle import despackle as j_despackle
from ld_decode_tpu.utils import fdls as JFD
from ld_decode_tpu.utils import filtermaker as JFM
from ld_decode_tpu.utils import filtertools as JFT
from ld_decode_tpu.utils import params as JP
from ld_decode_tpu.vbi import iec60857 as JIEC
from ld_decode_tpu.vbi import metadata as JM
from ld_decode_tpu.vbi import philips as JPH
from ld_decode_tpu_torch.audio import cx as TCX
from ld_decode_tpu_torch.audio.downscale import downscale_audio as t_downscale
from ld_decode_tpu_torch.comb.comb_ntsc import PulldownAssembler as TPulldown
from ld_decode_tpu_torch.io import export_sink as TS
from ld_decode_tpu_torch.io import loaders as TL
from ld_decode_tpu_torch.io import native_unpack as TNU
from ld_decode_tpu_torch.models import encode as TE
from ld_decode_tpu_torch.tbc.despackle import despackle as t_despackle
from ld_decode_tpu_torch.utils import fdls as TFD
from ld_decode_tpu_torch.utils import filtermaker as TFM
from ld_decode_tpu_torch.utils import filtertools as TFT
from ld_decode_tpu_torch.utils import params as TP
from ld_decode_tpu_torch.vbi import iec60857 as TIEC
from ld_decode_tpu_torch.vbi import metadata as TM
from ld_decode_tpu_torch.vbi import philips as TPH


@pytest.mark.parametrize('system', ['NTSC', 'PAL', 'VHS'])
def test_params_equal(system):
    assert dataclasses.asdict(TP.sys_params(system)) \
        == dataclasses.asdict(JP.sys_params(system))
    assert dataclasses.asdict(TP.rf_params(system)) \
        == dataclasses.asdict(JP.rf_params(system))
    tc, jc = TP.DecoderConfig(system=system), JP.DecoderConfig(system=system)
    for name in ('linelen', 'linelen_float', 'block_keep', 'freq_hz_half'):
        assert getattr(tc, name) == getattr(jc, name), name
    assert tc.iretohz(-40) == jc.iretohz(-40)


@pytest.mark.parametrize('system,pattern', [('NTSC', 'ramp'),
                                            ('PAL', 'palbars')])
def test_encode_frames_equal(system, pattern):
    spec = dict(pattern=pattern, cav_start_frame=900, noise_rms=0.01)
    a = TE.encode_frames(TP.DecoderConfig(system=system), 1,
                         TE.EncodeSpec(**spec), seed=3)
    b = JE.encode_frames(JP.DecoderConfig(system=system), 1,
                         JE.EncodeSpec(**spec), seed=3)
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize('ext', ['.lds', '.r30', '.r16', '.u8'])
def test_loaders_equal(ext):
    rng = np.random.default_rng(8)
    s = rng.integers(0, 1024, 40001)
    raw = {'.lds': lambda: TL.pack_data_4_40(s).tobytes(),
           '.r30': lambda: TL.pack_data_3_32(s).tobytes(),
           '.r16': lambda: (s - 512).astype('<i2').tobytes(),
           '.u8': lambda: (s >> 2).astype(np.uint8).tobytes()}[ext]()
    tl, jl = TL.loader_for_path('x' + ext), JL.loader_for_path('x' + ext)
    assert TL.bytes_per_sample_for_path('x' + ext) \
        == JL.bytes_per_sample_for_path('x' + ext)
    f = io.BytesIO(raw)
    for start, n in ((0, 1000), (3, 4097), (39000, 900), (39900, 5000)):
        a, b = tl(f, start, n), jl(f, start, n)
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a, b)
    assert TL.file_samples(tl, f) == JL.file_samples(jl, f)


def test_native_unpack_source_is_a_copy():
    """csrc/unpack.cpp is native/unpack.cpp byte for byte: the port builds
    its own copy and shares no source with the JAX package."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, 'ld_decode_tpu_torch', 'csrc',
                           'unpack.cpp'), 'rb') as f:
        port = f.read()
    with open(os.path.join(root, 'native', 'unpack.cpp'), 'rb') as f:
        assert port == f.read()


@pytest.mark.parametrize('ext', ['.lds', '.r30'])
def test_native_unpack_equal(ext):
    """The C++ unpack (built with g++ into build/) against the port's numpy
    unpack and the JAX package's loaders, at every sample offset mod 4
    (.lds) or 3 (.r30); the .lds loader takes the native route and says
    so."""
    assert TNU.available()
    rng = np.random.default_rng(11)
    s = rng.integers(0, 1024, 40003)
    group = 4 if ext == '.lds' else 3
    raw = (TL.pack_data_4_40(s) if ext == '.lds' else TL.pack_data_3_32(s))
    if ext == '.lds':
        np.testing.assert_array_equal(TNU.pack_4_40(s), raw)
    f = io.BytesIO(raw.tobytes())
    tl, jl = TL.loader_for_path('x' + ext), JL.loader_for_path('x' + ext)
    for start in [k + 1000 * group for k in range(group)] + [39990]:
        for n in (1, 4097, 12):
            want = jl(f, start, n)
            if want is None:
                continue
            off = start % group
            if ext == '.lds':
                block = raw[start // group * 5:]
                native = TNU.unpack_4_40(block, n, off)
                before = dict(TL.unpack_calls)
                got = tl(f, start, n)
                assert TL.unpack_route() == 'native'
                assert TL.unpack_calls['native'] == before['native'] + 1
                TL.set_native(False)
                try:
                    plain = tl(f, start, n)
                    assert TL.unpack_route() == 'numpy'
                    assert TL.unpack_calls['numpy'] == before['numpy'] + 1
                finally:
                    TL.set_native(True)
            else:
                native = TNU.unpack_3_32(raw[start // group:], n, off)
                got = plain = tl(f, start, n)
            np.testing.assert_array_equal(native, want)
            np.testing.assert_array_equal(native, s[start:start + n])
            for a in (got, plain):
                assert a.dtype == want.dtype
                np.testing.assert_array_equal(a, want)


@contextlib.contextmanager
def _before_a_guard_page(raw: np.ndarray):
    """`raw` copied to end where an unreadable page begins: an unpack that
    reads past its last byte faults."""
    page = mmap.PAGESIZE
    body = -(-max(len(raw), 1) // page) * page
    buf = np.frombuffer(mmap.mmap(-1, body + page), np.uint8)
    libc = ctypes.CDLL(None, use_errno=True)
    libc.mprotect.argtypes = [ctypes.c_void_p, ctypes.c_size_t, ctypes.c_int]
    guard = buf.ctypes.data + body
    buf[body - len(raw):body] = raw
    assert libc.mprotect(guard, page, 0) == 0          # PROT_NONE
    try:
        yield buf[body - len(raw):body]
    finally:
        libc.mprotect(guard, page, mmap.PROT_READ | mmap.PROT_WRITE)


@pytest.mark.parametrize('groups', ['one', 'prime', 'threads-1',
                                    'threads+1'])
@pytest.mark.parametrize('threads', [1, 2, 3, 7])
def test_threaded_unpack_equal(threads, groups, monkeypatch):
    """The .lds unpack split across threads (csrc/unpack_threads.cpp) against
    the same on one thread and the numpy route, bit for bit: every sample
    offset mod 4, read lengths that end inside a group, group counts that
    split unevenly or leave threads without a group (the library then runs
    fewer, down to one), the input ending where an unreadable page
    begins."""
    n = {'one': 1, 'prime': 1009, 'threads-1': threads - 1,
         'threads+1': threads + 1}[groups]
    s = np.random.default_rng(21 + n).integers(0, 1024, n * 4)
    with _before_a_guard_page(TL.pack_data_4_40(s)) as raw:
        assert len(raw) == n * 5
        for off in range(4):
            for readlen in sorted({max(n * 4 - off - k, 0)
                                   for k in range(4)}):
                with monkeypatch.context() as mp:
                    mp.setattr(TNU, 'threads_for', lambda g: threads)
                    got = TNU.unpack_4_40(raw, readlen, off)
                    assert TNU.last_threads == threads
                with monkeypatch.context() as mp:
                    mp.setattr(TNU, 'threads_for', lambda g: 1)
                    one = TNU.unpack_4_40(raw, readlen, off)
                TL.set_native(False)
                try:
                    plain = TL.unpack_data_4_40(raw, readlen, off)
                finally:
                    TL.set_native(True)
                for a in (got, one, plain):
                    assert a.dtype == np.uint16 and len(a) == readlen
                    np.testing.assert_array_equal(a, s[off:off + readlen])


def test_unpack_splits_above_the_crossover(monkeypatch):
    """A loader read splits its unpack across the cores (four here) once
    every thread gets MIN_GROUPS_PER_THREAD groups, and counts it in
    unpack_threads; a read just below stays on one thread, as the
    --batch 1 path's field window (1,012,704 samples) does on any host."""
    monkeypatch.setattr(os, 'sched_getaffinity', lambda pid: set(range(4)))
    monkeypatch.setattr(TNU, 'quota_cpus', lambda: None)
    m = TNU.MIN_GROUPS_PER_THREAD
    assert TNU.threads_for(1_012_704 // 4 + 2) == 1
    s = np.random.default_rng(5).integers(0, 1024, (5 * m + 2) * 4)
    f = io.BytesIO(TL.pack_data_4_40(s).tobytes())
    # a read of readlen samples at offset 0 unpacks readlen / 4 + 1 groups
    for groups, threads in ((2 * m - 1, 1), (2 * m, 2), (3 * m + 1, 3),
                            (5 * m + 1, 4)):
        readlen = (groups - 1) * 4
        before = dict(TL.unpack_threads)
        got = TL.load_packed_4_40(f, 0, readlen)
        np.testing.assert_array_equal(got, s[:readlen])
        assert TNU.last_threads == threads
        split = TL.unpack_threads['split'] - before['split']
        assert split == (threads > 1)
        if threads > 1:
            assert TL.unpack_threads['threads'] == threads


# /proc/self/cgroup and the quota files of each layout, and the CPUs it
# allows: v2 (cpu.max) and v1 (cpu.cfs_*) hierarchies, the smallest
# quota over a cgroup and its ancestors, unset quotas
_CGROUPS = {
    'v2': ({'proc/self/cgroup': '0::/a/b\n',
            'sys/fs/cgroup/a/b/cpu.max': '250000 100000\n'}, 3),
    'v2-unset': ({'proc/self/cgroup': '0::/a/b\n',
                  'sys/fs/cgroup/a/b/cpu.max': 'max 100000\n',
                  'sys/fs/cgroup/cpu.max': 'max 100000\n'}, None),
    'v2-ancestor': ({'proc/self/cgroup': '0::/a/b\n',
                     'sys/fs/cgroup/a/b/cpu.max': 'max 100000\n',
                     'sys/fs/cgroup/a/cpu.max': '150000 100000\n'}, 2),
    'v1': ({'proc/self/cgroup': '4:cpu,cpuacct:/x\n3:memory:/x\n0::/\n',
            'sys/fs/cgroup/cpu,cpuacct/x/cpu.cfs_quota_us': '400000\n',
            'sys/fs/cgroup/cpu,cpuacct/x/cpu.cfs_period_us': '100000\n'},
           4),
    'v1-unset': ({'proc/self/cgroup': '1:cpu:/\n0::/\n',
                  'sys/fs/cgroup/cpu/cpu.cfs_quota_us': '-1\n',
                  'sys/fs/cgroup/cpu/cpu.cfs_period_us': '100000\n'},
                 None),
    'unreadable': ({}, None),
}


@pytest.mark.parametrize('layout', sorted(_CGROUPS))
def test_cpu_quota_caps_the_threads(layout, tmp_path, monkeypatch):
    """threads_for takes no more threads than the cgroup's CPU quota
    allows, which sched_getaffinity does not see; without a quota, the
    usable cores."""
    files, want = _CGROUPS[layout]
    for name, text in files.items():
        (tmp_path / name).parent.mkdir(parents=True, exist_ok=True)
        (tmp_path / name).write_text(text)
    got = TNU.quota_cpus(str(tmp_path))
    assert got == want
    monkeypatch.setattr(os, 'sched_getaffinity', lambda pid: set(range(8)))
    monkeypatch.setattr(TNU, 'quota_cpus', lambda: got)
    assert TNU.threads_for(64 * TNU.MIN_GROUPS_PER_THREAD) == (want or 8)


def test_philips_host_equal():
    rng = np.random.default_rng(9)
    data = np.cumsum(rng.standard_normal(4000))
    for start in (0, 10.5, 1000.25, 3990):
        for target in (0.0, 5.0, -3.0):
            assert TPH.calczc_host(data, start, target, 500) \
                == JPH.calczc_host(data, start, target, 500)
    codes = [
        {16: [15, 8, 0, 9, 0, 1], 17: None, 18: [15, 8, 0, 9, 0, 1]},
        {16: [15, 3, 13, 0, 2, 7], 17: [8, 13, 12, 1, 2, 3], 18: None},
        {16: [8, 11, 14, 4, 5, 6], 17: [8, 7, 15, 15, 15, 15], 18: None},
        {16: None, 17: None, 18: None},
    ]
    for c in codes:
        assert TPH.interpret_philips(c) == JPH.interpret_philips(c)


def _field(rng, istop, framenr, white):
    pic = rng.integers(1024, 0xc800, 263 * 910).astype(np.uint16)
    if white:
        pic[10 * 910 + 2:10 * 910 + 400] = 0xc000
    lc = {16: [15, 8, 0, 9, 0, framenr % 10] if framenr else None,
          17: [8, 13, 12, 1, 2, 3], 18: None}
    return types.SimpleNamespace(
        linecode=lc, vbi=JPH.interpret_philips(lc), dspicture=pic,
        linecount=263 if istop else 262, white_flag=None)


def test_metadata_words_equal():
    rng = np.random.default_rng(10)
    cfg_t, cfg_j = TP.DecoderConfig(), JP.DecoderConfig()
    for white in (False, True):
        fields = [_field(rng, True, 901, white), _field(rng, False, 0, False)]
        vbi = dict(fields[0].vbi)
        np.testing.assert_array_equal(
            TM.frame_metadata_words(fields, vbi, cfg_t),
            JM.frame_metadata_words(fields, vbi, cfg_j))


def _pal_field(rng, istop, framenr, white):
    pic = rng.integers(256, 0xd300, 313 * 1135).astype(np.uint16)
    if white:
        pic[10 * 1135 + 2:10 * 1135 + 500] = 0xd000
    lc = {19: [15, 8, 0, 9, 0, framenr % 10] if framenr else None,
          20: [8, 13, 12, 1, 2, 3], 21: None}
    return types.SimpleNamespace(
        linecode=lc, vbi=JPH.interpret_philips(lc), dspicture=pic,
        linecount=313 if istop else 312, white_flag=None)


def test_metadata_words_equal_pal():
    """PAL: Philips code lines 19-21, the PAL scale in the white-flag
    threshold, 313/312-line fields."""
    rng = np.random.default_rng(14)
    cfg_t, cfg_j = TP.DecoderConfig(system='PAL'), JP.DecoderConfig(
        system='PAL')
    assert tuple(cfg_t.sys.philips_codelines) == (19, 20, 21)
    for white in (False, True):
        fields = [_pal_field(rng, True, 903, white),
                  _pal_field(rng, False, 0, False)]
        vbi = dict(fields[0].vbi)
        got = TM.frame_metadata_words(fields, vbi, cfg_t)
        np.testing.assert_array_equal(
            got, JM.frame_metadata_words(fields, vbi, cfg_j))
        kw = dict(out_scale=(0xd300 - 0x0100) / (100 + 300 / 7), offset=256,
                  vsync_ire=-300 / 7)
        assert TM.white_flag(fields[0].dspicture, 1135, 313, **kw) == white \
            == JM.white_flag(fields[0].dspicture, 1135, 313, **kw)


def test_despackle_equal_pal():
    rng = np.random.default_rng(15)
    frame = rng.integers(0x2000, 0xb000, 625 * 1135).astype(np.uint16)
    frame[rng.integers(0, frame.size, 300)] = 0      # rot hits
    scale = (0xd300 - 0x0100) / (100 + 300 / 7)
    np.testing.assert_array_equal(
        t_despackle(frame.copy(), 1135, scale, 256, -300 / 7),
        j_despackle(frame.copy(), 1135, scale, 256, -300 / 7))


def test_despackle_equal():
    rng = np.random.default_rng(11)
    frame = rng.integers(0x2000, 0xb000, 525 * 910).astype(np.uint16)
    frame[rng.integers(0, frame.size, 300)] = 0      # rot hits
    scale = (0xc800 - 0x0400) / 140
    np.testing.assert_array_equal(
        t_despackle(frame.copy(), 910, scale, 1024, -40.0),
        j_despackle(frame.copy(), 910, scale, 1024, -40.0))


def test_video_sink_equal(tmp_path, monkeypatch):
    """Raw rgb48 stream and per-frame images, written the same way."""
    monkeypatch.setattr(TS.shutil, 'which', lambda *_: None)
    monkeypatch.setattr(JS.shutil, 'which', lambda *_: None)
    rng = np.random.default_rng(12)
    frames = rng.integers(0, 65535, (3, 480, 744, 3)).astype(np.uint16)
    for images in (False, True):
        outs = []
        for mod, name in ((TS, 't'), (JS, 'j')):
            base = str(tmp_path / f'{name}{int(images)}')
            sink = mod.VideoSink(base, 744, 480, '30000/1001',
                                 force_raw=True, write_images=images)
            for f in frames:
                sink.write(f)
            sink.close()
            assert sink.nframes == 3
            paths = ([f'{base}_{k}.rgb' for k in range(3)] if images
                     else [base + '.rgb'])
            outs.append(b''.join(open(p, 'rb').read() for p in paths))
        assert outs[0] == outs[1] == frames.tobytes()


def test_cx_host_parts_equal():
    """Filters, the envelope host loop and the expander state chain."""
    for a, b in zip(TCX.F500 + TCX.F40, JCX.F500 + JCX.F40):
        np.testing.assert_array_equal(a, b)
    rng = np.random.default_rng(13)
    env = np.abs(rng.normal(0, 3000, 4000)) * (rng.random(4000) < 0.3)
    for got, want in zip(TCX.envelope_followers(env, 10.0, 20.0),
                         JCX.envelope_followers(env, 10.0, 20.0)):
        np.testing.assert_array_equal(got, want)
    pcm = rng.integers(-20000, 20000, 3204).astype(np.int16)
    tx, jx = TCX.CXExpander(), JCX.CXExpander()
    for chunk in (pcm, pcm[::-1].copy(), pcm.view(np.uint16)):
        np.testing.assert_array_equal(tx.process(chunk), jx.process(chunk))
    assert (tx.fast, tx.slow) == (jx.fast, jx.slow)


def test_pulldown_assembler_equal():
    """3:2 pulldown reassembly: CAV and white-flag parities, the redundant
    (flagless) frames dropped, held odd frames merged."""
    rng = np.random.default_rng(3)
    flags = [0x4, 0x8, 0x0, 0x200, 0x100, 0x4, 0x0, 0x8, 0x4]
    ja, ta = JPulldown(), TPulldown()
    for k, fl in enumerate(flags):
        rgb = rng.integers(0, 65535, (480, 744, 3)).astype(np.uint16)
        words = np.zeros(16, np.uint16)
        words[13], words[14], words[15] = fl, k >> 16, 900 + k
        je, te = ja.process(rgb, words), ta.process(rgb, words)
        assert len(je) == len(te)
        for (jf, jc), (tf, tc) in zip(je, te):
            assert jc == tc
            np.testing.assert_array_equal(jf, tf)


@pytest.mark.parametrize('system', ['NTSC', 'PAL'])
def test_downscale_audio_equal(system):
    """The 48 kHz chase of the sequential decode: ticks mapped through a
    field's wandering line table, with a time offset carried in."""
    rng = np.random.default_rng(16)
    cfg_t, cfg_j = TP.DecoderConfig(system=system), \
        JP.DecoderConfig(system=system)
    lc = cfg_t.sys.frame_lines // 2
    ll = (np.arange(lc + 4) * cfg_t.linelen + 30000.5
          + np.cumsum(rng.normal(0, 0.3, lc + 4)))
    n = 12000
    audio = {'audio_left': rng.normal(2.3e6, 5e4, n).astype(np.float32),
             'audio_right': rng.normal(2.8e6, 5e4, n).astype(np.float32)}
    for off in (0.0, 1.3e-5):
        a, ao = t_downscale(audio, ll, cfg_t, lc, off)
        b, bo = j_downscale(audio, ll, cfg_j, lc, off)
        np.testing.assert_array_equal(a, b)
        assert ao == bo and a.dtype == np.int16


# every input of tests/test_iec60857.py
IEC_CASES = [(0, 0xF80123, 0xF80123), (0x80D123, 0x88FFFF, 0),
             (0, 0x80EEEE, 0), (0, 0xF2DD35, 0), (0x82E345, 0xF0DD00, 0),
             (0, 0, 0x8A5DDD), (0x82CFFF, 0xF80001, 0),
             (0x8DC000, 0xF80001, 0), (0x8BA000, 0xF80001, 0)]


@pytest.mark.parametrize('words', IEC_CASES, ids=lambda w: '%06x-%06x-%06x'
                         % w)
def test_iec60857_equal(words):
    """The full IEC 60857 interpretation, field for field."""
    got = TIEC.interpret_iec60857(*words)
    assert dataclasses.asdict(got) == dataclasses.asdict(
        JIEC.interpret_iec60857(*words))


def test_iec60857_field_codes_equal():
    """interpret_field_codes over per-line nibble codes (through the port's
    own vbi/metadata.py nibbles_to_code), with missing and short lines."""
    codes = [
        {16: [15, 8, 0, 1, 2, 3], 17: [15, 8, 0, 1, 2, 3], 18: None},
        {16: [8, 13, 12, 1, 2, 3], 17: [8, 8, 15, 15, 15, 15], 18: None},
        {19: None, 20: [8, 0, 14, 14, 14, 14]},
        {16: [15, 2, 13, 13, 3, 5]},
        {},
    ]
    for lc in codes:
        for system in ('NTSC', 'PAL'):
            assert dataclasses.asdict(TIEC.interpret_field_codes(lc, system)) \
                == dataclasses.asdict(JIEC.interpret_field_codes(lc, system))


def test_fdls_equal():
    """FDLS designs from a target response, from a complex response and
    from an existing filter."""
    rng = np.random.default_rng(17)
    w = np.linspace(0.01, np.pi * 0.95, 64)
    am = 1.0 / (1.0 + (w / 0.6) ** 2)
    th = -0.4 * w
    for a, b in zip(TFD.fdls(w, am, th, 2, 2), JFD.fdls(w, am, th, 2, 2)):
        np.testing.assert_array_equal(a, b)
    resp = am * np.exp(1j * (th + rng.normal(0, 1e-3, w.size)))
    for a, b in zip(TFD.fdls_from_response(w, resp, 1, 1, 0.5, 0.1),
                    JFD.fdls_from_response(w, resp, 1, 1, 0.5, 0.1)):
        np.testing.assert_array_equal(a, b)
    ba = sps.butter(3, 0.2)
    for a, b in zip(TFD.fdls_from_filter(*ba, 2, 3, 256),
                    JFD.fdls_from_filter(*ba, 2, 3, 256)):
        np.testing.assert_array_equal(a, b)


def test_filtertools_equal():
    """Response reports, the capture spectrum, the carrier
    peak-to-background and the filter plot (matplotlib imported lazily)."""
    ba = sps.butter(4, [0.1, 0.3], btype='bandpass')
    np.testing.assert_array_equal(TFT.todb(ba[0], True), JFT.todb(ba[0], True))
    np.testing.assert_array_equal(TFT.ba_to_fft(*ba, 1024),
                                  JFT.ba_to_fft(*ba, 1024))
    assert TFT.response_report(*ba) == JFT.response_report(*ba)
    rng = np.random.default_rng(18)
    t = np.arange(1 << 17)
    cap = 500 * np.cos(2 * np.pi * 8.1 / 40 * t) + rng.normal(0, 20, t.size)
    for a, b in zip(TFT.capture_spectrum(cap, nfft=4096),
                    JFT.capture_spectrum(cap, nfft=4096)):
        np.testing.assert_array_equal(a, b)
    assert TFT.peak_to_background_db(cap) == JFT.peak_to_background_db(cap)
    with pytest.raises(ValueError, match='too short'):
        TFT.capture_spectrum(cap[:100])
    import matplotlib
    matplotlib.use('Agg')
    ax_t, ax_j = TFT.plot_filter(*ba), JFT.plot_filter(*ba)
    np.testing.assert_array_equal(ax_t.lines[0].get_ydata(),
                                  ax_j.lines[0].get_ydata())


def test_filtermaker_inventory_and_header_equal():
    """The design inventory read from the port's own filters, CX and comb
    designs, the reference inventory, and the rendered ldd_filters.h text,
    all in memory (nothing is written under native/)."""
    for tinv, jinv in ((TFM.design_inventory(), JFM.design_inventory()),
                       (TFM.reference_inventory(),
                        JFM.reference_inventory())):
        assert list(tinv) == list(jinv)
        for name in jinv:
            for a, b in zip(tinv[name], jinv[name]):
                np.testing.assert_array_equal(a, b, err_msg=name)
    ttext, tinv = TFM.render_header()
    jtext, _ = JFM.render_header()
    assert ttext == jtext and len(tinv) >= 17
    assert TFM.REFERENCE_OFFSETS == JFM.REFERENCE_OFFSETS
