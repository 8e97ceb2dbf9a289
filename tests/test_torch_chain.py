"""PyTorch port, the full chain (ldchain_torch.py): the device weave, CX
expansion and the CLI against ldchain_tpu.py.

The decode differs from JAX within its own budgets (tests/torch_parity.py:
picture p99.9 <= 2 / max <= 4 LSB, audio 0.6 LSB rms), and the comb and
the CX expander carry that on, so the chain is held to: equal frame
counts, RGB >> 8 p99.9 <= 1 and max <= 4, CX audio <= 1 LSB rms (ticks
where the 48 kHz chase picked the neighbouring sample counted apart, as in
tests/torch_parity.py).  Like ldchain_tpu.py:234-239 the port ends a PAL
dim-3 stream with the comb's flush tail (the final frame, 2D, words None);
the NTSC comb has no flush.

The capture is tests/test_chain_cli.py:27-30's ramp at 6 frames, not 5.
Five frames decode to three, which the JAX flow comb takes as one window
of two frames -- a lax.scan of length 1 in comb/batch.py::_comb_window_of
-- and that program crashed XLA:CPU (SIGSEGV, jax 0.9.0) in more than half
of the runs.  Six frames decode to four: one window of three (frame 0 is
never emitted in flow mode), two RGB frames out."""

import shutil

import jax
import numpy as np
import pytest
import torch

import ldchain_torch
import ldchain_tpu
from ld_decode_tpu.audio import cx as JCX
from ld_decode_tpu.io import loaders as JL
from ld_decode_tpu.models import encode as JE
from ld_decode_tpu.utils.params import DecoderConfig
from ld_decode_tpu_torch.audio import cx as TCX
from ld_decode_tpu_torch.ops import filters as TF
from ld_decode_tpu_torch.tbc import framer as TFR
from ld_decode_tpu_torch.utils.params import DecoderConfig as TConfig

torch.set_num_threads(2)

FRAME_RGB = 480 * 744 * 3


@pytest.fixture(scope='module')
def capture():
    cfg = DecoderConfig(system='NTSC', freq_mhz=40.0)
    return JE.encode_frames(cfg, 6, JE.EncodeSpec(pattern='ramp',
                                                  cav_start_frame=900))


@pytest.fixture(scope='module')
def lds(capture, tmp_path_factory):
    """The capture as .lds (tests/test_chain_cli.py:27-30)."""
    path = tmp_path_factory.mktemp('chain') / 'cap.lds'
    path.write_bytes(JL.pack_data_4_40(capture).tobytes())
    return path


def test_device_weave_equals_host_weave(capture):
    """Framer(fetch_picture=False) weaves on the device; the frames equal
    the host weave exactly, line-0 words included (the first frame is a
    mixed pair with the sequential-fallback field and weaves on the
    host)."""
    cfg = TConfig(system='NTSC', freq_mhz=40.0)
    bank = TF.make_demod_bank(cfg, np.complex64, device='cpu')
    outs = []
    for fetch in (True, False):
        fr = TFR.Framer(cfg, bank, capture=capture, batch=6, device='cpu',
                        fetch_picture=fetch)
        s, frames = 33046, []
        for i in range(3):
            rv = fr.readframe(None, s, i == 0)
            assert rv[0] is not None
            frames.append(rv[0])
            s = rv[2]
        outs.append(frames)
    host, dev = outs
    assert sum(isinstance(f, torch.Tensor) for f in dev) >= 2
    for h, d in zip(host, dev):
        d = d.numpy() if isinstance(d, torch.Tensor) else d
        assert d.shape == h.shape == (525 * 910,)
        np.testing.assert_array_equal(d.astype(np.uint16), h)


def test_cx_expander_frame_chunks():
    """CX on frame-sized chunks (the chain's feed) equals JAX's exactly:
    the same numpy/scipy code, state carried across chunks."""
    rng = np.random.default_rng(12)
    t = np.arange(48000 // 30 * 12) / 48000.0
    env = 8000 * (1 + np.sin(2 * np.pi * 0.7 * t))
    sig = np.stack([env * np.sin(2 * np.pi * 440 * t),
                    env * np.sin(2 * np.pi * 660 * t)], 1)
    pcm = np.clip(sig + rng.normal(0, 50, sig.shape), -32767,
                  32767).astype(np.int16).reshape(-1)
    jx, tx = JCX.CXExpander(), TCX.CXExpander()
    step = 1602 * 2
    for k in range(0, pcm.size, step):
        chunk = pcm[k:k + step]
        np.testing.assert_array_equal(tx.process(chunk), jx.process(chunk))
    # from CX_HOST_MAX samples on, the block-parallel envelopes (held to
    # JAX in tests/test_torch_cx_file.py)
    zeros = np.zeros(TCX.CX_HOST_MAX)
    for got, want in zip(TCX.envelope_followers(zeros, device='cpu'),
                         JCX.envelope_followers(zeros)):
        np.testing.assert_array_equal(got, want)


def _run_both(lds, tmp_path, flags, monkeypatch):
    """ldchain_tpu.main and ldchain_torch.main with the same flags, raw
    .rgb sinks (shutil.which patched to None, as tests/test_chain_cli.py
    does)."""
    monkeypatch.setattr(shutil, 'which', lambda *_: None)
    common = ['--comb-batch', '4', '--depth', '1', '--batch', '6', '-q',
              '--raw'] + flags
    out_j, out_t = str(tmp_path / 'jax'), str(tmp_path / 'torch')
    with jax.enable_x64(False):
        assert ldchain_tpu.main([str(lds), out_j] + common) == 0
    assert ldchain_torch.main([str(lds), out_t, '--device', 'cpu']
                              + common) == 0
    return [(np.fromfile(o + '.rgb', np.uint16),
             np.fromfile(o + '.audio.pcm', '<i2')) for o in (out_j, out_t)]


@pytest.mark.parametrize('flags', [[], ['-F']], ids=['flow', 'kmap'])
def test_chain_cli_against_jax(lds, tmp_path, flags, monkeypatch):
    """Default dim 3 with optical flow, and -F: 4 frames decode, 2 emit."""
    (rj, aj), (rt, at) = _run_both(lds, tmp_path, flags, monkeypatch)
    assert rj.size == rt.size and rj.size >= 2 * FRAME_RGB
    assert rj.size % FRAME_RGB == 0
    d = np.abs((rj >> 8).astype(np.int64) - (rt >> 8).astype(np.int64))
    assert np.percentile(d, 99.9) <= 1 and d.max() <= 4, d.max()
    assert aj.size == at.size and aj.size > 3000
    da = np.abs(at.astype(np.float64) - aj)
    picks = da > 8
    assert picks.mean() <= 0.005
    assert np.sqrt(np.mean(da[~picks] ** 2)) <= 1.0


def test_chain_cli_defaults_to_the_card(lds, tmp_path):
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present: the default would run')
    with pytest.raises(RuntimeError, match='--device cpu'):
        ldchain_torch.main([str(lds), str(tmp_path / 'o'), '-q'])


FRAME_PAL = 576 * 1135 * 3


@pytest.fixture(scope='module')
def pal_lds(tmp_path_factory):
    """The 4-frame `palbars` capture of tests/test_chain_cli.py:62-70."""
    cfg = DecoderConfig(system='PAL', freq_mhz=40.0)
    cap = JE.encode_frames(cfg, 4, JE.EncodeSpec(pattern='palbars',
                                                 cav_start_frame=900))
    path = tmp_path_factory.mktemp('chainpal') / 'cap.lds'
    path.write_bytes(JL.pack_data_4_40(cap).tobytes())
    return path


PAL_COMMON = ['-p', '--comb-batch', '3', '--depth', '1', '--batch', '5',
              '-q', '--raw']


def _frames_off_budget(rj, rt):
    """Indices of the frames whose RGB >> 8 is outside p99.9 <= 1 / max
    <= 4."""
    off = []
    for k in range(rj.size // FRAME_PAL):
        a, b = (r[k * FRAME_PAL:(k + 1) * FRAME_PAL] >> 8 for r in (rj, rt))
        d = np.abs(a.astype(np.int64) - b.astype(np.int64))
        if np.percentile(d, 99.9) > 1 or d.max() > 4:
            off.append(k)
    return off


@pytest.mark.parametrize('dim', ['2', '3'])
def test_chain_cli_pal_against_jax(pal_lds, tmp_path, dim, monkeypatch):
    """`-p -d 2` and `-d 3` (the flush tail included): equal frame counts,
    1135 x 576 RGB, and the budgets of the module docstring.

    The comb's V-switch vote is a tie by construction
    (tests/test_torch_comb_pal.py): the port always takes the first
    candidate, the JAX package's compiled window lets rounding noise pick
    another one for some frames of this capture.  A frame that is off the
    budget must therefore be inside it with the port's vote forced to one
    of the other three candidates; at least one frame agrees as it is."""
    from ld_decode_tpu_torch.comb import comb_pal as TP
    monkeypatch.setattr(shutil, 'which', lambda *_: None)
    flags = PAL_COMMON + ['-d', dim]
    out_j, out_t = str(tmp_path / 'jax'), str(tmp_path / 'torch')
    with jax.enable_x64(False):
        assert ldchain_tpu.main([str(pal_lds), out_j] + flags) == 0
    assert ldchain_torch.main([str(pal_lds), out_t, '--device', 'cpu']
                              + flags) == 0
    rj, rt = (np.fromfile(o + '.rgb', np.uint16) for o in (out_j, out_t))
    assert rj.size == rt.size and rj.size >= 2 * FRAME_PAL
    assert rj.size % FRAME_PAL == 0
    off = _frames_off_budget(rj, rt)
    assert len(off) < rj.size // FRAME_PAL
    for k in (1, 2, 3):
        if not off:
            break
        monkeypatch.setattr(
            TP, 'vswitch_choice',
            lambda u, v, k=k: torch.full(u.shape[:-2], k, dtype=torch.long))
        out_k = str(tmp_path / f'torch{k}')
        assert ldchain_torch.main([str(pal_lds), out_k, '--device', 'cpu',
                                   '--no-audio'] + flags) == 0
        rk = np.fromfile(out_k + '.rgb', np.uint16)
        still = set(_frames_off_budget(rj, rk))
        off = [f for f in off if f in still]
    assert not off, off
    aj, at = (np.fromfile(o + '.audio.pcm', '<i2') for o in (out_j, out_t))
    assert aj.size == at.size and aj.size > 3000
    da = np.abs(at.astype(np.float64) - aj)
    picks = da > 8
    assert picks.mean() <= 0.005
    assert np.sqrt(np.mean(da[~picks] ** 2)) <= 1.0


def test_chain_cli_pal_options_and_efm(pal_lds, tmp_path, monkeypatch):
    """The PAL flags reach the comb (-B gives grey, --no-pilot-notch and
    --pal-colorlpf change the picture), -8 writes bytes, and --efm on a
    capture with no EFM carrier writes its two files as ldchain_tpu.py
    does (tests/test_chain_cli.py:47-49)."""
    monkeypatch.setattr(shutil, 'which', lambda *_: None)
    base = [str(pal_lds), None, '--device', 'cpu', '-p', '-d', '2', '-l',
            '1', '--batch', '5', '-q', '--raw', '--no-audio']
    outs = {}
    for name, flags in (('plain', []), ('bw', ['-B']),
                        ('nonotch', ['--no-pilot-notch']),
                        ('lpf', ['--pal-colorlpf']),
                        ('b8', ['-8', '--efm'])):
        base[1] = str(tmp_path / name)
        assert ldchain_torch.main(base + flags) == 0
        outs[name] = np.fromfile(
            base[1] + '.rgb', np.uint8 if name == 'b8' else np.uint16)
    assert outs['plain'].size == FRAME_PAL == outs['b8'].size
    grey = outs['bw'].reshape(-1, 3).astype(np.int64)
    assert np.ptp(grey, axis=1).max() == 0
    for name in ('nonotch', 'lpf'):
        assert not np.array_equal(outs[name], outs['plain'])
    np.testing.assert_array_equal(outs['b8'],
                                  (outs['plain'] >> 8).astype(np.uint8))
    assert (tmp_path / 'b8.efm.pcm').exists()
    assert (tmp_path / 'b8.subcode.log').read_text().startswith('# frames=')
