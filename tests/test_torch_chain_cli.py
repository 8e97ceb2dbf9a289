"""PyTorch port, the one-command chain equals the two-step path: RF capture
-> RGB + CX-expanded audio through ldchain_torch.py equals
lddecode_torch.py followed by ldexport_torch.py, bit for bit, NTSC `-F`
and PAL (the shape of tests/test_chain_cli.py, which holds the JAX
package's two tools to each other).  tests/test_torch_chain.py holds the
chain CLI to ldchain_tpu.py, and tests/test_torch_export_view.py the
exporter to ldexport_tpu.py.

`-l N` is a named divergence: ldchain_torch.py writes the audio of the
first N decoded frames, ldchain_tpu.py that of every frame it decoded
before its sink held N (`test_chain_cli_length_stops_the_audio`)."""

import shutil

import numpy as np
import torch

import ldchain_torch
import lddecode_torch
import ldexport_torch
from ld_decode_tpu_torch.io import loaders as TL
from ld_decode_tpu_torch.models import encode as TE
from ld_decode_tpu_torch.tbc import framer as TFR
from ld_decode_tpu_torch.utils.params import DecoderConfig

torch.set_num_threads(2)

CPU = ['--device', 'cpu']


def _lds(tmp_path, system, pattern, nframes):
    cfg = DecoderConfig(system=system, freq_mhz=40.0)
    samples = TE.encode_frames(cfg, nframes, TE.EncodeSpec(
        pattern=pattern, cav_start_frame=900))
    lds = tmp_path / 'cap.lds'
    lds.write_bytes(TL.pack_data_4_40(samples).tobytes())
    return str(lds)


def test_chain_cli_matches_two_step_ntsc(tmp_path, monkeypatch):
    """NTSC -F (the K-map 3D comb): the RGB48 stream and the expanded
    audio equal the two-step path's bit for bit (the same comb emission
    protocol, the same chunk-invariant CX state chain)."""
    monkeypatch.setattr(shutil, 'which', lambda *_: None)  # raw sinks
    lds = _lds(tmp_path, 'NTSC', 'ramp', 5)
    d = str(tmp_path / 'dec')
    assert lddecode_torch.main([lds, d, '-n', '--batch', '6', '-q'] + CPU) \
        == 0
    assert ldexport_torch.main([d + '.tbc', str(tmp_path / 'two'), '-F',
                                '--comb-batch', '4', '-a', d + '.pcm']
                               + CPU) == 0
    assert ldchain_torch.main([lds, str(tmp_path / 'one'), '-F',
                               '--comb-batch', '4', '--depth', '1',
                               '--batch', '6', '--efm', '-q'] + CPU) == 0
    # --efm on a capture with no EFM carrier: files written, no crash
    assert (tmp_path / 'one.efm.pcm').exists()
    assert (tmp_path / 'one.subcode.log').read_text().startswith('# frames=')

    rgb_two = np.fromfile(tmp_path / 'two.rgb', np.uint16)
    rgb_one = np.fromfile(tmp_path / 'one.rgb', np.uint16)
    assert rgb_two.size > 0 and rgb_two.size % (480 * 744 * 3) == 0
    np.testing.assert_array_equal(rgb_one, rgb_two)
    a_two = np.fromfile(tmp_path / 'two.audio.pcm', '<i2')
    a_one = np.fromfile(tmp_path / 'one.audio.pcm', '<i2')
    assert a_two.size > 3000
    np.testing.assert_array_equal(a_one, a_two)


def test_chain_cli_matches_two_step_pal(tmp_path, monkeypatch):
    """PAL (the dim-2 comb): the device-resident frames through
    PALCombBatch reproduce the two-step stream."""
    monkeypatch.setattr(shutil, 'which', lambda *_: None)
    lds = _lds(tmp_path, 'PAL', 'palbars', 4)
    d = str(tmp_path / 'dec')
    assert lddecode_torch.main([lds, d, '-p', '--batch', '5', '-q'] + CPU) \
        == 0
    assert ldexport_torch.main([d + '.tbc', str(tmp_path / 'two'), '--pal',
                                '-d', '2', '--comb-batch', '3'] + CPU) == 0
    assert ldchain_torch.main([lds, str(tmp_path / 'one'), '--pal', '-d',
                               '2', '--comb-batch', '3', '--depth', '1',
                               '--batch', '5', '--no-audio', '-q'] + CPU) == 0
    rgb_two = np.fromfile(tmp_path / 'two.rgb', np.uint16)
    rgb_one = np.fromfile(tmp_path / 'one.rgb', np.uint16)
    assert rgb_two.size > 0 and rgb_two.size % (576 * 1135 * 3) == 0
    np.testing.assert_array_equal(rgb_one, rgb_two)


def test_chain_cli_length_stops_the_audio(tmp_path, monkeypatch):
    """-l 1 with windows of 2 frames: the chain decodes past the first
    frame for the comb's lookahead, as ldchain_tpu.py does, and the RGB
    is JAX's (one frame, within the chain's budget of
    tests/test_torch_chain.py: RGB >> 8 p99.9 <= 1, max <= 4); the .pcm
    holds exactly the first decoded frame's audio, where ldchain_tpu.py's
    holds the audio of every frame it decoded (ROADMAP.md Queue 3: the
    `-l` overrun, fixed in the port).  The shared head is JAX's within
    the CX audio budget."""
    import jax
    import ldchain_tpu
    monkeypatch.setattr(shutil, 'which', lambda *_: None)
    lds = _lds(tmp_path, 'NTSC', 'ramp', 6)
    counts, depth = [], [0]
    readframe = TFR.Framer.readframe

    def counted(self, *a, **k):
        # readframe calls itself again on an MTF re-decode: count the
        # outermost call, the frame the CLI receives
        depth[0] += 1
        try:
            rv = readframe(self, *a, **k)
        finally:
            depth[0] -= 1
        if depth[0] == 0 and rv[0] is not None:
            counts.append(0 if rv[1] is None else np.asarray(rv[1]).size)
        return rv

    monkeypatch.setattr(TFR.Framer, 'readframe', counted)
    common = ['-F', '--comb-batch', '2', '--depth', '1', '--batch', '6',
              '-q', '--raw', '-l', '1']
    out_j, out_t = str(tmp_path / 'jax'), str(tmp_path / 'torch')
    with jax.enable_x64(False):
        assert ldchain_tpu.main([lds, out_j] + common) == 0
    assert ldchain_torch.main([lds, out_t] + common + CPU) == 0
    rj, rt = (np.fromfile(o + '.rgb', np.uint16) for o in (out_j, out_t))
    aj, at = (np.fromfile(o + '.audio.pcm', '<i2') for o in (out_j, out_t))

    assert len(counts) > 1                     # decoded past the first
    assert rj.size == rt.size == 480 * 744 * 3
    d = np.abs((rj >> 8).astype(np.int64) - (rt >> 8).astype(np.int64))
    assert np.percentile(d, 99.9) <= 1 and d.max() <= 4, d.max()
    assert at.size == counts[0] > 0
    assert aj.size > at.size                   # the divergence
    da = np.abs(at.astype(np.float64) - aj[:at.size])
    picks = da > 8
    assert picks.mean() <= 0.005
    assert np.sqrt(np.mean(da[~picks] ** 2)) <= 1.0
