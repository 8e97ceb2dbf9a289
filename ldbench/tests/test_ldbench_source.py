"""The benchmark's capture source on the CPU, at a short tile.

    python -m pytest ldbench/tests/test_ldbench_source.py -q
"""

import json
import os

import numpy as np
import pytest
import torch

from ldbench.source import encode as E
from ldbench.source import stream as S

HERE = os.path.dirname(os.path.abspath(__file__))
CONFIGS = os.path.join(os.path.dirname(HERE), 'configs')
# the shortest tiles that join themselves: 6 NTSC frames, 4 PAL frames
TILES = {'ntsc_cav_dd40': 6, 'pal_cav_dd40': 4}


def conf(name, **changes):
    with open(os.path.join(CONFIGS, name + '.json')) as f:
        c = json.load(f)
    c.update(changes)
    return c


@pytest.fixture(scope='module')
def cache(tmp_path_factory):
    return str(tmp_path_factory.mktemp('tiles'))


def stream(name, cache, seed=5, **changes):
    return S.SideStream(conf(name, **changes), seed, 'cpu',
                        tile_frames=TILES[name], cache_dir=cache)


@pytest.mark.parametrize('name', sorted(TILES))
def test_loader_reads_the_encoders_samples(name, cache):
    """The port's .lds loader over the stream gives the frozen encoder's
    quantised samples at the head of the side (noise off: the encoder's
    noise is not drawn by position)."""
    from ld_decode_tpu_torch.io.loaders import load_packed_4_40
    src = stream(name, cache, noise_rms=0.0)
    n = 300_000
    got = load_packed_4_40(src, 0, n)
    cfg, spec = S.config_for(src.conf)
    want = E.encode_frames(cfg, 1, spec)[:n]
    assert got.dtype == np.uint16
    np.testing.assert_array_equal(got, want)
    # an unaligned read: the same samples
    np.testing.assert_array_equal(load_packed_4_40(src, 12_345, 1000),
                                  want[12_345:13_345])


def test_byte_ranges_read_back_the_same(cache):
    src = stream('ntsc_cav_dd40', cache, seed=2 ** 31 + 11)
    pos = 5 * 10 ** 9 + 3
    src.seek(pos)
    whole = np.array(src.read(40_000))
    for lo, n in ((0, 40_000), (7, 333), (12_345, 27_000), (39_999, 1)):
        src.seek(pos + lo)
        np.testing.assert_array_equal(np.array(src.read(n)),
                                      whole[lo:lo + n])
    again = stream('ntsc_cav_dd40', cache, seed=2 ** 31 + 11)
    again.seek(pos)
    np.testing.assert_array_equal(np.array(again.read(40_000)), whole)
    # the side ends where its length says
    src.seek(0, os.SEEK_END)
    assert src.tell() == src.total_bytes
    src.seek(src.total_bytes - 10)
    assert len(src.read(100)) == 10


@pytest.mark.parametrize('name', sorted(TILES))
def test_phase_runs_on_across_a_tile_join(name, cache):
    """No step at a join: the phase advance of each sample there is the
    frequency track's, as everywhere inside a tile."""
    src = stream(name, cache, noise_rms=0.0)
    T = src.T
    hz, _ = S.load_tile(src.cfg, src.spec, src.tile_frames, cache)
    step = S.TAU / src.cfg.freq_hz
    for k in (1, 2, 700):
        n0 = k * T - 4
        adv = np.remainder(np.diff(src.phase(n0, 8).numpy()), S.TAU)
        want = np.remainder(hz[np.arange(n0 + 1, n0 + 8) % T] * step, S.TAU)
        np.testing.assert_allclose(adv, want, atol=1e-6)


def test_seeds_differ_in_noise_and_start(cache):
    a = stream('ntsc_cav_dd40', cache, seed=1)
    b = stream('ntsc_cav_dd40', cache, seed=2)
    assert a.start_frame != b.start_frame
    room = a.side_frames - int(np.ceil(
        float(a.conf['start_room_msamples']) * 1e6 / a.samples_per_frame))
    assert 0 <= a.start_frame < room and 0 <= b.start_frame < room
    na = (a.rf(10 ** 9, 50_000) - a.rf(10 ** 9, 50_000)).abs().max()
    assert float(na) == 0.0
    d = (a.rf(10 ** 9, 50_000) - b.rf(10 ** 9, 50_000)).numpy()
    # the difference is the two seeds' noise: about sqrt(2) * noise_rms
    assert 0.02 < d.std() < 0.04
    g = a.noise(3 * S.NOISE_BLOCK - 500_000, 10 ** 6)
    assert abs(float(g.mean())) < 0.01 and abs(float(g.std()) - 1) < 0.01
    # a block's noise is the same read whole or in part
    np.testing.assert_array_equal(a.noise(3 * S.NOISE_BLOCK + 7, 99),
                                  g[500_007:500_106])
