"""PyTorch port, file-level CX (audio/cx.py, audio/cuda_cx.py): the
block-parallel envelopes, the certificate fallback, chunked streaming and
the whole expander against the JAX package's, and kernel K3 against its
plain version on the card.

The plain lanes run the JAX package's `_env_step` in float32 with each
multiply-add rounded once, as XLA:CPU fuses it (pinned below), so the port
equals JAX bit for bit here: the budgets (fast/slow rtol 1e-6, expander
output within 1 LSB) hold with room.  Most tests run a small block geometry
(core 4096, warm 8192 or 40000: the step count a lane takes is warm + core,
~393k at the production geometry, where the plain loop takes seconds); the
expander test runs the production geometry on 400,000 samples."""

import jax
import numpy as np
import pytest
import torch

from ld_decode_tpu.audio import cx as JCX
from ld_decode_tpu_torch.audio import cuda_cx as CC
from ld_decode_tpu_torch.audio import cx as TCX

SMALL = dict(core=4096, warm=8192)


def _programme(n, seed):
    """tests/test_cx.py::_long_signal: tone bursts, level steps and
    silences, as offset-32768 uint16 stereo."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 48000.0
    env = np.zeros(n)
    pos = 0
    while pos < n:
        seg = int(rng.integers(12000, 60000))
        env[pos:pos + seg] = float(rng.choice([0.0, 0.05, 0.2, 0.5, 0.9]))
        pos += seg
    pcm = np.empty(n * 2, np.uint16)
    pcm[0::2] = np.clip(24000.0 * env * np.sin(2 * np.pi * 997 * t) + 32768,
                        0, 65535).astype(np.uint16)
    pcm[1::2] = np.clip(18000.0 * env * np.sin(2 * np.pi * 1501 * t)
                        + 32768, 0, 65535).astype(np.uint16)
    return pcm


def _menv(n, seed=3):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 48000.0
    env = 8000 * (1 + np.sin(2 * np.pi * 0.7 * t))
    return np.abs(env * np.sin(2 * np.pi * 440 * t)) + rng.uniform(0, 100, n)


def test_scan_fuses_the_multiply_add():
    """XLA:CPU compiles `fast + m*.040` (and the slow twin) into a fused
    multiply-add: JAX's scan equals the once-rounded sum bit for bit and
    not the twice-rounded one.  So K3 uses fmaf, and the plain lanes round
    the sum once."""
    m = _menv(6000).astype(np.float32)
    with jax.enable_x64(False):
        jf, js = JCX._envelope_scan(m, 3.0, 5.0)
    f, s = np.float32(3.0), np.float32(5.0)
    twice = np.empty(len(m), np.float32)
    for i, x in enumerate(m):
        f = f * CC.FAST_DECAY
        if x > f:
            f = min(x, f + x * CC.FAST_ATTACK)
        twice[i] = f
    got, gs = CC.envelope_lanes_plain(torch.from_numpy(m), [0],
                                      [(3.0, 5.0)], 0, len(m))
    np.testing.assert_array_equal(got[0].numpy(), jf)
    np.testing.assert_array_equal(gs[0].numpy(), js)
    assert not np.array_equal(twice, jf)


def test_fma_rounds_once():
    """The plain version's once-rounded float32 sum, on values whose
    float64 sum lands exactly halfway between two float32 values: the
    rounding error's sign decides, as a fused multiply-add does."""
    a = np.array([1.0, 1.0, 3.0], np.float32)
    # p = 2^-24 + 2^-60 and 2^-24 - 2^-60: halfway in float64 after the
    # first rounding, above and below it exactly
    p = np.array([2.0 ** -24 + 2.0 ** -60, 2.0 ** -24 - 2.0 ** -60,
                  0.5], np.float64)
    got = CC._fma(a, p)
    assert got[0] == np.nextafter(np.float32(1), np.float32(2))
    assert got[1] == np.float32(1)
    assert got[2] == np.float32(3.5)


@pytest.mark.parametrize('n', [12000, 50000])
def test_blocked_against_jax(n):
    """envelope_followers_blocked at the small geometry: n = 12,000 keeps
    every block inside the warm window of the file start (exact by
    construction, certificate passes); n = 50,000 has blocks seeded at
    (0, ceiling) whose slow bounds do not meet within 8,192 steps
    (certificate refuses).  Same `ok`, fast/slow within rtol 1e-6."""
    m = _menv(n)
    with jax.enable_x64(False):
        jf, js, jok = JCX.envelope_followers_blocked(m, 3.0, 5.0, **SMALL)
    tf, ts, tok = TCX.envelope_followers_blocked(m, 3.0, 5.0, **SMALL,
                                                 device='cpu')
    assert tok == jok == (n == 12000)
    assert tf.dtype == ts.dtype == np.float32 and tf.shape == (n,)
    np.testing.assert_allclose(tf, jf, rtol=1e-6)
    np.testing.assert_allclose(ts, js, rtol=1e-6)


def test_certificate_fallback(monkeypatch):
    """tests/test_cx.py:141-145's decaying envelope (at exactly the slow
    rate): the certificate refuses on both, and envelope_followers falls
    back to the exact scan."""
    n = 40000
    menv = 20000.0 * np.exp(-1.5e-5 * np.arange(n))
    with jax.enable_x64(False):
        _, _, jok = JCX.envelope_followers_blocked(menv, 20000.0, 20000.0,
                                                   **SMALL)
        jf, js = JCX._envelope_scan(menv, 20000.0, 20000.0)
    _, _, tok = TCX.envelope_followers_blocked(menv, 20000.0, 20000.0,
                                               **SMALL, device='cpu')
    assert not tok and not jok
    monkeypatch.setattr(TCX.envelope_followers_blocked, '__defaults__',
                        (0.0, 0.0, SMALL['core'], SMALL['warm'], 0.05,
                         'cuda'))
    f, s = TCX.envelope_followers(menv, 20000.0, 20000.0, device='cpu')
    np.testing.assert_array_equal(f, jf)
    np.testing.assert_array_equal(s, js)
    with pytest.raises(AssertionError):
        TCX.envelope_followers_blocked(menv, 7e4, 0.0, device='cpu')


def test_chunked_streaming(monkeypatch):
    """CXExpander over 40,000-sample chunks (each through the blocked
    path, every block within warm reach of the chunk start so the carried
    state stays exact), then a short tail through the host loop: equal to
    JAX's expander chunk by chunk, and the carried states equal."""
    geo = (0.0, 0.0, 4096, 40000, 0.05)
    monkeypatch.setattr(JCX.envelope_followers_blocked, '__defaults__', geo)
    monkeypatch.setattr(TCX.envelope_followers_blocked, '__defaults__',
                        geo + ('cuda',))
    pcm = _programme(130000, seed=4)
    jx, tx = JCX.CXExpander(), TCX.CXExpander(device='cpu')
    with jax.enable_x64(False):
        for k in range(0, pcm.size, 80000):
            chunk = pcm[k:k + 80000]
            want = jx.process(chunk)
            got = tx.process(chunk)
            np.testing.assert_array_equal(got, want)
            assert (tx.fast, tx.slow) == (jx.fast, jx.slow)


def test_expander_production_geometry(monkeypatch):
    """CXExpander.process on 400,000 samples of programme audio at the
    production geometry (core 131,072, warm 262,144: four blocks, eight
    lanes of 393,216 steps): within 1 LSB of JAX's, with the certificate
    passing (the scan fallback is never called) and the carried envelope
    state equal."""
    def no_scan(*_a, **_k):
        raise AssertionError('the blocked certificate failed')

    monkeypatch.setattr(TCX, '_envelope_scan', no_scan)
    pcm = _programme(400000, seed=9)
    with jax.enable_x64(False):
        jx = JCX.CXExpander()
        want = jx.process(pcm)
    tx = TCX.CXExpander(device='cpu')
    got = tx.process(pcm)
    assert got.shape == want.shape
    assert np.abs(got.astype(np.int64) - want.astype(np.int64)).max() <= 1
    assert tx.fast == pytest.approx(jx.fast, rel=1e-6)
    assert tx.slow == pytest.approx(jx.slow, rel=1e-6)


def _scalar_lanes(m, starts, state0, nwarm, ncore):
    """Each lane as a scalar loop, one float32 rounding per operation (the
    fused sum as the float64 sum rounded to float32: no halfway case
    arises on these values)."""
    out_f = np.zeros((len(starts), ncore), np.float32)
    out_s = np.zeros_like(out_f)
    f32 = np.float32
    for l, (st, (f, s)) in enumerate(zip(starts, state0)):
        f, s = f32(f), f32(s)
        for j in range(nwarm + ncore):
            p = st + j
            if p >= 0:
                x = f32(m[p]) if p < len(m) else f32(0)
                fd = f32(f * CC.FAST_DECAY)
                f = min(x, f32(float(fd) + float(x) * float(CC.FAST_ATTACK))) \
                    if x > fd else fd
                sd = f32(s * CC.SLOW_DECAY)
                s = min(x, f32(float(sd) + float(x) * float(CC.SLOW_ATTACK))) \
                    if x > sd else sd
            if j >= nwarm:
                out_f[l, j - nwarm], out_s[l, j - nwarm] = f, s
    return out_f, out_s


def test_envelope_lanes_plain_edges():
    """Lanes whose head padding reaches into the kept steps (the held state
    is what they keep), lanes past the end of menv (m = 0), a lane from
    position 0: the plain version against a scalar loop."""
    m = np.abs(np.random.default_rng(6).normal(0, 3000, 300)).astype(
        np.float32)
    starts = [-40, -8, 0, 200, 296]
    state0 = [(0.0, 0.0), (65536.0, 65536.0), (3.0, 4.0), (10.0, 10.0),
              (0.0, 9.0)]
    f, s = CC.envelope_lanes_plain(torch.from_numpy(m), starts, state0, 16,
                                   64)
    wf, ws = _scalar_lanes(m, starts, state0, 16, 64)
    np.testing.assert_array_equal(f.numpy(), wf)
    np.testing.assert_array_equal(s.numpy(), ws)


def test_envelope_lanes_dispatch():
    """A CPU tensor takes the plain version (no launch); other devices
    raise; negative start states are refused."""
    m = torch.ones(64)
    before = CC.envelope_lanes.launches
    f, s = CC.envelope_lanes(m, [0, 8], [(0, 0), (1, 1)], 4, 12)
    assert f.shape == s.shape == (2, 12) and f.dtype == torch.float32
    assert CC.envelope_lanes.launches == before
    with pytest.raises(ValueError, match='no kernel'):
        CC.envelope_lanes(torch.ones(8, device='meta'), [0], [(0, 0)], 0, 8)
    with pytest.raises(ValueError, match='>= 0'):
        CC.envelope_lanes(m, [0], [(-1.0, 0.0)], 0, 8)
    if not torch.cuda.is_available():
        # a file-level input runs on the card unless asked otherwise
        with pytest.raises(RuntimeError, match="device='cpu'"):
            TCX.envelope_followers(np.zeros(TCX.CX_HOST_MAX))


@pytest.mark.cuda
def test_kernel_matches_plain_on_the_card():
    """K3 against its plain version at the production geometry (a 1 MB
    chunk: two blocks, four lanes of 393,216 steps) and at the one-lane
    scan, on programme audio: bit-equal, one launch each."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    pcm = _programme(262144, seed=11)
    menv = np.abs(pcm[0::2].astype(np.float32) - 32768)
    mt = torch.from_numpy(menv)
    core, warm = TCX.CX_BLOCK_CORE, TCX.CX_BLOCK_WARM
    starts = [k * core - warm for k in range(2) for _ in range(2)]
    state0 = [(0, 0), (0, 0), (0, 0), (65536.0, 65536.0)]
    for args in ((starts, state0, warm, core), ([0], [(1.0, 2.0)], 0,
                                                 len(menv) - 3)):
        before = CC.envelope_lanes.launches
        got = CC.envelope_lanes(mt.cuda(), *args)
        torch.cuda.synchronize()
        assert CC.envelope_lanes.launches == before + 1
        want = CC.envelope_lanes_plain(mt, *args)
        for g, w in zip(got, want):
            assert torch.equal(g.cpu(), w)
