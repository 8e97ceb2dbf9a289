"""PyTorch port, the NN comb (models/nn_comb.py) against the JAX package's.

Both packages run the same weights: a flax NNComb's parameter tree is
carried into the port by `params_from_flax`.  The JAX side runs under
jax.enable_x64(False).  Budgets:
  * forward pass: within 2e-6 of max|out| (float32 convolutions summed in
    another order; 4e-7 found);
  * the box blur and `compose` of synth_batch on the same noise: within
    1e-5 of each output's peak (float32 cumulative sums in another order);
  * three Adam steps on identical batches: losses within 1e-5 relative,
    parameters within 0.01 * lr.  Adam's first step moves each parameter
    by lr * g/|g|, so a gradient whose sign float32 rounding could flip
    would move it by a whole 2 * lr; the test first checks that no
    gradient component of the first step lies within 10x the two packages'
    gradient difference of zero, which is what makes the bound hold;
  * comb_frame_nn RGB: within 1 LSB, as the comb's `-F` parity is
    (tests/test_torch_comb.py), and the AGC carry within 1e-6 relative;
  * the training-pair writer: the inputs equal, the clp targets within
    1e-5 of their peak, and each package's trainer reads the other's file.
Widths are small (features (8, 8), 24 x 96 crops) except where the JAX test
is itself full-frame (the convention test, comb_frame_nn, the writer)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ld_decode_tpu.comb import comb_ntsc as JCN
from ld_decode_tpu.models import nn_comb as JNC
from ld_decode_tpu_torch.comb import comb_ntsc as CN
from ld_decode_tpu_torch.models import nn_comb as NC

torch.set_num_threads(2)

H, W = CN.IN_Y, CN.IN_X
FEATURES = (8, 8)
FWD_TOL = 2e-6
SYNTH_TOL = 1e-5
LR = 3e-3


def _np_tree(params):
    return jax.tree.map(np.asarray, params)


def _port_model(params, features=FEATURES):
    model = NC.NNComb(features)
    model.load_state_dict(NC.params_from_flax(_np_tree(params)))
    return model


@pytest.fixture(scope='module')
def flax_params():
    with jax.enable_x64(False):
        return JNC.NNComb(features=FEATURES).init(
            jax.random.PRNGKey(0), jnp.zeros((1, 24, 96, 3)))


def _close(got, want, tol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    peak = max(float(np.abs(want).max()), 1e-30)
    assert np.abs(got - want).max() <= tol * peak, \
        (float(np.abs(got - want).max()), peak)


@pytest.mark.parametrize('features,shape', [(FEATURES, (2, 24, 96)),
                                            ((24, 24), (1, 48, 160))])
def test_forward_from_flax(features, shape):
    """NNComb forward on weights from params_from_flax against
    NNComb().apply: the layer layout, the (2, 4) padding of flax's SAME
    with dilation (2, 1), and the tanh-approximate GELU."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal(shape + (3,)).astype(np.float32)
    with jax.enable_x64(False):
        jm = JNC.NNComb(features=features)
        params = jm.init(jax.random.PRNGKey(2), jnp.zeros((1, 16, 64, 3)))
        want = np.asarray(jm.apply(params, x))
    model = _port_model(params, features)
    assert [tuple(p.shape) for p in model.parameters()] == [
        (features[0], 3, 3, 9), (features[0],), (features[1], features[0],
                                                  3, 9), (features[1],),
        (1, features[1], 3, 3), (1,)]
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    _close(got, want, FWD_TOL)
    # the erf GELU differs from flax's by far more than the budget
    erf = NC.NNComb(features)
    erf.load_state_dict(model.state_dict())
    h = torch.from_numpy(x).permute(0, 3, 1, 2)
    with torch.no_grad():
        for conv in erf.convs:
            h = torch.nn.functional.gelu(conv(h))
        alt = (erf.out(h)[:, 0] * 30.0 * NC.IRESCALE).numpy()
    assert np.abs(alt - want).max() > 100 * FWD_TOL * np.abs(want).max()


def test_init_is_flax_lecun_normal():
    """reset_parameters draws flax's default: zero biases, kernels
    truncated at 2 sigma with variance 1/fan_in, from the generator."""
    a = NC.NNComb((24, 24), torch.Generator().manual_seed(5))
    b = NC.NNComb((24, 24), torch.Generator().manual_seed(5))
    c = NC.NNComb((24, 24), torch.Generator().manual_seed(6))
    for (k, pa), pb, pc in zip(a.state_dict().items(),
                               b.state_dict().values(),
                               c.state_dict().values()):
        assert torch.equal(pa, pb)
        if k.endswith('bias'):
            assert not pa.any()
            continue
        assert not torch.equal(pa, pc)
        fan_in = pa[0].numel()
        std = (1.0 / fan_in) ** 0.5 / .87962566103423978
        assert float(pa.abs().max()) <= 2 * std
        if pa.numel() > 1000:
            # a normal truncated at 2 sigma keeps 0.774 of its variance
            assert abs(float(pa.std()) / std - 0.8796) < 0.05


def test_box_blur_against_jax(monkeypatch):
    """The deterministic part of _smooth_field on the same noise."""
    rng = np.random.default_rng(3)
    noise = rng.standard_normal((2, 40, 120)).astype(np.float32)
    monkeypatch.setattr(jax.random, 'normal',
                        lambda key, shape: jnp.asarray(noise))
    for cutoff in NC.FIELD_CUTOFFS + (1,):
        with jax.enable_x64(False):
            want = np.asarray(JNC._smooth_field(jax.random.PRNGKey(0),
                                                noise.shape, cutoff))
        got = NC.box_blur(torch.from_numpy(noise), cutoff).numpy()
        _close(got, want, SYNTH_TOL)


def test_compose_against_jax(monkeypatch):
    """synth_batch's composition of the same smoothed fields and line
    flips: inputs, clp target and the true Y, I, Q."""
    rng = np.random.default_rng(4)
    B, h, w = 2, 32, 128
    fields = [NC.box_blur(torch.from_numpy(
        rng.standard_normal((B, h, w)).astype(np.float32)), c)
        for c in NC.FIELD_CUTOFFS]
    bits = rng.random((B, h)) < 0.5
    calls = iter(fields)
    monkeypatch.setattr(JNC, '_smooth_field',
                        lambda key, shape, c: jnp.asarray(next(calls).numpy()))
    monkeypatch.setattr(jax.random, 'bernoulli',
                        lambda key, p, shape: jnp.asarray(bits))
    with jax.enable_x64(False):
        want = JNC.synth_batch(jax.random.PRNGKey(0), B, h, w)
    got = NC.compose(fields, torch.from_numpy(np.where(bits, 1.0, -1.0)
                                              .astype(np.float32)))
    for g, j in zip(got, want):
        assert g.dtype == torch.float32
        _close(g.numpy(), j, SYNTH_TOL)


def test_synth_batch_generator_contract():
    """The random draws: shapes and dtypes, reproducible from the
    generator's seed, never from global state, on the generator's device."""
    def draw(seed):
        return NC.synth_batch(torch.Generator().manual_seed(seed), 2, 24, 96)

    torch.manual_seed(0)
    a = draw(7)
    torch.manual_seed(1)                       # global state is not read
    b, c = draw(7), draw(8)
    shapes = [(2, 24, 96, 3)] + [(2, 24, 96)] * 4
    for x, y, z, s in zip(a, b, c, shapes):
        assert tuple(x.shape) == s and x.dtype == torch.float32
        assert x.device.type == 'cpu'
        assert torch.equal(x, y) and not torch.equal(x, z)
    flips = a[0][:, :, 0, 1]                   # carrier_i at x=0 = flip
    assert set(flips.unique().tolist()) == {-1.0, 1.0}


def test_convention_against_stencil():
    """The generator's (composite, clp, Y, I, Q) identity agrees with the
    port's comb machinery: the oracle clp plane through split_iq +
    adjust_y recovers luma exactly and chroma to the sample-and-hold
    floor, and split1d approximates the clp target (the bounds of
    tests/test_nn_comb.py::test_convention_against_stencil)."""
    inp, clp_t, y_t, i_t, q_t = NC.synth_batch(
        torch.Generator().manual_seed(1), 1, H, W)
    raw = (inp[0, :, :, 0] + 1.0) * 32768.0
    invert_col = inp[0, :, 0, 1] > 0

    cfg = CN.CombConfig(dim=2, colorlpf=False, nr_y=0.0, nr_c=0.0)
    z = torch.zeros_like(raw)
    inner = CN._row_mask(4, 524, 'cpu') & CN._col_mask(18, 840, 'cpu')
    ones = torch.where(inner, 1.0, 0.0)
    clp = torch.where(inner, clp_t[0], 0.0)
    y, i, q = CN.split_iq(raw, (z, clp, z), (z, ones, z), invert_col, cfg)
    y, i, q = CN.adjust_y(y, i, q, invert_col, cfg)

    def sh(a):
        return np.pad(np.asarray(a), ((0, 0), (0, 2)))[:, 2:]

    c = (slice(60, 480), slice(60, 780))
    assert np.abs(y.numpy() - sh(y_t[0]))[c].max() < 1e-2
    di = np.abs(i.numpy() - sh(i_t[0]))[c]
    assert di.mean() < 0.1 * np.abs(i_t.numpy()).mean()
    d0 = np.abs(CN.split1d(raw).numpy() - clp_t[0].numpy())[c]
    assert d0.mean() < 0.3 * np.abs(clp_t.numpy()).mean()


def test_train_steps_against_optax(flax_params):
    """Three train steps on identical batches: the port's train_step
    (torch.optim.Adam) against optax.adam with the same loss, from the
    same weights."""
    gen = torch.Generator().manual_seed(3)
    batches = [tuple(a.numpy() for a in NC.synth_batch(gen, 2, 24, 96)[:2])
               for _ in range(3)]
    with jax.enable_x64(False):
        jm = JNC.NNComb(features=FEATURES)
        tx = optax.adam(LR)

        def loss_fn(p, inp, clp_t):
            return jnp.mean((jm.apply(p, inp) - clp_t) ** 2) \
                / (JNC.IRESCALE ** 2)

        @jax.jit
        def step(p, o, inp, clp_t):
            loss, g = jax.value_and_grad(loss_fn)(p, inp, clp_t)
            up, o = tx.update(g, o, p)
            return optax.apply_updates(p, up), o, loss, g

        p, o = flax_params, tx.init(flax_params)
        losses_j, grads_j = [], []
        for inp, clp_t in batches:
            p, o, loss, g = step(p, o, inp, clp_t)
            losses_j.append(float(loss))
            grads_j.append(NC.params_from_flax(_np_tree(g)))
    want = NC.params_from_flax(_np_tree(p))

    model = _port_model(flax_params)
    opt = NC.make_optimizer(model, LR)
    losses_t = []
    for k, (inp, clp_t) in enumerate(batches):
        loss = NC.train_step(model, opt, torch.from_numpy(inp),
                             torch.from_numpy(clp_t))
        losses_t.append(float(loss))
        if k == 0:
            for name, prm in model.named_parameters():
                gj = grads_j[0][name]
                noise = float((prm.grad - gj).abs().max())
                assert float(gj.abs().min()) > 10 * noise, name
    np.testing.assert_allclose(losses_t, losses_j, rtol=1e-5)
    for name, v in model.state_dict().items():
        assert float((v - want[name]).abs().max()) <= 0.01 * LR, name


def _nn_frame(seed):
    """A synthetic full frame with .tbc line-0 flags and a burst level of
    10 IRE (AGC gain 1): tests/test_nn_comb.py::test_comb_frame_nn_rgb."""
    inp, clp_t, y_t, i_t, q_t = NC.synth_batch(
        torch.Generator().manual_seed(seed), 1, H, W)
    raw = ((inp[0, :, :, 0] + 1.0) * 32768.0).numpy()
    flip = inp[0, :, 0, 1].numpy() > 0
    raw[:, 0] = np.where(flip, 16384.0, 32768.0)
    raw[:, 1] = 10.0 * CN.IRESCALE
    return np.clip(raw, 0, 65535).astype(np.uint16), (y_t, i_t, q_t)


@pytest.mark.parametrize('cfg', [
    dict(dim=2, nr_y=0.0, nr_c=0.0, wide=True),
    dict(dim=2)], ids=['nr-off', 'defaults'])
def test_comb_frame_nn_against_jax(flax_params, cfg):
    """comb_frame_nn against the JAX package's on the same weights and
    frame: RGB within 1 LSB, the AGC carry within 1e-6 relative."""
    raw_u16, _ = _nn_frame(9)
    jcfg, tcfg = JCN.CombConfig(**cfg), CN.CombConfig(**cfg)
    with jax.enable_x64(False):
        want, jab = JNC.comb_frame_nn(jnp.asarray(raw_u16), flax_params,
                                      jnp.float32(-1.0), jcfg,
                                      features=FEATURES)
        want, jab = np.asarray(want), float(jab)
    got, ab = NC.comb_frame_nn(torch.from_numpy(raw_u16.astype(np.int32)),
                               _port_model(flax_params), -1.0, tcfg)
    assert got.dtype == torch.int32 and tuple(got.shape) == want.shape
    d = np.abs(got.numpy().astype(np.int64) - want.astype(np.int64))
    assert d.max() <= 1, (d.max(), (d > 0).mean())
    assert abs(ab - jab) <= 1e-6 * abs(jab)


def _static_frames(k=4):
    """tests/test_nn_comb.py::test_training_writer_and_file_training's
    frames: a static scene whose chroma phase alternates frame to frame,
    the condition Split3D separates exactly."""
    _, clp_t, y_t, i_t, q_t = NC.synth_batch(
        torch.Generator().manual_seed(2), 1, H, W)
    y_t, i_t, q_t = (a[0].numpy().astype(np.float64)
                     for a in (y_t, i_t, q_t))
    rng = np.random.default_rng(3)
    flip0 = np.where(rng.integers(0, 2, H).astype(bool), 1.0, -1.0)
    frames, flips = [], []
    for n in range(k):
        fl = flip0 * (1 if n % 2 == 0 else -1)
        ci, cq = (c.numpy() for c in NC._carriers(
            H, W, torch.from_numpy(fl.astype(np.float32))))
        raw = y_t - (i_t * ci - q_t * cq)
        raw[:, 0] = np.where(fl > 0, 16384.0, 32768.0)
        frames.append(np.clip(raw, 0, 65535).astype(np.uint16))
        flips.append(fl)
    return np.stack(frames), flips, (i_t, q_t)


def test_training_writer_both_directions(tmp_path):
    """write_training_file against the JAX package's on the same frames
    (the .npz keys and dtypes, the inputs equal, the targets within 1e-5
    of their peak), the target's fidelity to the true chroma plane (the
    bound of tests/test_nn_comb.py), and each package's trainer on the
    other's file."""
    frames, flips, (i_t, q_t) = _static_frames()
    pj, pt = str(tmp_path / 'jax.npz'), str(tmp_path / 'torch.npz')
    with jax.enable_x64(False):
        assert JNC.write_training_file(frames, pj) == 2
    assert NC.write_training_file(frames, pt, device='cpu') == 2
    dj, dt = np.load(pj), np.load(pt)
    assert sorted(dt.files) == sorted(dj.files) == ['clp', 'inputs']
    assert dt['inputs'].dtype == dt['clp'].dtype == np.float32
    assert dt['inputs'].shape == (2, H, W, 3) and dt['clp'].shape == (2, H, W)
    np.testing.assert_array_equal(dt['inputs'], dj['inputs'])
    _close(dt['clp'], dj['clp'], SYNTH_TOL)

    ci, cq = (c.numpy() for c in NC._carriers(
        H, W, torch.from_numpy(flips[1].astype(np.float32))))
    want = 2.0 * (i_t * ci - q_t * cq)
    c = (slice(60, 480), slice(60, 780))
    err = np.abs(dt['clp'][0] - want)[c]
    assert err.mean() < 0.25 * np.abs(want)[c].mean(), err.mean()

    _, loss = NC.train_nn_comb(torch.Generator().manual_seed(0), steps=3,
                               batch=2, h=48, w=160, features=FEATURES,
                               data=(dj['inputs'], dj['clp']), device='cpu')
    assert np.isfinite(loss)
    with jax.enable_x64(False):
        _, jloss = JNC.train_nn_comb(steps=2, batch=2, h=48, w=160,
                                     features=FEATURES,
                                     data=(dt['inputs'], dt['clp']))
    assert np.isfinite(jloss)


def test_training_pairs_windows():
    """Pairs made PAIR_WINDOW frames at a time equal pairs made all at
    once, from numpy frames or from a tensor (which stays on its device)."""
    n = NC.PAIR_WINDOW + 3
    frames, _, _ = _static_frames(n)
    a_inp, a_clp = NC.training_pairs_from_frames(frames, device='cpu')
    t = torch.from_numpy(frames.astype(np.int32))
    b_inp, b_clp = NC.training_pairs_from_frames(t)
    assert a_inp.shape == (n - 2, H, W, 3)
    np.testing.assert_array_equal(a_inp, b_inp)
    np.testing.assert_array_equal(a_clp, b_clp)
    whole = NC._training_pair(t[1:-1], t[:-2], t[2:],
                              CN.CombConfig(dim=3, opticalflow=False))
    np.testing.assert_array_equal(a_clp, whole[1].numpy())
    with pytest.raises(ValueError, match='>= 3 frames'):
        NC.training_pairs_from_frames(frames[:2], device='cpu')


@pytest.fixture(scope='module')
def trained():
    """A short port-only run at the JAX test's settings
    (tests/test_nn_comb.py::trained)."""
    return NC.train_nn_comb(torch.Generator().manual_seed(0), steps=100,
                            batch=4, h=48, w=160, lr=4e-3, device='cpu')


def test_train_separates_chroma(trained):
    """The trained port model beats the bare 1D stencil's luma leakage on
    held-out scenes (the bounds of tests/test_nn_comb.py)."""
    model, loss = trained
    assert loss < 80.0, loss                       # IRE^2
    inp, clp_t, *_ = NC.synth_batch(torch.Generator().manual_seed(42), 2,
                                    96, 384)
    with torch.no_grad():
        pred = model(inp)
    c = (slice(None), slice(12, -12), slice(24, -24))
    err_nn = (pred - clp_t).abs().numpy()[c] / NC.IRESCALE
    assert err_nn.mean() < 7.0, err_nn.mean()
    raws = ((inp[..., 0] + 1.0) * 32768.0).numpy()
    rp = np.pad(raws, ((0, 0), (0, 0), (2, 2)))
    stencil = (rp[..., 4:] + rp[..., :-4]) / 2 - raws
    err_1d = np.abs(stencil - clp_t.numpy())[c] / NC.IRESCALE
    assert err_nn.mean() < 0.9 * err_1d.mean(), (err_nn.mean(),
                                                 err_1d.mean())


def test_comb_frame_nn_rgb(trained):
    """Full-frame RGB through comb_frame_nn with the trained port model
    against ground truth (the bounds of tests/test_nn_comb.py)."""
    model, _ = trained
    raw_u16, (y_t, i_t, q_t) = _nn_frame(9)
    cfg = CN.CombConfig(dim=2, nr_y=0.0, nr_c=0.0, wide=True)
    rgb, _ = NC.comb_frame_nn(torch.from_numpy(raw_u16.astype(np.int32)),
                              model, -1.0, cfg)
    rgb = rgb.numpy().astype(np.float64)

    first = cfg.firstline
    rows = slice(first, first + cfg.linesout)

    def sh(a):
        return np.pad(a[0].numpy(), ((0, 0), (0, 2)))[:, 2:]

    y_ire = -40.0 + (sh(y_t)[rows] - CN.IREBASE) / CN.IRESCALE
    qq = sh(i_t)[rows] / CN.IRESCALE
    ii = sh(q_t)[rows] / CN.IRESCALE
    y2 = (y_ire - cfg.black_ire) * (100.0 / (100.0 - cfg.black_ire))
    r = y2 + 0.956 * ii + 0.621 * qq
    g = y2 - 0.272 * ii - 0.647 * qq
    b = y2 - 1.106 * ii + 1.703 * qq
    exp = np.clip(np.stack([r, g, b], -1) * (cfg.brightness * 256 / 100),
                  0, 65535)
    d = np.abs(rgb - exp)[:, 100:800] / 655.36
    assert np.median(d) < 4.0, np.median(d)
    assert np.percentile(d, 95) < 16.0, np.percentile(d, 95)


def test_trainer_device_default():
    """The trainer runs on the card unless asked for the CPU: without a
    card it raises, it never trains on the CPU by itself."""
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present')
    with pytest.raises(RuntimeError, match='no CUDA device'):
        NC.train_nn_comb(steps=1)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        NC.write_training_file(np.zeros((3, H, W), np.uint16), 'x.npz')
