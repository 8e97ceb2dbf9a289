"""PyTorch port, the NN comb under the compile boundary (utils/graphs.py):
the train step (`Trainer.step`: the batch draw, forward, backward and
Adam's update, the JAX package's jitted `jstep`), `comb_frame_nn` after
its AGC and the training-pair windows, each through a GraphCache in the
emulated protocol against `graphs=False`, bit for bit; and what the cache
gained for them: generators drawn from inside a key, state updated in
place, the rule for a host-staged mesh.

Every key serves at least 3 calls past its warm-up with changing data (a
capture, then replays), so a stale input, a value frozen into the
capture or a generator that a replay did not advance would show.  The
card test runs the same comparisons with CUDA graphs."""

import types

import numpy as np
import pytest
import torch

from ld_decode_tpu_torch.comb import comb_ntsc as CN
from ld_decode_tpu_torch.models import nn_comb as NC
from ld_decode_tpu_torch.parallel import mesh as M
from ld_decode_tpu_torch.utils.graphs import GraphCache, as_cache

torch.set_num_threads(2)

FEATURES = (8, 8)
SIZE = dict(batch=2, h=16, w=64)
STEPS = 5


def emulated():
    return GraphCache('cpu', 'emulate')


def _draw(gen):
    return (torch.randn((3, 5), generator=gen)
            + torch.randint(0, 7, (4,), generator=gen).sum()
            + torch.rand((2,), generator=gen).sum())


def test_generator_draws_follow_eager():
    """A key that draws from two generators: over 6 calls (a warm-up, a
    capture, replays) each draw equals the eager draw from the same seeds,
    and each generator ends in the eager state.  Another generator is
    another key."""
    def run(graphs):
        ga = torch.Generator().manual_seed(7)
        gb = torch.Generator().manual_seed(8)
        out = []
        for _ in range(6):
            r = graphs('draw', lambda: _draw(ga) * _draw(gb), (),
                       generators=(ga, gb))
            out.append(r.clone())
        return out, ga.get_state(), gb.get_state()

    cache = emulated()
    eager, got = run(GraphCache('cpu', 'eager')), run(cache)
    for a, b in zip(eager[0], got[0]):
        assert torch.equal(a, b)
    assert not torch.equal(got[0][-1], got[0][-2])
    assert torch.equal(eager[1], got[1]) and torch.equal(eager[2], got[2])
    assert cache.counts == {'eager_warmups': 1, 'captures': 1,
                            'replays': 5}
    other = torch.Generator().manual_seed(7)
    cache('draw', lambda: _draw(other), (), generators=(other,))
    assert cache.counts['eager_warmups'] == 2


def _data(seed=3, n=3):
    """A small training file's (inputs, clp) tensors."""
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.standard_normal(
                (n, 24, 96, 3)).astype(np.float32)),
            torch.from_numpy(rng.standard_normal(
                (n, 24, 96)).astype(np.float32) * 400))


def _trainer(graphs, data=None, seed=5):
    gen = torch.Generator().manual_seed(seed)
    model = NC.NNComb(FEATURES)
    model.reset_parameters(gen)
    return NC.Trainer(model, NC.make_optimizer(model, 3e-3), gen,
                      data=data, graphs=graphs, **SIZE)


def _train(graphs, data=None):
    t = _trainer(graphs, data)
    losses = [t.step().clone() for _ in range(STEPS)]
    return t, losses


def _adam_state(t):
    return [(k, v) for st in t.opt.state.values() for k, v in st.items()]


@pytest.mark.parametrize('source', ['synthetic', 'file'])
def test_train_steps_equal_eager(source):
    """5 train steps, synthetic batches or crops of a training file: the
    first eager outside the cache (Adam makes its state there), then one
    warm-up, one capture and 3 replays of one key.  Losses, parameters,
    gradients, Adam's moments and step counts and the generator equal the
    eager trainer's bit for bit."""
    data = _data() if source == 'file' else None
    te, le = _train(False, data)
    tg, lg = _train(emulated(), data)
    assert all(torch.equal(a, b) for a, b in zip(le, lg))
    assert len(set(float(x) for x in lg)) == STEPS
    for (n, a), b in zip(te.model.named_parameters(),
                         tg.model.parameters()):
        assert torch.equal(a, b), n
        assert torch.equal(a.grad, b.grad), n
    se, sg = _adam_state(te), _adam_state(tg)
    assert len(se) == len(sg) == 3 * len(list(te.model.parameters()))
    for (k, a), (_, b) in zip(se, sg):
        assert torch.equal(torch.as_tensor(a), torch.as_tensor(b)), k
    assert torch.equal(te.generator.get_state(), tg.generator.get_state())
    assert tg.graphs.counts == {'eager_warmups': 1, 'captures': 1,
                                'replays': STEPS - 2}
    assert len(tg.graphs._graphs) == 1


def test_train_nn_comb_graphs_equal_eager():
    """The whole trainer through one emulated cache: the final loss and
    the weights equal graphs=False's."""
    kw = dict(steps=4, features=FEATURES, device='cpu', **SIZE)
    me, le = NC.train_nn_comb(torch.Generator().manual_seed(0),
                              graphs=False, **kw)
    mg, lg = NC.train_nn_comb(torch.Generator().manual_seed(0),
                              graphs=emulated(), **kw)
    assert le == lg
    for k, v in me.state_dict().items():
        assert torch.equal(v, mg.state_dict()[k]), k


def test_staged_mesh_runs_eagerly():
    """A host-staged gloo mesh (ranks sharing a card) runs its calls
    eagerly by default; asking for graphs there raises, in the sharded
    calls and the data-parallel trainer alike (as_cache's `staged`)."""
    assert as_cache(None, 'cuda', staged=True).mode == 'eager'
    assert as_cache(False, 'cuda', staged=True).mode == 'eager'
    for graphs in (True, GraphCache('cuda')):
        with pytest.raises(ValueError, match='host-staged'):
            as_cache(graphs, 'cuda', staged=True)
    staged = types.SimpleNamespace(staged=True, device=torch.device('cuda'))
    with pytest.raises(ValueError, match='host-staged'):
        NC.train_nn_comb(mesh=staged, graphs=True, features=FEATURES,
                         **SIZE)
    with pytest.raises(ValueError, match='host-staged'):
        M.build_sharded_comb3d(CN.CombConfig(dim=3, opticalflow=False),
                               types.SimpleNamespace(staged=True, size=1,
                                                     rank=0,
                                                     device=staged.device),
                               2, graphs=True)
    assert as_cache(None, 'cpu').mode == 'eager'
    assert as_cache(emulated(), 'cpu', staged=True).mode == 'emulate'


def _frames(n, seed=9):
    """n .tbc-like frames: a synthetic scene whose content and burst level
    change from frame to frame, line-0 flags in column 0."""
    out = []
    for k in range(n):
        inp, *_ = NC.synth_batch(torch.Generator().manual_seed(seed + k), 1,
                                 CN.IN_Y, CN.IN_X)
        raw = ((inp[0, :, :, 0] + 1.0) * 32768.0).numpy()
        raw[:, 0] = np.where(inp[0, :, 0, 1].numpy() > 0, 16384.0, 32768.0)
        raw[:, 1] = (8.0 + 3 * k) * CN.IRESCALE
        out.append(np.clip(raw, 0, 65535).astype(np.int32))
    return torch.from_numpy(np.stack(out))


def test_comb_frame_nn_equals_eager():
    """comb_frame_nn over 5 changing frames through one emulated cache:
    one key (the AGC stays on the host, its levels an input, the weights
    read in place), RGB and the AGC carry equal to eager; the model
    retrained in place is read by the next replay."""
    model = NC.NNComb(FEATURES)
    cfg = CN.CombConfig(dim=2)
    frames = _frames(5)
    cache = emulated()
    ab_e = ab_g = -1.0
    prev = None
    for k, f in enumerate(frames):
        if k == 3:
            with torch.no_grad():
                model.out.bias.add_(0.01)
        want, ab_e = NC.comb_frame_nn(f, model, ab_e, cfg)
        got, ab_g = NC.comb_frame_nn(f, model, ab_g, cfg, graphs=cache)
        assert got.dtype == torch.int32 and torch.equal(want, got)
        assert ab_e == ab_g
        assert prev is None or not torch.equal(prev, want)
        prev = want.clone()
    assert cache.counts == {'eager_warmups': 1, 'captures': 1,
                            'replays': 4}


def test_training_pairs_equal_eager():
    """Training pairs of 3 windows of PAIR_WINDOW frames and a tail of 2:
    one key a window length (the 8-frame key warms up, captures and
    replays), equal to graphs=False; write_training_file goes through
    it."""
    n = 3 * NC.PAIR_WINDOW + 4
    frames = _frames(n, seed=30)
    want = NC.training_pairs_from_frames(frames, graphs=False)
    cache = emulated()
    got = NC.training_pairs_from_frames(frames, graphs=cache)
    for a, b in zip(want, got):
        assert a.shape[0] == n - 2 and np.array_equal(a, b)
    assert cache.counts == {'eager_warmups': 2, 'captures': 1,
                            'replays': 2}


def _count_host_tensors(monkeypatch):
    made = {'from_numpy': 0, 'as_tensor': 0, 'tensor': 0}
    for name in made:
        real = getattr(torch, name)

        def counted(*a, _real=real, _name=name, **k):
            made[_name] += 1
            return _real(*a, **k)
        monkeypatch.setattr(torch, name, counted)
    return made


@pytest.mark.parametrize('program', ['train_step', 'file_step', 'comb_nn',
                                     'pairs'])
def test_nn_programs_no_host_copies(monkeypatch, program):
    """A host-to-device copy from pageable memory is illegal in a capture:
    once warm, each new key's program creates no tensor from host data."""
    frames = _frames(3)
    model = NC.NNComb(FEATURES)
    cfg = CN.CombConfig(dim=2)
    levels, _ = CN.burst_levels(frames[:1], -1.0, cfg)
    trainer = _trainer(False, _data() if program == 'file_step' else None)
    call = {
        'train_step': trainer._step, 'file_step': trainer._step,
        'comb_nn': lambda: NC._comb_nn_core(frames[0], levels[0], model,
                                            cfg),
        'pairs': lambda: NC._training_pair(
            frames[1:2], frames[:1], frames[2:],
            CN.CombConfig(dim=3, opticalflow=False))}[program]
    call()
    made = _count_host_tensors(monkeypatch)
    call()
    assert made == {'from_numpy': 0, 'as_tensor': 0, 'tensor': 0}


# graphed vs eager training on the card where eager does not repeat itself
# (cuDNN's weight gradients): each of the losses (relative), parameters
# and Adam's moments within this many times the largest spread among
# CARD_EAGER_RUNS eager runs (chip_smoke.py phase 19's rule; PERF.md has
# its readings)
CARD_SPREAD = 2
CARD_EAGER_RUNS = 5
CARD_STEPS = 30          # eager's first difference came at steps 5-10


def _spreads(run_a, run_b) -> dict:
    """Largest differences of two runs (losses, trainer): losses relative,
    parameters and each Adam moment absolute; Adam's step counts must be
    equal."""
    (la, ta), (lb, tb) = run_a, run_b
    out = {'loss': float(((la - lb).abs() / la.abs()).max()),
           'param': max(float((a - b).abs().max()) for a, b in zip(
               ta.model.parameters(), tb.model.parameters()))}
    for k in ('exp_avg', 'exp_avg_sq'):
        out[k] = max(float((sa[k] - sb[k]).abs().max()) for sa, sb in zip(
            ta.opt.state.values(), tb.opt.state.values()))
    assert all(torch.equal(sa['step'], sb['step']) for sa, sb in zip(
        ta.opt.state.values(), tb.opt.state.values()))
    return out


@pytest.mark.cuda
def test_card_nn_graphs_equal_eager():
    """On the card: the train step replayed as a CUDA graph (capturable
    Adam both ways) against eager, held as far as eager holds against
    itself: bit for bit where CARD_EAGER_RUNS eager runs agree, else
    losses, parameters and Adam's state within CARD_SPREAD times their
    largest spread; comb_frame_nn and the training pairs bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device: CUDA graphs have no CPU mode')

    def run(graphs):
        gen = torch.Generator('cuda').manual_seed(5)
        model = NC.NNComb((24, 24)).cuda()
        model.reset_parameters(gen)
        t = NC.Trainer(model, NC.make_optimizer(model, 3e-3), gen, 8, 64,
                       256, graphs=graphs)
        losses = torch.stack([t.step().clone() for _ in range(CARD_STEPS)])
        return losses, t

    eager = [run(False) for _ in range(CARD_EAGER_RUNS)]
    g = run(True)
    assert g[1].graphs.counts['captures'] == 1
    assert torch.equal(eager[0][1].generator.get_state(),
                       g[1].generator.get_state())
    # the first loss is a forward of the same weights on the same draws
    assert torch.equal(eager[0][0][0], g[0][0])
    own = [_spreads(a, b) for i, a in enumerate(eager)
           for b in eager[i + 1:]]
    got = [_spreads(e, g) for e in eager]
    for k in own[0]:
        limit = CARD_SPREAD * max(x[k] for x in own)
        assert max(x[k] for x in got) <= limit, (k, got, own)

    model = g[1].model
    cfg = CN.CombConfig(dim=2)
    cache = GraphCache('cuda')
    frames = _frames(4).cuda()
    ab_e = ab_g = -1.0
    for f in frames:
        want, ab_e = NC.comb_frame_nn(f, model, ab_e, cfg)
        got, ab_g = NC.comb_frame_nn(f, model, ab_g, cfg, graphs=cache)
        assert torch.equal(want, got) and ab_e == ab_g
    frames = _frames(2 * NC.PAIR_WINDOW + 4, seed=30).cuda()
    for a, b in zip(NC.training_pairs_from_frames(frames, graphs=False),
                    NC.training_pairs_from_frames(frames)):
        assert np.array_equal(a, b)
