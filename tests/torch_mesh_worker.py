"""One rank of tests/test_torch_parallel.py's gloo worlds on the CPU.

    python tests/torch_mesh_worker.py RANK WORLD PORT WORKDIR

Reads WORKDIR/inputs.npz and WORKDIR/spec.json (written by the test),
joins a gloo process group of WORLD ranks at tcp://127.0.0.1:PORT, runs
every sharded function of ld_decode_tpu_torch/parallel/mesh.py and the
data-parallel NN trainer on its shard, and writes its outputs to
WORKDIR/rank<RANK>.npz.  In the world of GRAPH_WORLD ranks it also runs
each of them through the emulated graph protocol (utils/graphs.py), 3
calls a function with changing inputs, the last on the eager call's
inputs (keys prefixed 'g_').  Imports only the PyTorch port."""

import datetime
import json
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from ld_decode_tpu_torch.comb import comb_ntsc as CN  # noqa: E402
from ld_decode_tpu_torch.models import nn_comb as NC  # noqa: E402
from ld_decode_tpu_torch.ops import demod as D  # noqa: E402
from ld_decode_tpu_torch.ops import filters as F  # noqa: E402
from ld_decode_tpu_torch.parallel import mesh as M  # noqa: E402
from ld_decode_tpu_torch.utils.graphs import GraphCache  # noqa: E402
from ld_decode_tpu_torch.utils.params import DecoderConfig  # noqa: E402

TIMEOUT_S = 120          # a collective that waits longer fails the rank
GRAPH_WORLD = 2          # the world that also runs them graphed

# the NN trainer's test run (the JAX package's tests/test_parallel.py)
NN = dict(steps=3, batch=4, h=16, w=64, features=(8, 8), seed=5, lr=3e-3)


def small_cfg():
    return DecoderConfig(system='NTSC', freq_mhz=40.0, blocklen=2048,
                         blockcut=128, blockcut_end=32)


def first_step_grads(mesh=None):
    """The gradients of train_nn_comb's first step (NN's settings), as
    the trainer draws its weights and batch."""
    gen = torch.Generator().manual_seed(NN['seed'])
    model = NC.NNComb(NN['features'])
    model.reset_parameters(gen)
    opt = NC.make_optimizer(model, NN['lr'])
    inp, clp_t, *_ = NC.synth_batch(gen, NN['batch'], NN['h'], NN['w'])
    NC.train_step(model, opt, inp, clp_t, mesh)
    return {k: p.grad.clone() for k, p in model.named_parameters()}


def train(mesh=None, graphs=None):
    model, loss = NC.train_nn_comb(
        torch.Generator().manual_seed(NN['seed']), steps=NN['steps'],
        batch=NN['batch'], h=NN['h'], w=NN['w'], lr=NN['lr'],
        features=NN['features'], device='cpu', mesh=mesh, graphs=graphs)
    return model.state_dict(), loss


def _leaves(x) -> list:
    """The tensors of a sharded call's result, in order."""
    if isinstance(x, dict):
        return [v for k in sorted(x) for v in _leaves(x[k])]
    if isinstance(x, (tuple, list)):
        return [v for y in x for v in _leaves(y)]
    return [x]


def _graphed(build, args_of, res: dict, name: str):
    """build(cache) -> a sharded function on an emulated cache, called
    with args_of(0), args_of(1), args_of(2): a warm-up, a capture and a
    replay on changing inputs, the last the eager call's.  Returns the
    last call's outputs (the static outputs: copy what is kept); the
    cache's counts go to res as g_<name>_counts, and whether each earlier
    call's outputs differ from the last (so each input reached the
    replay) as g_<name>_varied."""
    cache = GraphCache('cpu', 'emulate')
    fn = build(cache)
    seen = []
    for k in range(3):
        out = fn(*args_of(k))
        seen.append([torch.as_tensor(x).clone() for x in _leaves(out)])
    res[f'g_{name}_counts'] = np.array(list(cache.counts.values()))
    res[f'g_{name}_varied'] = np.array([
        any(not torch.equal(a, b) for a, b in zip(prev, seen[-1]))
        for prev in seen[:-1]])
    return out


def main(rank: int, world: int, port: int, workdir: str):
    torch.set_num_threads(1)
    dist.init_process_group(
        'gloo', init_method=f'tcp://127.0.0.1:{port}', rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=TIMEOUT_S))
    spec = json.load(open(os.path.join(workdir, 'spec.json')))
    inp = np.load(os.path.join(workdir, 'inputs.npz'))
    res = {}

    # sharded demod on its own layout (dp 2 x sp 2, or dp 1 x sp 2)
    dmesh = M.make_mesh(dp=spec['demod_dp'][str(world)], device='cpu')
    cfg = small_cfg()
    bank = F.make_demod_bank(cfg, np.complex64, device='cpu')
    streams = inp['demod_streams']
    nblocks, keep = spec['demod_nblocks'], cfg.block_keep
    f_l = streams.shape[0] // dmesh.dp
    cols = nblocks // dmesh.sp * keep
    body = streams[dmesh.dp_index * f_l:(dmesh.dp_index + 1) * f_l,
                   dmesh.sp_index * cols:(dmesh.sp_index + 1) * cols]
    step = M.build_sharded_demod(cfg, bank, dmesh, nblocks,
                                 streams.shape[0])
    demod, pidx, pval = step(torch.from_numpy(np.ascontiguousarray(body)),
                             1.0)
    res.update(demod=demod.numpy(), pidx=pidx.numpy(), pval=pval.numpy())
    graphed = world == GRAPH_WORLD
    if graphed:
        b = torch.from_numpy(np.ascontiguousarray(body))
        out = _graphed(lambda c: M.build_sharded_demod(
            cfg, bank, dmesh, nblocks, streams.shape[0], graphs=c),
            lambda k: (b * (1 + k - 2 * (k == 2)), (0.6, 0.8, 1.0)[k]),
            res, 'demod')
        res.update({f'g_{k}': v.numpy().copy()
                    for k, v in zip(('demod', 'pidx', 'pval'), out)})

    mesh = M.make_mesh(device='cpu')
    res['layout'] = np.array([mesh.dp, mesh.sp, mesh.dp_index,
                              mesh.sp_index, dmesh.dp, dmesh.sp,
                              dmesh.dp_index, dmesh.sp_index])
    for system, p in spec['pipeline'].items():
        pcfg = DecoderConfig(system=system, freq_mhz=40.0)
        pbank = F.make_demod_bank(pcfg, np.complex64, device='cpu')
        n_audio1 = p['nblocks'] * pbank.a_stage1_keep \
            if pbank.has_audio else 0
        fn = M.build_pipeline_batch_sharded(
            pcfg, pbank, mesh, p['nblocks'], n_audio1, p['batch'],
            p['pitch'])
        cap = torch.from_numpy(inp[f'cap_{system}'].astype(np.float32))
        out, ns, no = fn(cap, p['start'], p['offset0'], 1.0)
        for k, v in out.items():
            res[f'{system}_{k}'] = v.numpy()
        res[f'{system}_next'] = np.array([int(ns), float(no)])
        if graphed:
            # start0, audio_offset0, mtf_level and valid_len change from
            # call to call (the first valid_len clamps the last fields'
            # windows); the replay takes the eager call's
            n_stream = D.stream_len(pcfg, p['nblocks'])
            full, s0, pitch = cap.shape[0], p['start'], p['pitch']
            calls = ((s0 + pitch // 2, 0.0, 0.8, s0 + pitch + n_stream),
                     (s0 - pitch // 3, p['offset0'] / 2, 0.9, full - 1),
                     (s0, p['offset0'], 1.0, full))
            out, ns, no = _graphed(
                lambda c: M.build_pipeline_batch_sharded(
                    pcfg, pbank, mesh, p['nblocks'], n_audio1, p['batch'],
                    p['pitch'], graphs=c),
                lambda k: (cap,) + calls[k], res, system)
            res.update({f'g_{system}_{k}': v.numpy().copy()
                        for k, v in out.items()})
            res[f'g_{system}_next'] = np.array([int(ns), float(no)])

    frames = torch.from_numpy(inp['comb_frames'].astype(np.int32))
    nf = frames.shape[0]
    f_l = nf // mesh.size
    comb = M.build_sharded_comb3d(CN.CombConfig(dim=3, opticalflow=False),
                                  mesh, nf)
    mine = frames[mesh.rank * f_l:(mesh.rank + 1) * f_l]
    res['comb_rgb'] = comb(mine).numpy()
    if graphed:
        res['g_comb_rgb'] = _graphed(
            lambda c: M.build_sharded_comb3d(
                CN.CombConfig(dim=3, opticalflow=False), mesh, nf, graphs=c),
            lambda k: (mine.roll(2 - k, dims=2),), res,
            'comb').numpy().copy()

    for k, g in first_step_grads(mesh).items():
        res[f'grad_{k}'] = g.numpy()
    state, loss = train(mesh)
    for k, v in state.items():
        res[f'nn_{k}'] = v.numpy()
    res['nn_loss'] = np.array(loss)
    if graphed:
        cache = GraphCache('cpu', 'emulate')
        state, loss = train(mesh, cache)
        res.update({f'g_nn_{k}': v.numpy() for k, v in state.items()})
        res['g_nn_loss'] = np.array(loss)
        res['g_nn_counts'] = np.array(list(cache.counts.values()))

    np.savez(os.path.join(workdir, f'rank{rank}.npz'), **res)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == '__main__':
    main(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
