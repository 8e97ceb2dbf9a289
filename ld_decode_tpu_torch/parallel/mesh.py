"""Multi-device sharding of the decode pipeline over torch.distributed
(torch port of ld_decode_tpu/parallel/mesh.py).

The JAX package runs one program over a device mesh with `shard_map`; the
port runs one process a rank (SPMD), and each function below returns the
rank's local shard of what the JAX function returns.  The caller has run
`torch.distributed.init_process_group` (`default_backend` says which
backend suits the ranks and cards at hand).

Shard axes, as in the JAX package:
  * 'dp' -- field/frame data parallelism (fields are independent modulo
    tiny carries: the audio offset and the next batch's start, exchanged
    as gathered int32 vectors and replayed on every rank);
  * 'sp' -- intra-field sample/block parallelism: the overlap-save block
    axis of the demodulator.  Each shard holds a contiguous run of block
    bodies; the 1056-sample overlap tail of a shard's last block is the
    head of the next shard (JAX's `ppermute`, here an all-gather of the
    heads and a pick of the neighbour's).
Ranks are laid out row-major over (dp, sp), as JAX's `reshape(dp, sp)`;
the flat 'f' order of the batch pipeline and the 3D comb is the rank
order.

Backends.  NCCL takes one rank a card.  Ranks that share a card (or run
on the CPU) use gloo: each collective then copies its CUDA tensors
through host memory explicitly (no reliance on gloo's partial CUDA
support).  The bytes are tiny (per field a few int32 values and a
1,056-sample halo; per frame a 525-value burst column; one edge frame a
comb shard; the NN's gradients), and the compute stays on each rank's
device: nothing moves a rank's work to the CPU.

CUDA graphs (utils/graphs.py, the JAX package's `jax.jit` of each sharded
call): on an NCCL mesh each `build_*` function's step replays its device
program as one CUDA graph a rank, collectives included (`graphs=None`,
the default).  A host-staged gloo mesh runs eagerly: its collectives copy
through host memory, which a capture cannot hold (utils/graphs.py::
as_cache, `staged`; asking for graphs there raises).  One card shows only
part of this: `Mesh.all_gather` and `all_reduce_mean` return before any
collective in a world of one rank, and NCCL refuses two ranks on one
card, so there the 1-rank NCCL world captures everything around the
collectives and the 2-rank gloo world runs eagerly.  On the CPU the gloo
worlds of tests/test_torch_parallel.py run them through the emulated
protocol, collectives included.  NCCL collectives inside a capture stay
unverified until a machine with two or more cards runs them
(chip_smoke.py phase 22).
"""

from __future__ import annotations

from typing import List, Optional, Union

import torch
import torch.distributed as dist

from ld_decode_tpu_torch.ops import demod as D
from ld_decode_tpu_torch.ops.filters import DemodBank
from ld_decode_tpu_torch.tbc import sync as S
from ld_decode_tpu_torch.utils.device import DEFAULT as DEFAULT_DEVICE
from ld_decode_tpu_torch.utils.device import resolve as resolve_device
from ld_decode_tpu_torch.utils.graphs import GraphCache, as_cache
from ld_decode_tpu_torch.utils.params import DecoderConfig


def default_backend(world_size: int, device=DEFAULT_DEVICE) -> str:
    """'nccl' when every rank has a card of its own, else 'gloo' (ranks
    on the CPU, or more ranks than cards: NCCL refuses two ranks on one
    GPU)."""
    dev = torch.device(device)
    if dev.type == 'cuda' and world_size <= torch.cuda.device_count():
        return 'nccl'
    return 'gloo'


class Mesh:
    """A (dp, sp) layout of the ranks of the default process group.

    rank / size: this rank and the world; dp_index / sp_index: its
    coordinates (rank = dp_index * sp + sp_index); dp_group: the ranks
    with its sp_index (a collective over 'dp'); sp_group: the ranks with
    its dp_index (over 'sp'); backend; device: where its work runs."""

    def __init__(self, dp: int, sp: int, device: torch.device):
        self.dp, self.sp = dp, sp
        self.rank = dist.get_rank()
        self.size = dist.get_world_size()
        self.dp_index, self.sp_index = divmod(self.rank, sp)
        self.backend = dist.get_backend()
        self.device = device
        # every rank creates every group, in the same order
        self.sp_group = self.dp_group = None
        for i in range(dp):
            g = dist.new_group([i * sp + j for j in range(sp)])
            if i == self.dp_index:
                self.sp_group = g
        for j in range(sp):
            g = dist.new_group([i * sp + j for i in range(dp)])
            if j == self.sp_index:
                self.dp_group = g
        self.world_group = dist.group.WORLD
        # gloo moves CUDA tensors through host memory, one explicit copy
        # each way
        self.staged = self.backend != 'nccl' and device.type == 'cuda'

    def __repr__(self):
        return (f'Mesh(dp={self.dp}, sp={self.sp}, rank={self.rank}, '
                f'backend={self.backend!r}, device={self.device})')

    def _wire(self, t: torch.Tensor) -> torch.Tensor:
        t = t.contiguous()
        if t.dtype == torch.uint16:          # not a gloo/NCCL dtype
            t = t.to(torch.int32)
        return t.cpu() if self.staged else t

    def all_gather(self, t: torch.Tensor, group) -> List[torch.Tensor]:
        """`t` of every rank of `group`, in rank order, on this rank's
        device (same shapes on every rank)."""
        n = dist.get_world_size(group)
        if n == 1:
            return [t]
        src = self._wire(t)
        bufs = [torch.empty_like(src) for _ in range(n)]
        dist.all_gather(bufs, src, group=group)
        return [b.to(device=t.device, dtype=t.dtype) for b in bufs]

    def all_reduce_mean(self, t: torch.Tensor, group) -> torch.Tensor:
        """The mean of `t` over `group` (float), on this rank's device."""
        n = dist.get_world_size(group)
        if n == 1:
            return t
        buf = self._wire(t).clone()
        dist.all_reduce(buf, group=group)
        return (buf / n).to(t.device)


def make_mesh(n_devices: Optional[int] = None, dp: Optional[int] = None,
              device=DEFAULT_DEVICE) -> Mesh:
    """The (dp, sp) mesh over the ranks (JAX's `make_mesh`): dp = 2 when
    the world size is even and > 1, else 1; sp = world // dp.  On CUDA
    each rank takes card `rank % device_count` unless `device` names
    one."""
    if not dist.is_initialized():
        raise RuntimeError('make_mesh: call torch.distributed.'
                           'init_process_group first (one process a rank)')
    world = dist.get_world_size()
    n_devices = world if n_devices is None else n_devices
    if n_devices != world:
        raise ValueError(f'make_mesh: {n_devices} devices, but the process '
                         f'group has {world} ranks')
    if dp is None:
        dp = 2 if world % 2 == 0 and world > 1 else 1
    if world % dp:
        raise ValueError(f'make_mesh: dp={dp} does not divide {world}')
    dev = resolve_device(device, "make_mesh(device='cpu')")
    if dev.type == 'cuda' and dev.index is None:
        dev = torch.device('cuda', dist.get_rank() % torch.cuda.device_count())
    if dev.type == 'cuda':
        torch.cuda.set_device(dev)
    return Mesh(dp, world // dp, dev)


def build_sharded_demod(cfg: DecoderConfig, bank: DemodBank, mesh: Mesh,
                        nblocks: int, nfields: int,
                        graphs: Union[bool, GraphCache, None] = None):
    """Multi-rank demod step: fn(body, mtf_level) -> (demod, pidx, pval).

    body: this rank's (nfields/dp, nblocks/sp * block_keep) float32 block
    bodies, the (dp_index, sp_index) tile of the (nfields, nblocks *
    block_keep) bodies.  Returns its demod tap (same tile), and each of
    its fields' sync peak indices and values over the whole field
    (replicated along sp).  The halo after the globally last block wraps
    to the first shard's head, as JAX's circular ppermute does.

    graphs (None: by the mesh, as the module says): the step is one CUDA
    graph a body shape on an NCCL mesh, mtf_level a tensor input;
    replayed, its outputs are the graph's static tensors, which the next
    call overwrites."""
    keep = cfg.block_keep
    overlap = cfg.blocklen - keep
    n_sp = mesh.sp
    if nblocks % n_sp or nfields % mesh.dp:
        raise ValueError(f'{nblocks} blocks and {nfields} fields do not '
                         f'split over sp={n_sp} and dp={mesh.dp}')
    nb_l = nblocks // n_sp
    window = max(int(cfg.linelen * 0.4), 2)

    def local_step(body: torch.Tensor, mtf_level):
        F_l = body.shape[0]
        # halo: my head goes to the previous sp-shard (its last block's
        # tail), circularly
        heads = mesh.all_gather(body[:, :overlap], mesh.sp_group)
        ext = torch.cat([body, heads[(mesh.sp_index + 1) % n_sp]], dim=1)
        blocks = ext.unfold(-1, cfg.blocklen, keep)[:, :nb_l]
        R_os = torch.fft.rfft(blocks.reshape(F_l * nb_l, -1).to(bank.rdtype))
        taps = D.demod_video_rfft(R_os, bank, cfg, mtf_level)
        out = {k: v[:, cfg.blockcut:cfg.blockcut + keep].reshape(
            F_l, nb_l * keep) for k, v in taps.items()}
        # the whole field's sync channel on every sp shard, in sp order
        sync_full = torch.cat(mesh.all_gather(out['demod_sync'],
                                              mesh.sp_group), dim=1)
        pidx, pval = S.find_sync_peaks(sync_full, window)
        return out['demod'], pidx, pval

    cache = as_cache(graphs, mesh.device, mesh.staged)
    key = ('sharded_demod', id(bank), cfg, nblocks, nfields)

    def step(body: torch.Tensor, mtf_level):
        # mtf_level a tensor input: a capture would freeze a host value
        return cache(key, local_step,
                     (body, D._level(mtf_level, bank.rdtype, body.device)))

    return step


def build_pipeline_batch_sharded(cfg: DecoderConfig, bank: DemodBank,
                                 mesh: Mesh, nblocks: int, n_audio1: int,
                                 batch: int, field_pitch: int,
                                 colorlevel: float = 1.45,
                                 colorphase: float = 91.5,
                                 codec: bool = False,
                                 graphs: Union[bool, GraphCache, None] = None):
    """Multi-rank `fused.field_pipeline_batch`: the whole speculative
    field batch -- demod, vsync/line voting, hsync/burst (or pilot)
    refinement, the picture resample (K1), audio chase, VBI -- sharded
    over every rank in the flat 'f' order.

    Returns fn(capture, start0, audio_offset0, mtf_level, valid_len=None)
    -> (outputs, next_start0, next_offset0): outputs is the rank's
    `batch // size` rows of field_pipeline_batch's outputs dict;
    next_start0 / next_offset0 are the chained scalars, the same on every
    rank, so consecutive batches chain as on one device.

    Every rank holds the whole capture (a field's window sits at a
    data-dependent position; JAX replicates it the same way).  Fields are
    independent except for two carries: the 48 kHz resampler offset
    (each field's depends on the line counts before it) and the next
    batch's start.  Each rank decodes its fields, all-gathers the int32
    line counts, next-field offsets and window starts, replays the whole
    float32 offset chain in the single-device op order, and keeps its
    slice.  codec=True adds the picture codec's payloads of the rank's
    own fields ('pic_tab', 'dense', 'dense_q', 'rows2'): each rank
    compacts its fields, as each of JAX's shards does, so the ranks' used
    prefixes in rank order are the whole batch's.

    graphs (None: by the mesh, as the module says): on an NCCL mesh the
    whole call is one CUDA graph a rank, keyed as the single-rank batch
    call is (tbc/pipeline.py) with the capture read in place and start0,
    audio_offset0, mtf_level and valid_len 0-d tensor inputs; K1's
    launches are credited on each replay.  Replayed, the outputs and the
    chained scalars are the graph's static tensors, which the next call
    overwrites: a caller clones what it keeps longer."""
    from ld_decode_tpu_torch.tbc import fused as FU

    nd = mesh.size
    if batch % nd:
        raise ValueError(f'batch {batch} does not split over {nd} ranks')
    lb = batch // nd

    def gather_carry(carry: torch.Tensor) -> torch.Tensor:
        return torch.cat(mesh.all_gather(carry, mesh.world_group), dim=1)

    cache = as_cache(graphs, mesh.device, mesh.staged)
    key = ('field_pipeline_batch_sharded', id(bank), cfg, nblocks, n_audio1,
           lb, field_pitch, colorlevel, colorphase, codec, mesh.rank)

    def call(capture, start0, audio_offset0, mtf_level, valid_len):
        return FU.field_pipeline_batch(
            capture, start0, audio_offset0, mtf_level, bank, cfg, nblocks,
            n_audio1, lb, field_pitch, colorlevel, colorphase, valid_len,
            batch_index=mesh.rank * lb, gather_carry=gather_carry,
            codec=codec)

    def shard_fn(capture: torch.Tensor, start0, audio_offset0, mtf_level,
                 valid_len=None):
        dev = capture.device
        if valid_len is None:
            valid_len = capture.shape[0]
        # the scalars are tensor inputs: a capture would freeze host values
        return cache(key, lambda *a: call(capture, *a), (
            FU._scalar(start0, torch.int32, dev),
            FU._scalar(audio_offset0, torch.float32, dev),
            FU._scalar(mtf_level, torch.float32, dev),
            FU._scalar(valid_len, torch.int32, dev)), reads=(capture,))

    return shard_fn


def build_sharded_comb3d(comb_cfg, mesh: Mesh, nframes: int,
                         graphs: Union[bool, GraphCache, None] = None):
    """Multi-rank 3D comb (no optical flow): fn(frames) -> RGB.

    frames: this rank's (nframes/size, 525, 910) consecutive .tbc frames
    (the flat 'f' shard, on the mesh's device); returns their (F_l,
    linesout, 910, 3) int32 RGB48.  Each frame needs its neighbours: the
    previous shard's last frame and the next shard's first, circularly
    (the globally first and last frames see wrapped neighbours, warm-up
    frames in the reference too).  The burst AGC EMA (comb-ntsc.cxx:
    563-564) carries across frames exactly: every rank gathers all
    frames' burst columns and replays the whole chain on the host once
    (`agc_levels`, float32), then combs its frames with their levels.
    Equal to the sequential `comb_frame` chain: the frames are combed one
    by one, since a batched pass rounds otherwise on the card (cuBLAS and
    cuDNN pick their kernels by the row count of the IIR matmuls and FIR
    convolutions).

    graphs (None: by the mesh, as the module says): the comb after the
    gathers and the AGC, all the rank's frames, is one CUDA graph a rank
    on an NCCL mesh, the levels a tensor input; replayed, the RGB is the
    graph's static tensor, which the next call overwrites."""
    from ld_decode_tpu_torch.comb.comb_ntsc import _frame_core, agc_levels

    nd = mesh.size
    if nframes % nd:
        raise ValueError(f'{nframes} frames do not split over {nd} ranks')
    di = mesh.rank
    cache = as_cache(graphs, mesh.device, mesh.staged)

    def comb(frames, prevs, nexts, levels):
        # Split3D(f=1): p3line = newer frame, n3line = older frame
        return torch.stack([
            _frame_core(frames[k], nexts[k], prevs[k], levels[k],
                        comb_cfg)[0] for k in range(frames.shape[0])])

    def local_step(frames: torch.Tensor) -> torch.Tensor:
        edges = mesh.all_gather(torch.stack([frames[0], frames[-1]]),
                                mesh.world_group)
        prevs = torch.cat([edges[(di - 1) % nd][1:], frames[:-1]])
        nexts = torch.cat([frames[1:], edges[(di + 1) % nd][:1]])
        burst = torch.cat(mesh.all_gather(frames[:, :, 1].to(torch.int32),
                                          mesh.world_group)).cpu().numpy()
        F_l = frames.shape[0]
        levels, _ = agc_levels(burst, -1.0, comb_cfg)
        levels = torch.from_numpy(levels[di * F_l:(di + 1) * F_l]).to(
            frames.device)
        return cache(('sharded_comb3d', comb_cfg), comb,
                     (frames, prevs, nexts, levels))

    return local_step
