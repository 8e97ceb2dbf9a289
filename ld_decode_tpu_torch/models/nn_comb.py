"""Neural chroma separator (the attic NN-comb capability), torch port of
ld_decode_tpu/models/nn_comb.py.

The reference prototyped a FANN MLP that replaces the hand-crafted 2D
comb's chroma estimate: a 3x9 window of raw composite samples in, the
per-pixel chroma plane out (attic/combg2-4nn.cxx:245-283 `Split2D_NN`,
attic/nntrain.py).  Here, as in the JAX package:

* the model is a small dilated CNN (`NNComb`): the (lines +-2, samples
  +-8) receptive field of the reference MLP applied to the whole frame as
  three convolutions, which run in cuDNN in full float32 (TF32 is off
  package-wide, ld_decode_tpu_torch/__init__.py);
* its inputs are the scaled composite plus the two subcarrier basis
  channels (the 4fsc I/Q carriers with the per-line phase flag folded in);
* training is self-supervised on synthetic composites with dense
  ground-truth YIQ (`synth_batch`), or supervised by the no-flow 3D comb
  on real .tbc frames (`write_training_file`, ldexport -t);
* inference (`comb_frame_nn`) feeds the predicted chroma plane to the
  standard comb tail (split_iq -> adjust_y -> NR -> RGB) of
  comb/comb_ntsc.py.

What changed in the port, each held to the JAX package by
tests/test_torch_nn_comb.py:
  * the model takes the JAX layout (B, H, W, 3) at its boundary and
    permutes to NCHW inside; flax's `nn.gelu` is the tanh approximation,
    so the port uses F.gelu(approximate='tanh'); flax's SAME padding with
    dilation (2, 1) is the symmetric (2, 4) padding; `params_from_flax`
    carries a flax parameter tree across;
  * random numbers come from an explicit torch.Generator (the port cannot
    reproduce jax.random's bits): the draws (`synth_fields`) are apart from
    the deterministic parts (`box_blur`, `compose`), which take the same
    noise as the JAX package's;
  * the training pairs are made a window of frames at a time on the
    frames' device, so a 128-frame run never holds all its pairs there;
  * the train step (`train_step`) is torch.optim.Adam with optax.adam's
    defaults; data-parallel training over a mesh of ranks (the JAX
    package's `mesh=`, parallel/mesh.py) draws the whole batch on every
    rank, trains each on its 'dp' rows and averages the gradients;
  * the AGC of `comb_frame_nn` is the port's host EMA (`burst_levels`),
    as in comb_ntsc.comb_frame;
  * the JAX package's compile boundary is a GraphCache
    (utils/graphs.py): the train step (`Trainer.step`: the batch draw,
    the forward and backward pass and Adam's update, JAX's `jstep`), the
    comb after the AGC in `comb_frame_nn` and each window of training
    pairs replay as one CUDA graph a static key on the card.

Chroma/carrier convention (derived from split_iq, comb-ntsc.cxx:414-483):
the comb tail recovers i/q from the chroma-plane estimate `clp` via
cavg = clp/2 sign-flipped on non-inverted lines, si = +-cavg at even
phases, sq = -+cavg at odd phases.  A composite with chroma
C = flip(y) * (I*ci - Q*cq), ci = [1,0,-1,0], cq = [0,1,0,-1] therefore
demodulates to (I, Q) when clp = 2*flip*C; the generator and the
training target use exactly this identity.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ld_decode_tpu_torch.comb import comb_ntsc as CN
from ld_decode_tpu_torch.utils.device import DEFAULT as DEFAULT_DEVICE
from ld_decode_tpu_torch.utils.device import resolve as resolve_device
from ld_decode_tpu_torch.utils.graphs import GraphCache, as_cache

IRESCALE = CN.IRESCALE
IREBASE = CN.IREBASE
PAIR_WINDOW = 8          # frames a training-pair pass holds on the device


def _carriers(h: int, w: int, flip: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """4fsc I/Q sampling bases with the per-line phase sign folded in.
    flip: (..., h) float32 +-1 (+1 on lines whose .tbc flag is 16384).
    Returns two (..., h, w) tensors."""
    ph = torch.arange(w, device=flip.device) % 4
    ci = torch.where(ph == 0, 1.0, torch.where(ph == 2, -1.0, 0.0))
    cq = torch.where(ph == 1, 1.0, torch.where(ph == 3, -1.0, 0.0))
    return flip[..., :, None] * ci, flip[..., :, None] * cq


class NNComb(nn.Module):
    """Dilated CNN chroma estimator.

    Input (B, H, W, 3): [composite scaled to ~[-1,1], carrier_i,
    carrier_q].  Output (B, H, W): the chroma plane `clp` in raw u16
    units, ready for split_iq.  Line dilation 2 = the comb's same-field
    +-2 frame-line neighbours.  The weights start as flax's default
    (`reset_parameters`)."""

    def __init__(self, features: Sequence[int] = (24, 24),
                 generator: torch.Generator = None):
        super().__init__()
        self.features = tuple(features)
        cin = 3
        convs = []
        for f in self.features:
            convs.append(nn.Conv2d(cin, f, (3, 9), dilation=(2, 1),
                                   padding=(2, 4)))
            cin = f
        self.convs = nn.ModuleList(convs)
        self.out = nn.Conv2d(cin, 1, (3, 3), padding=1)
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator = None):
        """flax.linen.Conv's initialisers: lecun_normal kernels (a normal
        truncated at 2 sigma, scaled to variance 1/fan_in) and zero
        biases, drawn from `generator` (the model must be on its device;
        default: seed 0 on the model's device)."""
        if generator is None:
            generator = torch.Generator(
                device=self.out.weight.device).manual_seed(0)
        for conv in list(self.convs) + [self.out]:
            w = conv.weight
            fan_in = w.shape[1] * w.shape[2] * w.shape[3]
            std = math.sqrt(1.0 / fan_in) / .87962566103423978
            nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std,
                                  generator=generator)
            conv.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x.permute(0, 3, 1, 2)
        for conv in self.convs:
            h = F.gelu(conv(h), approximate='tanh')
        return self.out(h)[:, 0] * (30.0 * IRESCALE)


def params_from_flax(params) -> Dict[str, torch.Tensor]:
    """A flax NNComb parameter tree ({'params': {'Conv_k': {'kernel',
    'bias'}}}, numpy arrays) as an NNComb state_dict: flax kernels are
    (kh, kw, in, out), torch weights (out, in, kh, kw)."""
    tree = params.get('params', params)
    names = sorted(tree, key=lambda k: int(k.split('_')[1]))
    sd = {}
    for k, name in enumerate(names):
        dst = 'out' if k == len(names) - 1 else f'convs.{k}'
        kern = np.asarray(tree[name]['kernel'], np.float32)
        sd[f'{dst}.weight'] = torch.from_numpy(
            np.ascontiguousarray(kern.transpose(3, 2, 0, 1)))
        sd[f'{dst}.bias'] = torch.from_numpy(
            np.asarray(tree[name]['bias'], np.float32).copy())
    return sd


def model_inputs(raw: torch.Tensor, flip: torch.Tensor) -> torch.Tensor:
    """(..., H, W) raw composite + (..., H) +-1 line flags -> (..., H, W,
    3)."""
    ci, cq = _carriers(raw.shape[-2], raw.shape[-1], flip)
    comp = raw.to(torch.float32) / 32768.0 - 1.0
    return torch.stack([comp, ci, cq], dim=-1)


# ---------------------------------------------------------------------------
# synthetic training data: dense ground-truth (Y, I, Q) -> composite

# the smoothing cutoffs of the five random fields, in the order
# synth_fields draws them: luma, luma edges, I, Q, chroma steps
FIELD_CUTOFFS = (13, 7, 17, 17, 29)


def box_blur(x: torch.Tensor, cutoff_px: float) -> torch.Tensor:
    """Band-limit a noise field: two box blurs of width k along each of
    the last two axes (cumsum differences), times k**0.9 to keep the
    variance roughly scale-free."""
    k = max(int(cutoff_px), 1)

    def box(a, axis):
        n = a.shape[axis]
        pad = [0, 0] * (a.ndim - 1 - axis) + [k, 0]
        c = torch.cumsum(F.pad(a, pad), dim=axis)
        return (c.narrow(axis, k, n) - c.narrow(axis, 0, n)) / k

    for axis in (x.ndim - 2, x.ndim - 1):
        x = box(box(x, axis), axis)
    return x * (k ** 0.9)


def _smooth_field(generator: torch.Generator, shape, cutoff_px: float
                  ) -> torch.Tensor:
    """Random band-limited field on the generator's device."""
    x = torch.randn(shape, generator=generator, device=generator.device)
    return box_blur(x, cutoff_px)


def synth_fields(generator: torch.Generator, batch: int, h: int, w: int):
    """The random draws of synth_batch: the five smoothed fields of
    FIELD_CUTOFFS, each (batch, h, w), and the (batch, h) +-1 line
    flips."""
    fields = [_smooth_field(generator, (batch, h, w), c)
              for c in FIELD_CUTOFFS]
    bits = torch.rand((batch, h), generator=generator,
                      device=generator.device) < 0.5
    return fields, torch.where(bits, 1.0, -1.0)


def compose(fields, flip: torch.Tensor):
    """Smooth fields + line flips -> (inputs (B,h,w,3), clp_target,
    y_true, i_true, q_true) in raw u16 units: random smooth YIQ scenes
    with hard edges, composed per the comb's demodulation convention."""
    f_y, f_edge, f_i, f_q, f_step = fields
    # u16-IRE convention of the .tbc comb input: 0 IRE sits 40 IRE above
    # IREBASE (to_rgb: ire = -40 + (u16 - IREBASE)/IRESCALE), so luma in
    # 45..100 here spans video levels ~5..60 IRE
    Y = 45 + 40 * torch.sigmoid(f_y * 3)
    # sharp luma detail (where 1D combs leak into chroma): quantized blob
    # fields give flat regions separated by hard edges
    Y = Y + 14 * torch.remainder(torch.floor(f_edge * 2.5), 2)
    I = 28 * f_i
    Q = 28 * f_q
    # hard chroma edges (color bars look): quantize a ramp
    step = torch.floor(f_step * 4) * 9
    I = I + step
    Q = Q - step
    # flipped-basis carriers; fl_D = fl * (I*ci - Q*cq): composite chroma
    # C = -fl_D and chroma-plane target clp = 2*fl_D = -2C, consistent with
    # split1d's stencil, split_iq's cavg flip and adjust_y's re-modulation
    # (tests/test_torch_nn_comb.py::test_convention_against_stencil)
    ci, cq = _carriers(Y.shape[-2], Y.shape[-1], flip)
    fl_D = I * ci - Q * cq
    raw = (Y - fl_D) * IRESCALE + IREBASE
    clp = 2.0 * fl_D * IRESCALE
    inp = torch.stack([raw / 32768.0 - 1.0, ci, cq], dim=-1)
    return inp, clp, Y * IRESCALE + IREBASE, I * IRESCALE, Q * IRESCALE


def synth_batch(generator: torch.Generator, batch: int, h: int, w: int):
    """Random smooth YIQ scenes + hard edges on the generator's device:
    (inputs (B,h,w,3), clp_target, y_true, i_true, q_true)."""
    return compose(*synth_fields(generator, batch, h, w))


# ---------------------------------------------------------------------------
# real-capture training data (the reference comb-ntsc -t training mode,
# comb-ntsc.cxx:1057-1061: force dim 3 + write per-frame images).  The 3D
# comb's own chroma separation of a real .tbc capture becomes the
# supervision target: the chroma plane clp = 2*(I*ci - Q*cq) (carriers with
# the per-line flip folded in) rebuilt from the comb's (i, q) planes.

def _training_pair(raw_u16, prev_u16, next_u16, cfg: CN.CombConfig):
    """Frames (..., IN_Y, IN_X) with their temporal neighbours -> (model
    inputs (..., IN_Y, IN_X, 3), clp targets (..., IN_Y, IN_X))."""
    dev = raw_u16.device
    raw = raw_u16.to(torch.float32)
    invert_col = CN._invert_col(raw_u16, cfg)
    flip = torch.where(invert_col, 1.0, -1.0)

    clp0 = CN.split1d(raw)
    clp2, combk2 = CN.split3d(raw, prev_u16.to(torch.float32),
                              next_u16.to(torch.float32), cfg)
    clp1, combk1, combk0 = CN.split2d(clp0, combk2, cfg.adaptive2d)
    mask36 = CN._row_mask(36, CN.IN_Y, dev) & CN._col_mask(4, 840, dev)
    k1row = CN._row_mask(2, 524, dev)
    combk1 = torch.where(mask36 & k1row, 1.0 - combk2, combk1)
    combk0 = torch.where(mask36, 1.0 - combk2 - combk1, combk0)
    y, i, q = CN.split_iq(raw, (clp2, clp1, clp0),
                          (combk2, combk1, combk0), invert_col, cfg)
    ci, cq = _carriers(raw.shape[-2], raw.shape[-1], flip)
    clp_t = 2.0 * (i * ci - q * cq)
    return model_inputs(raw_u16, flip), clp_t


def training_pairs_from_frames(frames_u16, cfg: CN.CombConfig = None,
                               device=DEFAULT_DEVICE,
                               graphs: Union[bool, GraphCache] = True
                               ) -> Tuple[np.ndarray, np.ndarray]:
    """(N, 525, 910) u16 .tbc frames -> (inputs (N-2, H, W, 3), clp
    targets (N-2, H, W)) float32 numpy, supervised by the no-flow 3D comb
    (interior frames only: the 3D stencil needs both temporal neighbours).

    A tensor of frames is processed on its device, numpy frames on
    `device`; PAIR_WINDOW frames are on the device at a time.  graphs=True
    replays each window (JAX's jitted `_training_pairs_win`) as one CUDA
    graph a window length on the card (eager on the CPU); False runs it
    eagerly; a GraphCache is used as given."""
    if cfg is None:
        cfg = CN.CombConfig(dim=3, opticalflow=False)
    if isinstance(frames_u16, torch.Tensor):
        dev = frames_u16.device
        frames = frames_u16.reshape(-1, CN.IN_Y, CN.IN_X)
    else:
        dev = resolve_device(device)
        frames = np.asarray(frames_u16).reshape(-1, CN.IN_Y, CN.IN_X)
    n = frames.shape[0]
    if n < 3:
        raise ValueError('need >= 3 frames for 3D-comb supervision')
    cache = as_cache(graphs, dev)
    inputs = np.empty((n - 2, CN.IN_Y, CN.IN_X, 3), np.float32)
    targets = np.empty((n - 2, CN.IN_Y, CN.IN_X), np.float32)
    for e0 in range(1, n - 1, PAIR_WINDOW):
        e1 = min(e0 + PAIR_WINDOW, n - 1)
        win = frames[e0 - 1:e1 + 1]
        if not isinstance(win, torch.Tensor):
            win = torch.from_numpy(win.astype(np.int32))
        win = win.to(dev, torch.int32)
        # replayed, the pairs are the graph's static outputs: copied out
        # before the next window's replay
        inp, clp = cache(('training_pair', cfg),
                         lambda w: _training_pair(w[1:-1], w[:-2], w[2:],
                                                  cfg), (win,))
        inputs[e0 - 1:e1 - 1] = inp.cpu().numpy()
        targets[e0 - 1:e1 - 1] = clp.cpu().numpy()
    return inputs, targets


def write_training_file(frames_u16, path: str, cfg: CN.CombConfig = None,
                        device=DEFAULT_DEVICE,
                        graphs: Union[bool, GraphCache] = True) -> int:
    """Write a .npz of (inputs, clp) float32 training pairs from real .tbc
    frames (the JAX package's format: either package's trainer reads the
    other's files); returns the number of pairs written.  graphs as in
    training_pairs_from_frames."""
    inputs, clp = training_pairs_from_frames(frames_u16, cfg, device,
                                             graphs)
    np.savez_compressed(path, inputs=inputs, clp=clp)
    return inputs.shape[0]


def _file_batch(generator: torch.Generator, data, batch: int, h: int,
                w: int):
    """Random (h, w) crops from a loaded training file (tensors on the
    generator's device), gathered without a host round trip."""
    inputs, clp = data
    n, H, W = clp.shape
    dev = generator.device

    def draw(hi):
        return torch.randint(0, hi, (batch,), generator=generator,
                             device=dev)

    fi, yi, xi = draw(n), draw(H - h), draw(W - w)
    f = fi[:, None, None]
    y = yi[:, None, None] + torch.arange(h, device=dev)[None, :, None]
    x = xi[:, None, None] + torch.arange(w, device=dev)[None, None, :]
    return inputs[f, y, x], clp[f, y, x]


# ---------------------------------------------------------------------------
# training

def train_step(model: NNComb, opt: torch.optim.Optimizer,
               inp: torch.Tensor, clp_t: torch.Tensor,
               mesh=None) -> torch.Tensor:
    """One step on a batch: loss mean((pred - clp)^2) / IRESCALE^2 (IRE^2),
    its gradient, and the optimiser's update.  Returns the loss (a 0-d
    tensor, before the update).

    With `mesh` (parallel/mesh.py) every rank passes the whole batch and
    trains on its 'dp' rows; the gradients and the loss are averaged over
    'dp' (equal slices, so the mean is the whole batch's), and every rank
    takes the same Adam step."""
    if mesh is not None:
        lb = inp.shape[0] // mesh.dp
        if lb * mesh.dp != inp.shape[0]:
            raise ValueError(f'batch {inp.shape[0]} does not split over '
                             f'dp={mesh.dp}')
        rows = slice(mesh.dp_index * lb, (mesh.dp_index + 1) * lb)
        inp, clp_t = inp[rows], clp_t[rows]
    opt.zero_grad(set_to_none=True)
    loss = torch.mean((model(inp) - clp_t) ** 2) / (IRESCALE ** 2)
    loss.backward()
    if mesh is not None:
        grads = [p.grad for p in model.parameters()]
        flat = mesh.all_reduce_mean(torch.cat([g.reshape(-1) for g in grads]),
                                    mesh.dp_group)
        for g, v in zip(grads, flat.split([g.numel() for g in grads])):
            g.copy_(v.view_as(g))
        loss = mesh.all_reduce_mean(loss.detach(), mesh.dp_group)
    opt.step()
    return loss.detach()


def make_optimizer(model: NNComb, lr: float) -> torch.optim.Optimizer:
    """optax.adam(lr)'s update: beta 0.9/0.999, eps 1e-8 added outside the
    square root, bias correction on both moments.  On a CUDA device it is
    the capturable Adam (its step count and bias corrections on the
    device, no host read), which a CUDA graph can capture, for eager and
    graphed training alike, so that the two compare bit for bit; on the
    CPU (where capturable Adam does not run) the plain one."""
    on_card = next(model.parameters()).device.type == 'cuda'
    return torch.optim.Adam(model.parameters(), lr=lr, betas=(0.9, 0.999),
                            eps=1e-8, capturable=on_card)


class Trainer:
    """The training loop's step, JAX's jitted `jstep`: a batch drawn from
    `generator` (synthetic scenes, or crops of `data`, a pair of tensors
    on the model's device), the forward and backward pass and Adam's
    update (`train_step`, over `mesh` when given).

    `graphs` (utils/graphs.py): on the card each step after the first
    replays draw, forward, backward and update as one CUDA graph, keyed by
    (batch, h, w, features, data shape), with the parameters, Adam's
    state and the data read in place and the generator registered, so a
    graphed run draws and trains as an eager one.  Adam creates its state
    at its first step, so the first step runs eagerly outside the cache;
    the cache then warms up once and captures once for the whole run.
    True picks the device's default (graphs on the card), False runs
    every step eagerly, a GraphCache is used as given; `train_nn_comb`
    routes a host-staged mesh to an eager cache."""

    def __init__(self, model: NNComb, opt: torch.optim.Optimizer,
                 generator: torch.Generator, batch: int, h: int, w: int,
                 data: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                 mesh=None, graphs: Union[bool, GraphCache] = True):
        self.model, self.opt, self.generator = model, opt, generator
        self.batch, self.h, self.w = batch, h, w
        self.data, self.mesh = data, mesh
        self.graphs = as_cache(graphs, next(model.parameters()).device)
        self.key = ('nn_train_step', batch, h, w, model.features,
                    None if data is None else tuple(data[0].shape))

    def _step(self) -> torch.Tensor:
        if self.data is not None:
            inp, clp_t = _file_batch(self.generator, self.data, self.batch,
                                     self.h, self.w)
        else:
            inp, clp_t, *_ = synth_batch(self.generator, self.batch,
                                         self.h, self.w)
        return train_step(self.model, self.opt, inp, clp_t, self.mesh)

    def step(self) -> torch.Tensor:
        """One step; returns its loss (0-d, before the update).  Replayed,
        the loss is the graph's static output, which the next step
        overwrites."""
        if not self.opt.state:
            return self._step()
        reads = list(self.model.parameters()) + [
            t for st in self.opt.state.values() for t in st.values()
            if isinstance(t, torch.Tensor)] + list(self.data or ())
        return self.graphs(self.key, self._step, (), reads=reads,
                           generators=(self.generator,))


def train_nn_comb(generator: torch.Generator = None, steps: int = 250,
                  batch: int = 8, h: int = 64, w: int = 256,
                  lr: float = 3e-3, features: Tuple[int, ...] = (24, 24),
                  data=None, device=DEFAULT_DEVICE, mesh=None,
                  graphs: Union[bool, GraphCache, None] = None):
    """Train the chroma separator on `device`; returns (model,
    final_loss).

    By default trains self-supervised on synthetic scenes; pass
    `data=(inputs, clp)` (float32 arrays, e.g. from a write_training_file
    .npz) to train on real-capture pairs instead, the reference's -t
    training path (comb-ntsc.cxx:1057-1061).  `generator` (default: seed 0
    on `device`) draws the weights and every batch.  With `mesh`
    (parallel/mesh.py) the train step runs data-parallel over its 'dp'
    axis on the mesh's device: every rank draws the same weights and
    batches from its identically seeded generator, and the returned loss
    is the mean over 'dp'.

    graphs: as `Trainer`'s, by default one CUDA graph for the steps on the
    card.  None (the default) is True, except on a host-staged gloo mesh
    (parallel/mesh.py), whose all_reduce copies through host memory: it
    trains eagerly, and True there raises (utils/graphs.py::as_cache)."""
    dev = mesh.device if mesh is not None else resolve_device(device)
    graphs = as_cache(graphs, dev, mesh is not None and mesh.staged)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    model = NNComb(features).to(dev)
    model.reset_parameters(generator)
    opt = make_optimizer(model, lr)
    if data is not None:
        data = tuple(torch.as_tensor(np.asarray(a, np.float32)).to(dev)
                     for a in data)
    trainer = Trainer(model, opt, generator, batch, h, w, data, mesh, graphs)
    loss = None
    for _ in range(steps):
        loss = trainer.step()
    return model, float(loss)


# ---------------------------------------------------------------------------
# inference: full comb with the NN chroma plane

@torch.no_grad()
def comb_frame_nn(raw_u16: torch.Tensor, model: NNComb, aburstlev: float,
                  cfg: CN.CombConfig, graphs: Optional[GraphCache] = None):
    """Frame (IN_Y, IN_X) -> (RGB48 (linesout, 910, 3) int32 holding u16
    values, the new AGC carry) with the NN chroma estimate in place of the
    2D stencil (the reference's `-N` path, attic/combg2-4nn.cxx:1136-1141);
    everything downstream is the standard comb tail.  Runs on the frame's
    device (the model must be there).

    The AGC levels come first, on the host (`burst_levels`: a read-back);
    the forward pass and the comb tail then run as one call of `graphs`
    (JAX's jitted `comb_frame_nn`), keyed by the configuration and the
    model's features, the levels a dynamic input and the weights read in
    place.  A caller that combs many frames passes one GraphCache;
    replayed, the RGB is the graph's static output, which the next frame's
    replay overwrites."""
    levels, ab = CN.burst_levels(raw_u16[None], aburstlev, cfg)

    def core(raw_u16, levels):
        return _comb_nn_core(raw_u16, levels, model, cfg)

    if graphs is None:
        return core(raw_u16, levels[0]), ab
    return graphs(('comb_frame_nn', cfg, model.features), core,
                  (raw_u16, levels[0]),
                  reads=tuple(model.parameters())), ab


def _comb_nn_core(raw_u16: torch.Tensor, levels: torch.Tensor,
                  model: NNComb, cfg: CN.CombConfig) -> torch.Tensor:
    """comb_frame_nn after the AGC: the NN chroma plane, then the comb
    tail to RGB48 with the frame's AGC `levels`."""
    dev = raw_u16.device
    raw = raw_u16.to(torch.float32)
    invert_col = CN._invert_col(raw_u16, cfg)
    flip = torch.where(invert_col, 1.0, -1.0)

    clp = model(model_inputs(raw, flip)[None])[0]
    inner = CN._row_mask(4, 524, dev) & CN._col_mask(18, 840, dev)
    clp = torch.where(inner, clp, 0.0)

    z = torch.zeros_like(raw)
    ones = torch.where(inner, 1.0, 0.0)
    y, i, q = CN.split_iq(raw, (z, clp, z), (z, ones, z), invert_col, cfg)
    y, i, q = CN.adjust_y(y, i, q, invert_col, cfg)
    if cfg.colorlpf:
        i, q = CN.filter_iq(i, q, cfg)
    y = CN.do_ynr(y, cfg)
    i, q = CN.do_cnr(i, q, cfg)
    return CN.to_rgb(y, i, q, levels, cfg)
