"""The batched streaming NTSC and PAL combs (torch port of
ld_decode_tpu/comb/batch.py: NTSCCombBatch, PALCombBatch).

A window of M frames is combed per `feed`.  In the default dim-3 mode with
optical flow, emission e combs frame e against its successor e+1, gated by
the Farnebäck flow between the two frames' field luma; the flow of
emission e seeds emission e+1, and the flow and the burst-AGC carry cross
windows.  The flows are a Python loop over the window's emissions (each
farneback call runs both fields at once); the luma, the field images and
the comb itself run batched over the whole window.

Emission protocol (pinned against JAX by tests/test_torch_comb.py):
dim 3 + optical flow never emits frame 0 and emits frame e when frame e+1
arrives (one frame pending); dim 3 without flow emits e from the (e-1, e,
e+1) ring (two pending); dims 1/2 emit every frame at once.

PALCombBatch carries no state across frames (no AGC, no flow), so a whole
window combs in one batched pass.  Its emission follows the streaming
PALComb (pinned by tests/test_torch_comb_pal.py): dims 1/2 emit every
frame; dim 3 emits frame 0 as 2D at once, then frame e from the (e-1, e,
e+1) ring, keeps the last two pending, and `flush()` returns the final
frame as 2D.

Each window's device program is replayed as one CUDA graph per mode and
window length on the card (utils/graphs.py), as the JAX package jits its
window functions: NTSC's flow window (`_comb_window_flow`: the flow luma,
the Farnebäck chain, the comb), ring window (dim 3 without flow) and
simple window (dims 1/2), each after the burst AGC's host loop, whose
levels are a dynamic input and whose carry stays on the host; PAL's
simple and 3D windows, frame 0's 2D head and the 2D flush frame.

The RGB48 output stays an int32 tensor until `collect`, which copies it to
the host as np.uint16 (np.uint8 with out8).  With codec=True the window's
RGB crosses instead as the lossless codec's payload (JAX's `_rgb_encode`
and `_RgbCodecMixin`: planar, k=1, the horizontal pass on RGB48 and not
on out8), the used prefixes copied and decoded on the host; a frame whose
payload fails the consistency gate comes out black, counted in
stats['rgb_decode_fallback'] with a warning.  JAX's default is codec=True
(its tunnel); the port's is False: the raw copy is the cheaper one on the
card (chip_smoke.py phase 23 times the encode a window on an NVIDIA H100;
PERF.md).  The encode (JAX's jitted `_rgb_encode`) replays as one CUDA
graph a window shape and output depth through the comb's cache, as does
the raw path's cut to 8 bits (`_to_rgb8`).
`CombWindows` is the chain's loop over windows, shared by
ldchain_torch.py, bench_torch.py, chip_smoke.py and
scripts/profile_torch.py.

Spans (utils/spans.py), on the chain's thread: `comb.feed` is each feed of
`CombWindows`, holding NTSC's `comb.levels` (the AGC's round trip to the
host) and `comb.replay` (the window's graph replay and the start of its
copies to the host); `comb.collect` is each window's wait for its copies
and their conversion on the host.  `stats` counts `frames_fed`,
`frames_emitted` and the seconds of `t_feed` and `t_collect`.
"""

from __future__ import annotations

import concurrent.futures
import os
import time
from collections import deque
from typing import Callable, Deque, List, Optional, Tuple, Union

import numpy as np
import torch

from ld_decode_tpu_torch.comb.comb_ntsc import (
    _CXSIZE, _CYSIZE, IN_X, IN_Y, CombConfig, _frame_core, burst_levels,
    field_pics, flow_confidence, flow_luma)
from ld_decode_tpu_torch.comb.comb_pal import (PAL_X, PAL_Y, CombPALConfig,
                                               comb_core, prepare_frames)
from ld_decode_tpu_torch.comb.optflow import farneback
from ld_decode_tpu_torch.tbc import codec as CODEC
from ld_decode_tpu_torch.utils import log
from ld_decode_tpu_torch.utils.device import DEFAULT as DEFAULT_DEVICE
from ld_decode_tpu_torch.utils.device import resolve as resolve_device
from ld_decode_tpu_torch.utils.device import to_host_async
from ld_decode_tpu_torch.utils.graphs import GraphCache, as_cache
from ld_decode_tpu_torch.utils.spans import span

# the pyramid cap keeps both dims of the 252x840 field images >= 32 px,
# which at pyr_scale 0.5 caps the requested 4 levels to 2
_FB_LEVELS = 2


def _crop(rgb: torch.Tensor, cfg: CombConfig) -> torch.Tensor:
    return rgb if cfg.wide else rgb[..., 78:78 + 744, :]


def _comb_window_flow(win: torch.Tensor, flow0: torch.Tensor,
                      levels: torch.Tensor, cfg: CombConfig):
    """win: (M, Y, X).  Emits frames win[0..M-2], each against its
    successor, chaining the per-field flow; `levels` are the AGC levels of
    win[:-1] (`burst_levels`, whose host loop synchronises, runs before).
    The JAX package's `_comb_window_of` less the AGC: the flow luma, the
    field images, the Farnebäck chain and its confidence maps, the comb.
    It reads nothing from the host, so NTSCCombBatch replays it as one CUDA
    graph per window length.  Returns (rgb, words, flow)."""
    lum = flow_luma(win, cfg)
    pics = field_pics(lum)                         # (M, 2, 252, 840)
    cur, nxt = win[:-1], win[1:]
    flow = flow0
    combk2 = []
    for e in range(win.shape[0] - 1):
        # streaming arg order: prev_img = the NEWER field image
        flow = farneback(pics[e + 1], pics[e], flow, 0.5, _FB_LEVELS, 60, 3,
                         7, 1.5, True)
        combk2.append(flow_confidence(flow, cfg.of_3dcore, cfg.of_3drange))
    rgb, _ = _frame_core(cur, nxt, nxt, levels, cfg,
                         combk2_in=torch.stack(combk2))
    return _crop(rgb, cfg), cur[:, 0, :16], flow


def _comb_window_ring(win: torch.Tensor, levels: torch.Tensor,
                      cfg: CombConfig):
    """No-opticalflow dim 3: emit win[1..M-2] from (e-1, e, e+1) rings;
    `levels` are the AGC levels of win[1:-1] (`burst_levels`, before).
    Returns (rgb, words)."""
    prv, cur, nxt = win[:-2], win[1:-1], win[2:]
    rgb, _ = _frame_core(cur, prv, nxt, levels, cfg)
    return _crop(rgb, cfg), cur[:, 0, :16]


def _comb_window_simple(win: torch.Tensor, levels: torch.Tensor,
                        cfg: CombConfig):
    """dims 1/2: every frame emits; only the AGC chains (`levels`, of
    win).  Returns (rgb, words)."""
    rgb, _ = _frame_core(win, win, win, levels, cfg)
    return _crop(rgb, cfg), win[:, 0, :16]


def _to_rgb8(rgb: torch.Tensor) -> torch.Tensor:
    """RGB48 -> the top bytes (comb -8), JAX's jitted `_to_rgb8`."""
    return (rgb >> 8).to(torch.uint8)


def _rgb_encode(rgb: torch.Tensor, out8: bool):
    """A window's (E, rows, W, 3) RGB48 -> the RGB codec's payload (JAX's
    `_rgb_encode`): planar, k=1, the horizontal pass on RGB48; with out8
    the top byte only, without the horizontal pass."""
    if out8:
        rgb = rgb >> 8
    E, rows, W, _ = rgb.shape
    img = CODEC.pad_to_blocks(rgb.movedim(3, 1).reshape(E, 3 * rows, W))
    return CODEC.encode_image_payload(img, 1, hpass=not out8)


def _window_tensor(frames, device, lines: int, width: int) -> torch.Tensor:
    """A feed's frames (a tensor, or a numpy array of 16-bit samples) as
    an (N, lines, width) tensor on `device`."""
    if not isinstance(frames, torch.Tensor):
        frames = torch.from_numpy(np.asarray(frames).astype(np.int32))
    return frames.to(device).reshape(-1, lines, width)


class _RgbCodecMixin:
    """The windows' copies to the host, raw or through the RGB codec.  A
    handle is (kind, host copies, event, payload)."""

    def _init_copies(self, out8: bool, codec: bool):
        self.out8 = out8        # comb -8: top byte only
        self.codec = codec
        self._prefixes = CODEC.PrefixCopies()
        self._decode_ex = None
        self.stats = {'t_feed': 0.0, 'windows': 0, 'frames_fed': 0,
                      'frames_emitted': 0, 't_collect': 0.0}
        if codec:
            self.stats.update(rgb_decode_fallback=0, rgb_decode_native=0,
                              rgb_decode_numpy=0, rgb_topups=0,
                              shipped_u16=0, frames_out=0)

    def _send(self, rgb: torch.Tensor, extra: dict):
        """Start the copies of a window's (E, rows, W, 3) RGB and `extra`
        tensors; on the card they run asynchronously after the comb."""
        self.stats['windows'] += 1
        if not self.codec:
            if self.out8:
                rgb = self.graphs(('rgb8',), _to_rgb8, (rgb,))
            return ('raw',) + to_host_async({'rgb': rgb, **extra}) + (None,)
        E, rows, W, _ = rgb.shape
        out8 = self.out8
        pay = self.graphs(('rgb_encode', out8),
                          lambda x: _rgb_encode(x, out8), (rgb,))
        if self.graphs.aliased:
            # replayed, the payload is the graph's static tensors: the
            # copies below are queued next on the stream, but a top-up at
            # collect reads the dense buffers after later windows' replays
            pay = dict(pay, dense=pay['dense'].clone(),
                       dense_q=pay['dense_q'].clone())
        copies = {'tab': pay['tab'], 'rows2': pay['rows2'], **extra}
        self._prefixes.start(copies, pay['dense'], pay['dense_q'])
        return ('codec',) + to_host_async(copies) + (
            (pay['dense'], pay['dense_q'], E, rows, W),)

    def _receive(self, handle):
        """Wait for a window's copies: (RGB frames as np.uint16, or np.uint8
        with out8, the other host arrays).  The `comb.collect` span, timed
        in stats['t_collect']; the frames count in stats['frames_emitted']."""
        with span('comb.collect') as sp:
            kind, host, event, payload = handle
            if event is not None:
                event.synchronize()
            data = {k: v.numpy() for k, v in host.items()}
            if kind == 'raw':
                rgb = data.pop('rgb')
                rgb = list(rgb if self.out8 else rgb.astype(np.uint16))
            else:
                rgb = self._decode_window(data, *payload)
        self.stats['t_collect'] += sp.seconds
        self.stats['frames_emitted'] += len(rgb)
        return rgb, data

    def _decode_window(self, data, dense, dense_q, E, rows, W):
        rows2 = data['rows2'].astype(np.int64)
        before = self._prefixes.topups
        dv, qv = self._prefixes.finish(data, dense, dense_q, rows2)
        self.stats['rgb_topups'] += self._prefixes.topups - before
        self.stats['shipped_u16'] += int(rows2.sum()) + data['tab'].size
        self.stats['frames_out'] += E
        shape = (3 * rows, -(-W // CODEC.CODEC_BW) * CODEC.CODEC_BW)
        if self._decode_ex is None:
            self._decode_ex = concurrent.futures.ThreadPoolExecutor(
                max_workers=min(8, os.cpu_count() or 1))
        frames = []
        for img, route in CODEC.decode_batch(
                data['tab'].view(np.uint16), dv, qv, rows2, shape, 1,
                not self.out8, self._decode_ex):
            if route is not None:
                self.stats[f'rgb_decode_{route}'] += 1
            if img is None:
                self._note_decode_fallback()
                img = np.zeros(shape, np.uint16)
            rgb = np.ascontiguousarray(
                np.moveaxis(img[:, :W].reshape(3, rows, W), 0, 2))
            frames.append(rgb.astype(np.uint8) if self.out8 else rgb)
        return frames

    def _note_decode_fallback(self):
        """A frame that failed the gate goes out black: counted, and said
        once, since a silently black frame must be visible to callers."""
        self.stats['rgb_decode_fallback'] += 1
        if self.stats['rgb_decode_fallback'] == 1:
            log.warning('RGB codec consistency gate failed; emitting a '
                        'black frame (see stats["rgb_decode_fallback"])')


class NTSCCombBatch(_RgbCodecMixin):
    """Batched NTSC comb: `feed(frames)` combs a window, `collect(handle)`
    returns (rgb_list, words_list).  The debug surfaces (-D/-k/-l) stay on
    the streaming NTSCComb."""

    def __init__(self, cfg: CombConfig = CombConfig(), out8: bool = False,
                 device=DEFAULT_DEVICE, codec: bool = False,
                 graphs: Union[bool, GraphCache] = True):
        """codec=True sends the RGB through the lossless codec (module
        docstring).  graphs=True (the default) replays each window's
        device program (flow, ring or simple) as one CUDA graph per window
        length on the card (utils/graphs.py; eager on the CPU);
        graphs=False runs it eagerly; a GraphCache is used as given."""
        if cfg.has_debug:
            raise ValueError('debug surfaces need the streaming NTSCComb')
        self.cfg = cfg
        self.device = resolve_device(device)
        self.graphs = as_cache(graphs, self.device)
        self._pend: Optional[torch.Tensor] = None   # (k, Y, X) device
        self._flow = torch.zeros((2, _CYSIZE, _CXSIZE, 2),
                                 dtype=torch.float32, device=self.device)
        self.aburstlev = -1.0
        self._started = False
        self._init_copies(out8, codec)

    def feed(self, frames):
        """frames: (N, IN_Y*IN_X) or (N, IN_Y, IN_X) 16-bit samples, a
        tensor (int32 on the device in the chain) or a numpy array.  Combs
        every emittable frame; returns a handle for collect(), or None if
        nothing can emit yet."""
        t0 = time.perf_counter()
        dev = _window_tensor(frames, self.device, IN_Y, IN_X)
        self.stats['frames_fed'] += dev.shape[0]
        try:
            return self._feed(dev)
        finally:
            self.stats['t_feed'] += time.perf_counter() - t0

    def _feed(self, dev: torch.Tensor):
        cfg = self.cfg
        # replayed, the outputs are the graph's static tensors: the RGB
        # and the words are copied out (or encoded) next on the stream, and
        # the flow carry is read only by the next window's copy into its
        # static input, before that window's replay
        if cfg.dim < 3:
            if not dev.shape[0]:
                return None
            levels = self._levels(dev)
            with span('comb.replay'):
                rgb, words = self.graphs(
                    ('comb_window_simple', cfg),
                    lambda w, lv: _comb_window_simple(w, lv, cfg),
                    (dev, levels))
                return self._fetch(rgb, words)

        if not self._started and cfg.opticalflow and dev.shape[0]:
            # stream start: frame 0 is never emitted in flow mode (its
            # ring slot is the unused prv input, comb-ntsc.cxx:860-866)
            dev = dev[1:]
            self._started = True
        if self._pend is not None:
            dev = torch.cat([self._pend, dev]) if dev.shape[0] \
                else self._pend
        keep = 1 if cfg.opticalflow else 2
        if dev.shape[0] <= keep:
            self._pend = dev
            return None
        self._pend = dev[-keep:]
        if cfg.opticalflow:
            levels = self._levels(dev[:-1])
            with span('comb.replay'):
                rgb, words, self._flow = self.graphs(
                    ('comb_window_flow', cfg),
                    lambda w, f, lv: _comb_window_flow(w, f, lv, cfg),
                    (dev, self._flow, levels))
                return self._fetch(rgb, words)
        levels = self._levels(dev[1:-1])
        with span('comb.replay'):
            rgb, words = self.graphs(
                ('comb_window_ring', cfg),
                lambda w, lv: _comb_window_ring(w, lv, cfg), (dev, levels))
            return self._fetch(rgb, words)

    def _levels(self, frames: torch.Tensor) -> torch.Tensor:
        """The AGC levels of the frames a window emits, the carry advanced:
        the `comb.levels` span (`burst_levels`' round trip to the host)."""
        with span('comb.levels'):
            levels, self.aburstlev = burst_levels(frames, self.aburstlev,
                                                  self.cfg)
        return levels

    @property
    def held(self) -> int:
        """Frames fed that no window has emitted: the pending tail, and
        with flow the stream's frame 0, which is never emitted."""
        pend = 0 if self._pend is None else self._pend.shape[0]
        return pend + int(self._started)

    def _fetch(self, rgb: torch.Tensor, words: torch.Tensor):
        """The window's handle: on the card its copies to pinned host
        buffers start at once, and collect waits on the event."""
        return self._send(rgb, {'words': words})

    def collect(self, handle) -> Tuple[List[np.ndarray], List[np.ndarray]]:
        if handle is None:
            return [], []
        rgb, data = self._receive(handle)
        words = data['words'].astype(np.uint16)
        return rgb, list(words)


def _pal_window_simple(win: torch.Tensor, cfg: CombPALConfig):
    """PAL dims 1/2 (and 2D frames of a dim-3 stream): every frame emits."""
    return comb_core(prepare_frames(win, cfg), cfg)[0]


def _pal_window_3d(win: torch.Tensor, cfg: CombPALConfig):
    """PAL dim 3: emit win[1..M-2] from (e-1, e, e+1) rings; each frame
    passes the pilot notch once."""
    f = prepare_frames(win, cfg)
    return comb_core(f[1:-1], cfg, f[:-2], f[2:])[0]


class PALCombBatch(_RgbCodecMixin):
    """Batched PAL comb with NTSCCombBatch's feed/collect protocol;
    `collect` returns (rgb_list, [None] * n): PAL frames carry no pulldown
    words.  codec=True and graphs= as NTSCCombBatch's: each window
    function (`_pal_window_simple`, `_pal_window_3d`) is one CUDA graph
    per window length, frame 0's 2D head and the 2D flush frame the simple
    one's key at one frame."""

    def __init__(self, cfg: CombPALConfig = CombPALConfig(),
                 out8: bool = False, device=DEFAULT_DEVICE,
                 codec: bool = False,
                 graphs: Union[bool, GraphCache] = True):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.graphs = as_cache(graphs, self.device)
        self._pend: Optional[torch.Tensor] = None   # (k, Y, X), k <= 2
        self._first = True
        self._init_copies(out8, codec)

    def feed(self, frames):
        """frames: (N, PAL_Y*PAL_X) or (N, PAL_Y, PAL_X) 16-bit samples, a
        tensor or a numpy array.  Returns a handle for collect(), or None
        if nothing can emit yet."""
        t0 = time.perf_counter()
        dev = _window_tensor(frames, self.device, PAL_Y, PAL_X)
        self.stats['frames_fed'] += dev.shape[0]
        try:
            return self._feed(dev)
        finally:
            self.stats['t_feed'] += time.perf_counter() - t0

    def _window(self, fn, win: torch.Tensor) -> torch.Tensor:
        """fn(win, cfg) through the cache, one key a window function and
        length.  Replayed, the RGB is the graph's static tensor, read next
        on the stream (the copies, the head's cat)."""
        cfg = self.cfg
        return self.graphs((fn.__name__, cfg), lambda w: fn(w, cfg), (win,))

    def _feed(self, dev: torch.Tensor):
        if self.cfg.dim < 3:
            if not dev.shape[0]:
                return None
            return self._fetch(self._window(_pal_window_simple, dev))
        head = None
        if self._first and dev.shape[0]:
            # frame 0: 2D
            head = self._window(_pal_window_simple, dev[:1])
            self._first = False
        if self._pend is not None:
            dev = torch.cat([self._pend, dev]) if dev.shape[0] \
                else self._pend
        if dev.shape[0] < 3:
            self._pend = dev
            return self._fetch(head) if head is not None else None
        self._pend = dev[-2:]
        rgb = self._window(_pal_window_3d, dev)
        if head is not None:
            rgb = torch.cat([head, rgb])
        return self._fetch(rgb)

    @property
    def held(self) -> int:
        """Frames fed that no window has emitted: the pending tail but its
        first frame, which came out as frame 0's 2D head or in the middle
        of the last window (the others come out at `flush` or with the
        next window)."""
        return 0 if self._pend is None else self._pend.shape[0] - 1

    def _fetch(self, rgb: torch.Tensor):
        return self._send(rgb, {})

    def collect(self, handle) -> Tuple[List[np.ndarray], list]:
        if handle is None:
            return [], []
        rgb, _ = self._receive(handle)
        return rgb, [None] * len(rgb)

    def flush(self) -> Optional[np.ndarray]:
        """The final pending frame, 2D (it has no successor), or None."""
        if self.cfg.dim < 3 or self._pend is None \
                or self._pend.shape[0] < 2:
            return None
        return self.collect(self._fetch(
            self._window(_pal_window_simple, self._pend[-1:])))[0][0]


class CombWindows:
    """The chain's comb loop (ldchain_tpu.py:193-239): decoded frames
    collect on the device; every `window` frames one comb window is fed,
    and up to `depth` windows keep their RGB on the device (its copy to
    the host in flight) while later frames decode.  `emit(rgb, words)`
    receives each RGB frame and its line-0 words (None for PAL) on the
    host, in order.  `drain` ends the stream: it also emits the comb's
    flush tail (PAL dim 3: the final frame, with words None)."""

    def __init__(self, comb, window: int, depth: int,
                 emit: Callable[[np.ndarray, Optional[np.ndarray]], None]):
        self.comb, self.window, self.depth, self.emit = (comb, window,
                                                         depth, emit)
        self._buf: list = []
        self._pending: Deque = deque()

    def push(self, frame):
        """frame: (lines, width) 16-bit samples, a device tensor or (the
        host-woven first frame) a numpy array."""
        self._buf.append(frame)
        if len(self._buf) >= self.window:
            self._flush(self.depth)

    def drain(self, flush: bool = True):
        """Comb what is buffered, emit every window still in flight, then
        the comb's flush tail where it has one.  flush=False leaves the
        tail in the comb (its `held` frames), so that later pushes go on
        with the same stream."""
        self._flush(0)
        if not flush:
            return
        comb_flush = getattr(self.comb, 'flush', None)
        tail = comb_flush() if comb_flush is not None else None
        if tail is not None:
            self.emit(tail, None)

    def _flush(self, limit: int):
        if self._buf:
            dev = self.comb.device
            with span('comb.feed'):
                h = self.comb.feed(torch.stack([
                    x.to(dev) if isinstance(x, torch.Tensor)
                    else torch.from_numpy(np.asarray(x).astype(np.int32)
                                          ).to(dev)
                    for x in self._buf]))
            if h is not None:
                self._pending.append(h)
            self._buf.clear()
        while len(self._pending) > limit:
            for rgb, words in zip(*self.comb.collect(
                    self._pending.popleft())):
                self.emit(rgb, words)
