"""The benchmark's capture source: a Domesday Duplicator .lds stream (10-bit
samples, 4 in 5 bytes, 40 MSa/s) as long as a whole disc side, made from a
seed and served as a file object to the port's own .lds loader.

Nothing of it is written to disk but one tile.  The frozen encoder
(`ldbench/source/encode.py`) renders `tile_frames` frames of composite video
once per checkout, a whole number of frames and of colour-subcarrier
(and PAL pilot) cycles, and its pre-emphasised FM frequency track is cached
under `build/ldbench/`.  The stream is that tile repeated: the modulation
runs on the device, on a stream of its own, from the absolute sample
index n = k*T + j (tile k, offset j):

  * the FM phase runs on across the joins: tile k adds k times the tile's
    total phase, so the phase has no step and the decode no resync there.
    Tile 0 starts from the emphasis filter's zero state, as the encoder
    does; every later tile is the periodic steady state, so the stream is
    what the encoder would give for a render of the whole side;
  * the two analog audio FM carriers are the encoder's closed forms of
    absolute time;
  * the RF noise is drawn block by block (2**20 samples), each block from
    a generator seeded with (seed, block), so any byte range reads back
    the same;
  * then the encoder's quantisation to the 10-bit range, the .lds packing
    of 4 samples into 5 bytes, and a copy of the requested bytes alone to
    the host.

The seed also picks the frame of the side at which the decode starts.  The
VBI frame numbers repeat with the tile: frame i of the stream carries
`cav_first_frame + i % tile_frames` (`frame_number`).

The source's device memory is kept apart from the decode's: its tables
(`resident_bytes`) stay for the run, and the work of each read is freed
when the read returns, so `memory_peaks` gives the decode's own peak (the
card's peak less the source's bytes at the time) beside the card's.
"""

from __future__ import annotations

import hashlib
import os
import time
from dataclasses import fields
from typing import Optional, Tuple

import numpy as np
import scipy.signal as sps
import torch

from ldbench.source import encode as E
from ldbench.source.params import DecoderConfig

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
CACHE_DIR = os.path.join(ROOT, 'build', 'ldbench')
TAU = 2 * np.pi
# samples of the emphasis filter's start-up from its zero state that tile 0
# keeps (the filter's pole lies at 0.93: the transient is gone in 500)
HEAD = 4096
# samples the steady state is settled over before a tile
SETTLE = 1 << 16
# samples made on the device at a time
CHUNK = 1 << 23
# samples of one block of noise, drawn by its own generator
NOISE_BLOCK = 1 << 20


def config_for(conf: dict) -> Tuple[DecoderConfig, E.EncodeSpec]:
    """The decoder configuration and the encoder's spec of a benchmark
    configuration (`ldbench/configs/<name>.json`)."""
    cfg = DecoderConfig(system=conf['system'], freq_mhz=conf['freq_mhz'])
    spec = E.EncodeSpec(pattern=conf['pattern'],
                        cav_start_frame=conf['cav_first_frame'],
                        noise_rms=conf['noise_rms'])
    return cfg, spec


def samples_per_frame(cfg: DecoderConfig) -> float:
    return cfg.sys.frame_lines * cfg.sys.line_period * cfg.freq_mhz


def tile_samples(cfg: DecoderConfig, tile_frames: int) -> int:
    """Samples in a tile; raises unless the tile is a whole number of
    samples, of colour-subcarrier cycles and (PAL) of pilot cycles, so
    that it joins itself without a step."""
    exact = tile_frames * samples_per_frame(cfg)
    n = int(round(exact))
    sp = cfg.sys
    secs = n / cfg.freq_hz
    for name, hz in (('samples', None), ('subcarrier', sp.fsc_mhz * 1e6),
                     ('pilot', sp.pilot_mhz * 1e6)):
        cycles = exact if hz is None else secs * hz
        if abs(cycles - round(cycles)) > 1e-6:
            raise ValueError(f'{tile_frames} {sp.system} frames are not a '
                             f'whole number of {name} ({cycles})')
    return n


def _cache_key(cfg: DecoderConfig, spec: E.EncodeSpec,
               tile_frames: int) -> str:
    h = hashlib.sha256()
    here = os.path.dirname(os.path.abspath(__file__))
    for name in ('encode.py', 'params.py', 'stream.py'):
        with open(os.path.join(here, name), 'rb') as f:
            h.update(f.read())
    h.update(repr((cfg, tuple((f.name, getattr(spec, f.name))
                              for f in fields(spec)), tile_frames,
                   HEAD, SETTLE)).encode())
    return h.hexdigest()[:16]


def render_tile(cfg: DecoderConfig, spec: E.EncodeSpec, tile_frames: int
                ) -> Tuple[np.ndarray, np.ndarray]:
    """(hz, head): the tile's periodic pre-emphasised FM frequency track
    (float64, Hz) and the difference that the encoder's zero-state start
    makes over the first HEAD samples of tile 0.  The arithmetic is the
    encoder's `modulate` up to its phase."""
    sp, dp = cfg.sys, cfg.rf
    n = tile_samples(cfg, tile_frames)
    ire = E.render_composite_ire(cfg, tile_frames, spec)[:n]
    x = (sp.ire0 + sp.hz_ire * ire) - sp.ire0
    del ire
    d0, d1 = dp.video_deemp
    tf_b, tf_a = sps.zpk2tf(-d0 * 1e-10, -d1 * 1e-10, d1 / d0)
    emp_b, emp_a = sps.bilinear(tf_b, tf_a, 1.0 / cfg.freq_hz_half)
    zi = np.zeros(max(len(emp_a), len(emp_b)) - 1)
    _, zi = sps.lfilter(emp_b, emp_a, x[-SETTLE:], zi=zi)
    hz, _ = sps.lfilter(emp_b, emp_a, x, zi=zi)
    hz += sp.ire0
    hz0 = sps.lfilter(emp_b, emp_a, x[:HEAD]) + sp.ire0
    return hz, hz0 - hz[:HEAD]


def load_tile(cfg: DecoderConfig, spec: E.EncodeSpec, tile_frames: int,
              cache_dir: str = CACHE_DIR) -> Tuple[np.ndarray, np.ndarray]:
    """`render_tile`, cached under `cache_dir` by a hash of the encoder,
    this module and the spec (written once, atomically)."""
    path = os.path.join(cache_dir, f'tile_{cfg.system.lower()}_'
                        f'{_cache_key(cfg, spec, tile_frames)}.npz')
    if os.path.exists(path):
        with np.load(path) as z:
            return z['hz'], z['head']
    hz, head = render_tile(cfg, spec, tile_frames)
    os.makedirs(cache_dir, exist_ok=True)
    tmp = f'{path}.{os.getpid()}.tmp'
    with open(tmp, 'wb') as f:
        np.savez(f, hz=hz, head=head)
    os.replace(tmp, path)
    return hz, head


def block_seed(seed: int, block: int) -> int:
    """The generator seed of noise block `block` under a seed of any
    size."""
    h = hashlib.sha256(f'{int(seed)}:{int(block)}'.encode()).digest()
    return int.from_bytes(h[:8], 'little') & ((1 << 63) - 1)


def pack_4_40(s: torch.Tensor) -> torch.Tensor:
    """(4g,) 10-bit samples (int32) -> (5g,) uint8, the .lds layout."""
    s = s.reshape(-1, 4)
    s0, s1, s2, s3 = s[:, 0], s[:, 1], s[:, 2], s[:, 3]
    out = torch.stack([s0 >> 2, ((s0 & 3) << 6) | (s1 >> 4),
                       ((s1 & 0xf) << 4) | (s2 >> 6),
                       ((s2 & 0x3f) << 2) | (s3 >> 8), s3 & 0xff], dim=1)
    return out.to(torch.uint8).reshape(-1)


class SideStream:
    """A file object over the seeded .lds stream of one disc side:
    `seek`, `tell`, `read` (a uint8 array, valid until the next read; the
    port's loader unpacks it at once) and `seek(0, SEEK_END)` at the
    side's length.  `seconds` is the time spent making bytes."""

    def __init__(self, conf: dict, seed: int, device,
                 tile_frames: Optional[int] = None,
                 cache_dir: Optional[str] = None):
        self.cfg, self.spec = config_for(conf)
        self.conf = conf
        self.device = torch.device(device)
        self.tile_frames = int(tile_frames or conf['tile_frames'])
        self.T = tile_samples(self.cfg, self.tile_frames)
        spf = self.samples_per_frame = samples_per_frame(self.cfg)
        self.side_frames = int(conf['side_frames'])
        self.total_samples = int(self.side_frames * spf) // 4 * 4
        self.total_bytes = self.total_samples // 4 * 5
        self.seed = int(seed)
        self.noise_rms = float(conf['noise_rms'])
        hz, head = load_tile(self.cfg, self.spec, self.tile_frames,
                             cache_dir or CACHE_DIR)
        step = TAU / self.cfg.freq_hz
        on = self.device
        self._cuda = on.type == 'cuda'
        self.program_peak = 0
        self.device_peak = 0
        held = self._allocated()
        # what the card held before the source is not the source's
        self._close_interval(0)
        phase = torch.cumsum(torch.from_numpy(hz).to(on), 0) * step
        self._phase = phase                      # (T,) float64 on device
        self._head = torch.cumsum(torch.from_numpy(head).to(on), 0) * step
        self._head_total = float(self._head[-1])
        self._turn = float(np.fmod(float(phase[-1]), TAU))
        del hz
        self._stream = (torch.cuda.Stream(on) if on.type == 'cuda'
                        else None)
        self.resident_bytes = self._allocated() - held
        self._open_interval()
        self._staging = None
        self.pos = 0
        self.seconds = 0.0
        self.reads = 0
        # the frame of the side at which a decode starts: far enough from
        # the end for the fastest cell's longest window and its warm-up
        room = int(np.ceil(float(conf['start_room_msamples']) * 1e6 / spf))
        if room >= self.side_frames:
            raise ValueError('start_room_msamples exceeds the side')
        rng = np.random.default_rng(int(seed))
        self.start_frame = int(rng.integers(
            0, self.side_frames - room))

    # ------------------------------------------------------------- memory

    def _allocated(self) -> int:
        return torch.cuda.memory_allocated(self.device) if self._cuda else 0

    def _close_interval(self, source_bytes: int):
        """Fold the card's peak since the last `_open_interval` into the
        peaks, `source_bytes` of it the source's."""
        if self._cuda:
            peak = torch.cuda.max_memory_allocated(self.device)
            self.device_peak = max(self.device_peak, peak)
            self.program_peak = max(self.program_peak, peak - source_bytes)

    def _open_interval(self):
        if self._cuda:
            self.device_peak = max(
                self.device_peak, torch.cuda.max_memory_allocated(self.device))
            torch.cuda.reset_peak_memory_stats(self.device)

    def memory_peaks(self) -> Tuple[int, int]:
        """(the peak bytes allocated on the card less the source's own, the
        peak bytes allocated on the card), from the process's start."""
        self._close_interval(self.resident_bytes)
        return self.program_peak, self.device_peak

    def frame_number(self, frame: int) -> int:
        """The CAV picture number of frame `frame` of the stream."""
        return int(self.conf['cav_first_frame']) + frame % self.tile_frames

    # ---------------------------------------------------------------- file

    def seek(self, pos: int, whence: int = os.SEEK_SET) -> int:
        if whence == os.SEEK_SET:
            self.pos = int(pos)
        elif whence == os.SEEK_CUR:
            self.pos += int(pos)
        elif whence == os.SEEK_END:
            self.pos = self.total_bytes + int(pos)
        else:
            raise ValueError(f'whence {whence}')
        return self.pos

    def tell(self) -> int:
        return self.pos

    def read(self, nbytes: int = -1) -> np.ndarray:
        t0 = time.perf_counter()
        lo = min(max(self.pos, 0), self.total_bytes)
        hi = self.total_bytes if nbytes < 0 else min(lo + int(nbytes),
                                                     self.total_bytes)
        self.pos = hi
        if hi <= lo:
            return np.zeros(0, np.uint8)
        g0, g1 = lo // 5, -(-hi // 5)
        # the decode holds still while the source reads: its peak so far
        # is taken before the source's work, which the next interval drops
        self._close_interval(self.resident_bytes)
        buf = self._bytes(4 * g0, 4 * (g1 - g0))
        self._open_interval()
        self.seconds += time.perf_counter() - t0
        self.reads += 1
        return buf[lo - 5 * g0:hi - 5 * g0]

    # -------------------------------------------------------------- signal

    def _staging_for(self, nbytes: int) -> torch.Tensor:
        if self._staging is None or self._staging.numel() < nbytes:
            self._staging = None
            self._staging = torch.empty(
                nbytes, dtype=torch.uint8,
                pin_memory=self.device.type == 'cuda')
        return self._staging[:nbytes]

    def _bytes(self, s0: int, count: int) -> np.ndarray:
        """Packed bytes of samples [s0, s0 + count) (both multiples of 4),
        made on the device in chunks and copied to a host buffer."""
        out = self._staging_for(count // 4 * 5)
        ctx = (torch.cuda.stream(self._stream) if self._stream is not None
               else _nullcontext())
        with ctx, torch.profiler.record_function('ldbench.source'):
            c0 = 0
            while c0 < count:
                # chunks end on multiples of CHUNK, so noise blocks are
                # made whole once
                c1 = min(((s0 + c0) // CHUNK + 1) * CHUNK - s0, count)
                q = self.quantised(s0 + c0, c1 - c0)
                out[c0 // 4 * 5:c1 // 4 * 5].copy_(
                    pack_4_40(q), non_blocking=self._stream is not None)
                c0 = c1
        if self._stream is not None:
            self._stream.synchronize()
        return out.numpy()

    def quantised(self, s0: int, count: int) -> torch.Tensor:
        """The 10-bit samples [s0, s0 + count) as int32 on the device."""
        rf = self.rf(s0, count)
        return torch.clamp(torch.round(rf * 350.0 + 512.0), 0,
                           1023).to(torch.int32)

    def phase(self, s0: int, count: int) -> torch.Tensor:
        """The FM phase (float64, radians) at samples [s0, s0 + count):
        tile k's phase is k times the tile's total (taken mod 2 pi) plus
        its own, tile 0 starting from the emphasis filter's zero state."""
        parts = []
        n, end = s0, s0 + count
        while n < end:
            k, j0 = divmod(n, self.T)
            j1 = min(self.T, j0 + end - n)
            ph = self._phase[j0:j1]
            if k == 0:
                corr = torch.full_like(ph, self._head_total)
                h = min(j1, self._head.numel())
                if j0 < h:
                    corr[:h - j0] = self._head[j0:h]
                ph = ph + corr
            else:
                ph = ph + (float(np.fmod(k * self._turn, TAU))
                           + self._head_total)
            parts.append(ph)
            n += j1 - j0
        return parts[0] if len(parts) == 1 else torch.cat(parts)

    def noise(self, s0: int, count: int) -> torch.Tensor:
        """Standard normal deviates at samples [s0, s0 + count)."""
        b0, b1 = s0 // NOISE_BLOCK, -(-(s0 + count) // NOISE_BLOCK)
        gen = torch.Generator(self.device)
        parts = []
        for b in range(b0, b1):
            gen.manual_seed(block_seed(self.seed, b))
            parts.append(torch.randn(NOISE_BLOCK, generator=gen,
                                     dtype=torch.float64,
                                     device=self.device))
        z = parts[0] if len(parts) == 1 else torch.cat(parts)
        lo = s0 - b0 * NOISE_BLOCK
        return z[lo:lo + count]

    def rf(self, s0: int, count: int) -> torch.Tensor:
        """The RF before quantisation (float64, units of the video
        carrier's amplitude), the encoder's `modulate` at absolute time."""
        rf = torch.cos(self.phase(s0, count))
        sp, spec = self.cfg.sys, self.spec
        if spec.audio and sp.analog_audio:
            t = torch.arange(s0, s0 + count, dtype=torch.float64,
                             device=self.device) / self.cfg.freq_hz
            fl, fr = spec.audio_tones
            for carrier, tone in ((sp.audio_lfreq, fl),
                                  (sp.audio_rfreq, fr)):
                beta = spec.audio_dev / tone
                rf = rf + spec.audio_level * torch.cos(
                    TAU * carrier * t + beta * torch.sin(TAU * tone * t))
        if self.noise_rms > 0:
            rf = rf + self.noise_rms * self.noise(s0, count)
        return rf


class _nullcontext:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False
