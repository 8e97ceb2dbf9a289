"""Speculative field-batch prefetcher (torch port of
ld_decode_tpu/tbc/pipeline.py: the raw and codec picture modes, and the
chain mode in which the picture stays on the device).

Each batch of `batch` predicted field windows is decoded by one call of
`fused.field_pipeline_batch`.  The call takes its (start0, audio_offset0)
chain state as device scalars and returns the next chain state as device
scalars, so consecutive speculative batches are queued back to back with
no host synchronization: the prefetcher keeps DEPTH batches in flight.  On
the card every batch's outputs are copied into pinned host buffers
asynchronously as soon as it is queued; the host waits on the batch's
event only when it consumes the batch.  Fields self-lock onto their own
sync peaks, so start-prediction error only shifts the analysis window; a
mispredicted or invalid window falls back to the sequential path.

As in the JAX package, the audio chase resampler's carry offset advances
every field in batched mode (deterministic float32 arithmetic):
    count = ceil((frametime + gap - offset)/gap)
    offset' = offset + (count-1)*gap - frametime.

pic_mode says how a picture reaches the host: 'raw' copies the picture,
'codec' the lossless codec's payloads (tbc/codec.py): the block tables and
counts with the batch's other outputs, and the used prefixes of the dense
buffers, EMA-sized at dispatch and topped up on an underestimate; the raw
picture stays on the device as the fallback of a field whose payload fails
the consistency gate (counted in `pic_raw_fallback`).  'auto' (the
default) picks by the rule of the JAX package: the codec where the
measured device-to-host rate is below what its encode costs per byte it
saves (RAW_PIC_MBPS), else raw.

The batch call is the JAX package's jitted program: on the card it runs
through a `utils/graphs.py::GraphCache`, keyed by its static arguments and
the resident capture, so a key's first call runs eagerly, its second is
captured as a CUDA graph and every later one copies (start0, offset0,
mtf, valid_len) into the graph's static inputs and replays it.  A
replay's outputs are the graph's static tensors: the host copies queue
right after it, and what stays on the device (the chain mode's pictures,
the codec's dense buffers and raw fallback) is cloned.  The graphs read
the capture in place: the segmented Framer refills one buffer at every
swap (`set_capture` keeps the graphs), and the real end of a zero-padded
tail segment, `valid_len`, is a dynamic input (JAX's traced `valid_len`),
so one key serves a whole file.
"""

from __future__ import annotations

import concurrent.futures
import os
from collections import deque
from dataclasses import dataclass
from typing import Dict, List, Optional, Union

import numpy as np
import torch

from ld_decode_tpu_torch.vbi.philips import interpret_philips
from ld_decode_tpu_torch.ops import demod as D
from ld_decode_tpu_torch.tbc import codec as CODEC
from ld_decode_tpu_torch.tbc import fused as FU
from ld_decode_tpu_torch.tbc.field import FieldDecoder, FieldResult
from ld_decode_tpu_torch.utils.device import to_host_async
from ld_decode_tpu_torch.utils.graphs import GraphCache, as_cache
from ld_decode_tpu_torch.utils.spans import span


@dataclass
class _Entry:
    readsample: int
    result: FieldResult
    mtf_level: float
    audio_offset: float


# The codec pays where the bytes it saves take longer on the link than its
# encode takes on the device: below RAW_PIC_MBPS = (raw bytes - coded
# bytes) / encode time a batch, the JAX package's rule (its 200 MB/s came
# from a TPU encode).  chip_smoke.py phase 23 on an NVIDIA H100 80GB HBM3
# at 700 W, batches of 16 synthetic fields (the raw picture copied as
# int32): NTSC 11.31 MB saved for 3.42 ms of encode, 3,306 MB/s; PAL 2,847
# MB/s; the larger is kept.  The card's pinned link measured 53,425 MB/s.
RAW_PIC_MBPS = 3306.0

_LINK_RATE: Dict[str, float] = {}


def probed_link_rate(device) -> float:
    """Device-to-host copy rate in MB/s (cached per device): the median of
    3 pinned, asynchronous copies of 64 MB timed by CUDA events.  On the
    CPU the picture is host memory already: infinite."""
    dev = torch.device(device)
    if dev.type != 'cuda':
        return float('inf')
    key = str(dev)
    if key not in _LINK_RATE:
        n = 32 << 20
        src = torch.ones(n, dtype=torch.int16, device=dev)
        dst = torch.empty(n, dtype=torch.int16, pin_memory=True)
        dst.copy_(src, non_blocking=True)               # warm the path
        times = []
        for _ in range(3):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            dst.copy_(src, non_blocking=True)
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b) / 1e3)
        _LINK_RATE[key] = 2 * n / 1e6 / sorted(times)[1]
    return _LINK_RATE[key]


class _InFlight:
    """One dispatched batch: its outputs (host copies in flight on the
    card), the chained device scalars and the mtf level it ran at.  The
    picture stays on the device in chain mode and in codec mode, where the
    dense buffers stay too and only their prefixes are copied."""

    def __init__(self, out: Dict[str, torch.Tensor], next_start0,
                 next_offset0, mtf_level: float, fetch_picture: bool = True,
                 prefixes: Optional[CODEC.PrefixCopies] = None):
        self.next_start0 = next_start0
        self.next_offset0 = next_offset0
        self.mtf_level = mtf_level
        self.codec = 'dense' in out
        self.picture_dev = out.pop('picture') \
            if self.codec or not fetch_picture else None
        if self.codec:
            self.dense = out.pop('dense')
            self.dense_q = out.pop('dense_q')
            prefixes.start(out, self.dense, self.dense_q)
        self.out, self.event = to_host_async(out)

    def numpy(self) -> Dict[str, np.ndarray]:
        if self.event is not None:
            self.event.synchronize()
        return {k: v.numpy() for k, v in self.out.items()}


class FieldPrefetcher:
    """Supplies FieldResults to the Framer from device-chained batches."""

    DEPTH = 3

    def __init__(self, decoder: FieldDecoder, capture: torch.Tensor,
                 batch: int = 8, fetch_picture: bool = True,
                 pic_mode: str = 'auto',
                 graphs: Union[bool, GraphCache] = True):
        """fetch_picture=False is the chain mode: each FieldResult carries
        its picture as `dev_picture` (the batch tensor and its index) and
        no picture is copied to the host.  pic_mode ('auto', 'codec' or
        'raw', see the module docstring) applies where the picture is
        fetched.  graphs=True (the default) replays each batch call as a
        CUDA graph on the card (module docstring; eager on the CPU);
        graphs=False runs it eagerly; a GraphCache is used as given."""
        if pic_mode not in ('auto', 'codec', 'raw'):
            raise ValueError(f'pic_mode {pic_mode!r}')
        self.decoder = decoder
        self.graphs = as_cache(graphs, decoder.device)
        self.fetch_picture = fetch_picture
        self.pic_mode = pic_mode
        self._codec_on = None          # resolved at the first dispatch
        self._prefixes = CODEC.PrefixCopies()
        self._decode_ex = None
        self.capture = capture
        # absolute file sample of capture[0]: public positions are
        # absolute, device windows capture-relative (nonzero in segmented
        # mode, where `capture` is a sliding resident window of the file)
        self.base = 0
        self.valid_len = capture.shape[0] if capture is not None else 0
        self._vlen_dev = None          # valid_len as a device scalar
        self.batch = batch
        self.queue: List[_Entry] = []
        cfg = decoder.cfg
        self.field_pitch = int(round(cfg.freq_hz / cfg.sys.fps / 2))
        self.tol = cfg.linelen * 20
        # a window that starts EARLY still covers its field while the field
        # plus the next vsync region fit in the rest of the window
        window_lines = decoder.nblocks * cfg.block_keep / cfg.linelen_float
        needed = cfg.sys.field_lines + 0.5 + 21
        self.tol_early = cfg.linelen * max(20.0,
                                           min(window_lines - needed - 5,
                                               100.0))
        self._recent: deque = deque(maxlen=8)
        self.stats = {'refills': 0, 'hits': 0, 'flush_sample': 0,
                      'flush_mtf': 0, 'flush_audio': 0, 'seq_fallback': 0,
                      'seq_decoded': 0,
                      'batches': 0, 'flight_flush': 0, 'pic_raw_fallback': 0,
                      'pic_decode_native': 0, 'pic_decode_numpy': 0,
                      'pic_topups': 0, 'shipped_u16': 0, 'raw_u16': 0,
                      't_dispatch': 0.0, 't_fetch': 0.0, 't_unpack': 0.0}
        self._flight: deque = deque()
        self._mtf_dev = (None, None)

    def flush(self):
        self.queue.clear()
        self._flight.clear()

    def set_capture(self, capture: torch.Tensor, base: int,
                    valid_len: Optional[int] = None):
        """Swap in a new resident segment (absolute file offset `base`).
        The in-flight chain is relative to the old contents, so it
        flushes; the recently-consumed cache stays valid (absolute
        positions, host copies).  `valid_len` marks the real samples of a
        buffer zero-padded to a constant size (the file's tail).  The
        graphs stay: refilled in place, the buffer keeps its key (another
        tensor is another key)."""
        self.flush()
        self.capture = capture
        self.base = int(base)
        self.valid_len = (int(valid_len) if valid_len is not None
                          else capture.shape[0])
        self._vlen_dev = None

    def _pos_match(self, entries, sample: int) -> Optional[int]:
        """Index of the first entry whose decode window covers a field
        starting at `sample`."""
        for k, e in enumerate(entries):
            d = sample - e.readsample
            if -self.tol <= d <= self.tol_early:
                return k
        return None

    # ------------------------------------------------------------------

    def _use_codec(self) -> bool:
        """Resolve pic_mode once per prefetcher (the probe is cached per
        device)."""
        if self._codec_on is None:
            if self.pic_mode == 'auto':
                self._codec_on = probed_link_rate(self.decoder.device) \
                    < RAW_PIC_MBPS
            else:
                self._codec_on = self.pic_mode == 'codec'
            self.stats['pic_mode'] = 'codec' if self._codec_on else 'raw'
        return self._codec_on

    def _dispatch(self, start0, offset0, mtf_level: float):
        """Queue one batch; start0/offset0 are device scalars (host values
        at a refill, the previous batch's return afterwards).  The
        `prefetch.dispatch` span, which `stats['t_dispatch']` sums."""
        with span('prefetch.dispatch') as sp:
            dec = self.decoder
            n_audio1 = dec.nblocks * dec.bank.a_stage1_keep \
                if dec.bank.has_audio else 0
            if self._mtf_dev[0] != mtf_level:
                self._mtf_dev = (mtf_level, torch.full(
                    (), mtf_level, dtype=torch.float32, device=dec.device))
            if self._vlen_dev is None:
                self._vlen_dev = torch.full((), self.valid_len,
                                            dtype=torch.int32,
                                            device=dec.device)
            codec = self.fetch_picture and self._use_codec()
            # the static arguments; the capture is keyed as a tensor read
            key = ('field_pipeline_batch', id(dec.bank), dec.cfg, dec.nblocks,
                   n_audio1, self.batch, self.field_pitch, dec.colorlevel,
                   dec.colorphase, codec)

            def call(s0, o0, mtf, vlen):
                return FU.field_pipeline_batch(
                    self.capture, s0, o0, mtf, dec.bank, dec.cfg, dec.nblocks,
                    n_audio1, self.batch, self.field_pitch,
                    colorlevel=dec.colorlevel, colorphase=dec.colorphase,
                    valid_len=vlen, codec=codec)

            out, nso, noo = self.graphs(
                key, call, (start0, offset0, self._mtf_dev[1], self._vlen_dev),
                reads=(self.capture,))
            if self.graphs.aliased:
                # replayed, the outputs are the graph's static tensors, which
                # the next replay overwrites.  The host copies queued next are
                # stream-ordered, and the chained scalars are read only by the
                # next dispatch's copy into its static inputs; the pictures
                # and dense buffers that stay on the device outlive the next
                # replay, so they are cloned
                if codec or not self.fetch_picture:
                    for k in ('picture', 'dense', 'dense_q'):
                        if k in out:
                            out[k] = out[k].clone()
            self._flight.append(_InFlight(out, nso, noo, mtf_level,
                                          self.fetch_picture, self._prefixes))
        self.stats['batches'] += 1
        self.stats['t_dispatch'] += sp.seconds

    def _schedule(self, mtf_level: float):
        while self._flight and len(self._flight) < self.DEPTH:
            last = self._flight[-1]
            self._dispatch(last.next_start0, last.next_offset0, mtf_level)

    def _fetch_entries(self) -> List[_Entry]:
        """Wait for the front in-flight batch (the `prefetch.fetch` span,
        which `stats['t_fetch']` sums) and unpack it (`prefetch.unpack`,
        `stats['t_unpack']`)."""
        fl = self._flight.popleft()
        with span('prefetch.fetch') as sp:
            data = fl.numpy()
        self.stats['t_fetch'] += sp.seconds
        with span('prefetch.unpack') as sp:
            cfg = self.decoder.cfg
            nlines = FU.max_nlines(cfg)
            W = cfg.sys.outlinelen
            out: List[_Entry] = []
            pic_jobs = []
            prev_rs = -1
            clean = True
            for b in range(self.batch):
                valid, istop, lc, nfo, npk, nvs, rs, wf = (
                    int(x) for x in data['meta_i'][b])
                if not valid or rs <= prev_rs:
                    # invalid field, or EOF window clamp: keep the prefix;
                    # anything chained after it is unreliable
                    clean = False
                    break
                prev_rs = rs
                rs_abs = rs + self.base
                linelocs = (data['linelocs_i'][b].astype(np.float64)
                            + data['linelocs_f'][b].astype(np.float64)
                            )[:nlines]
                linecode = {}
                for i, l in enumerate(cfg.sys.philips_codelines):
                    linecode[l] = ([int(x) for x in data['philips_nib'][b, i]]
                                   if data['philips_ok'][b, i] else None)
                r = FieldResult(
                    True, nfo, istop=bool(istop), linecount=lc, tbcstart=nfo,
                    peak_count=npk, vsync_count=nvs, linelocs=linelocs,
                    burstlevel=data['burstlevel'][b].astype(
                        np.float64)[:nlines],
                    vbi=interpret_philips(linecode), linecode=linecode,
                    readsample=rs_abs, white_flag=bool(wf))
                if self.decoder.bank.has_audio:
                    nout = (int(data['audio_count'][b]) - 1) * 2
                    r.dsaudio = data['audio'][b][:nout]
                r.audio_next_offset = float(data['audio_next_offset'][b])
                if fl.codec:
                    pic_jobs.append((b, r, lc))
                elif fl.picture_dev is None:
                    r.dspicture = data['picture'][b].reshape(-1)[
                        :lc * W].astype(np.uint16)
                else:
                    r.dev_picture = (fl.picture_dev, b)
                out.append(_Entry(rs_abs, r, fl.mtf_level,
                                  float(data['meta_f'][b])))
            if not clean and self._flight:
                # downstream in-flight batches chained off garbage state
                self._flight.clear()
                self.stats['flight_flush'] += 1
            if fl.codec:
                self._decode_pictures(fl, data, pic_jobs)
        self.stats['t_unpack'] += sp.seconds
        return out

    def _decode_pictures(self, fl: _InFlight, data, jobs):
        """The codec route: each field's picture decoded from its region of
        the dense prefixes (fields in parallel; the native decode releases
        the GIL), through the consistency gate; a field that fails it
        copies its raw picture from the device."""
        cfg = self.decoder.cfg
        L, W, Wp, _, k = FU.pic_codec_params(cfg)
        rows2 = data['rows2'].astype(np.int64)
        before = self._prefixes.topups
        dense, dense_q = self._prefixes.finish(data, fl.dense, fl.dense_q,
                                               rows2)
        self.stats['pic_topups'] += self._prefixes.topups - before
        n = rows2.shape[1]
        self.stats['shipped_u16'] += int(rows2.sum()) \
            + data['pic_tab'].size
        self.stats['raw_u16'] += n * L * W
        if self._decode_ex is None:
            self._decode_ex = concurrent.futures.ThreadPoolExecutor(
                max_workers=min(8, os.cpu_count() or 1))
        # the fields past an invalid one are not decoded
        m = len(jobs)
        results = CODEC.decode_batch(data['pic_tab'][:m].view(np.uint16),
                                     dense, dense_q, rows2[:, :m], (L, Wp),
                                     k, False, self._decode_ex)
        for (b, r, lc), (img, route) in zip(jobs, results):
            if route is not None:
                self.stats[f'pic_decode_{route}'] += 1
            if img is None:
                # defensive only: the capacity covers all 16 planes, so no
                # content can fail the gate
                self.stats['pic_raw_fallback'] += 1
                pic = fl.picture_dev[b].cpu().numpy().astype(np.uint16)
            else:
                pic = img[:, :W]
            r.dspicture = pic.reshape(-1)[:lc * W]

    # ------------------------------------------------------------------

    def _matches(self, e: _Entry, mtf_level: float, audio_offset: float):
        # mtf tolerance well below the reference's 0.1 re-decode threshold;
        # the audio chain is deterministic f32 arithmetic, so any real
        # divergence is at least one 48 kHz tick (2.08e-5)
        return (abs(e.mtf_level - mtf_level) <= .02
                and abs(e.audio_offset - audio_offset) < 1e-7)

    def get(self, sample: int, mtf_level: float, audio_offset: float
            ) -> Optional[FieldResult]:
        """FieldResult for a window at `sample` (or None at EOF)."""
        if not self.queue and self._flight:
            self.queue.extend(self._fetch_entries())
            self._schedule(mtf_level)
        while self.queue:
            k = self._pos_match(self.queue, sample)
            ahead = sample - self.queue[-1].readsample
            if k is None and self._flight and self.tol < ahead \
                    <= 2 * self.batch * self.field_pitch:
                # a short way past the queue tail: the match may sit in the
                # next in-flight batch; bigger jumps (resync) flush instead
                self.queue.extend(self._fetch_entries())
                self._schedule(mtf_level)
                continue
            if k is not None:
                e = self.queue[k]
                if self._matches(e, mtf_level, audio_offset):
                    for skipped in self.queue[:k]:
                        self._recent.append(skipped)
                    del self.queue[:k + 1]
                    self._recent.append(e)
                    self.stats['hits'] += 1
                    if not self.queue or len(self.queue) <= self.batch // 2:
                        self._schedule(mtf_level)
                    return e.result
                if abs(e.mtf_level - mtf_level) > .02:
                    self.stats['flush_mtf'] += 1
                else:
                    self.stats['flush_audio'] += 1
            else:
                # an already-consumed field re-requested (frame pairing)?
                kc = self._pos_match(self._recent, sample)
                if kc is not None:
                    e = self._recent[kc]
                    if self._matches(e, mtf_level, audio_offset):
                        return e.result
                self.stats['flush_sample'] += 1
            self.flush()
            break
        self._refill(sample, mtf_level, audio_offset)
        if not self.queue:
            return None
        entry = self.queue.pop(0)
        self._recent.append(entry)
        return entry.result

    # ------------------------------------------------------------------

    def _refill(self, sample: int, mtf_level: float, audio_offset: float):
        """Restart the chain at `sample`: the `prefetch.refill` span."""
        with span('prefetch.refill'):
            self.stats['refills'] += 1
            dec = self.decoder
            cfg = dec.cfg
            n_stream = D.stream_len(cfg, dec.nblocks)
            smax = self.valid_len - n_stream + cfg.blockcut
            s0 = max(int(sample) - self.base, cfg.blockcut)
            if s0 > smax:
                return
            self.flush()
            dev = dec.device
            self._dispatch(torch.full((), s0, dtype=torch.int32, device=dev),
                           torch.full((), audio_offset, dtype=torch.float32,
                                      device=dev), mtf_level)
            self._schedule(mtf_level)
            self.queue.extend(self._fetch_entries())
            self._schedule(mtf_level)

            if not self.queue:
                # batch head failed: decode one field sequentially (handles
                # resync/invalid paths exactly)
                self._flight.clear()
                self.stats['seq_fallback'] += 1
                with span('prefetch.seq_fallback'):
                    r = dec.process_resident(self.capture,
                                             int(sample) - self.base,
                                             mtf_level, audio_offset)
                if r is not None:
                    # a valid sequential field ran the device finish
                    self.stats['seq_decoded'] += int(r.valid)
                    if r.readsample >= 0:
                        r.readsample += self.base
                    self.queue.append(_Entry(int(sample), r, mtf_level,
                                             audio_offset))
