"""Frame assembly: field pairing, interlace weave, resync policy, MTF
feedback and frame-accurate seek (torch port of
ld_decode_tpu/tbc/framer.py).

Host-side control flow over per-field results.  With batch > 1 the compute
runs in the batched device pipeline (tbc/pipeline.py, tbc/fused.py); with
batch=1 each field is decoded on its own: `FieldDecoder.process` on a
loader's window (the JAX package's default Framer, and lddecode --batch 1)
or `FieldDecoder.process_resident` on a device-resident capture.
"""

from __future__ import annotations

from typing import Callable, Optional, Union

import numpy as np
import torch

from ld_decode_tpu_torch.utils.device import DEFAULT as DEFAULT_DEVICE
from ld_decode_tpu_torch.utils.device import resolve as resolve_device
from ld_decode_tpu_torch.utils.graphs import GraphCache, as_cache
from ld_decode_tpu_torch.utils.params import DecoderConfig
from ld_decode_tpu_torch.ops import demod as D
from ld_decode_tpu_torch.ops.filters import DemodBank
from ld_decode_tpu_torch.tbc import fused as FU
from ld_decode_tpu_torch.tbc.field import FieldDecoder
from ld_decode_tpu_torch.tbc.pipeline import FieldPrefetcher

def to_device_capture(samples: np.ndarray, device) -> torch.Tensor:
    """Raw capture samples -> the resident float32 capture.  .r16 captures
    are signed and zero-centred: they are recentred to unsigned 16-bit
    like every other format (a DC shift is invisible to the FM demod's RF
    bandpass).  float32 holds every 16-bit sample exactly."""
    arr = np.asarray(samples)
    if np.issubdtype(arr.dtype, np.signedinteger):
        arr = arr.astype(np.int32) + 32768
    return torch.from_numpy(arr.astype(np.float32)).to(device)


def weave_device(pa: torch.Tensor, ia: int, pb: torch.Tensor, ib: int,
                 half: int, lf_sel: int, tail_ok: bool,
                 outlines: int) -> torch.Tensor:
    """Interlace weave on the device (the semantics of the host weave in
    Framer.formatoutput).  pa/pb: (batch, max_lc, W) int32 batch pictures
    and ia/ib the two fields' indices in them (a pair may straddle two
    batches).  The row indices come from host ints, so nothing waits for
    the device.  Returns the (outlines * W,) int32 frame."""
    L = pa.shape[1]
    dev = pa.device
    fld = torch.stack([pa[ia], pb[ib]])                  # (2, L, W)
    r = torch.arange(outlines, device=dev)
    is_main = r < 2 * half
    fidx = torch.where(is_main, r & 1, lf_sel)
    lidx = torch.where(is_main, r >> 1, half).clamp(max=L - 1)
    ok = is_main | ((r == 2 * half) & tail_ok)
    out = torch.where(ok[:, None], fld[fidx, lidx], 0)
    return out.reshape(-1)


class Framer:
    def __init__(self, cfg: DecoderConfig, bank: DemodBank,
                 loader: Callable = None, full_decode: bool = True,
                 nblocks: int = 66, capture: np.ndarray = None,
                 batch: int = 8,
                 despackle: bool = False, segment_samples: int = 0,
                 rot_level: float = 40.0, flip_fields: bool = False,
                 bff: bool = False, device=DEFAULT_DEVICE,
                 fetch_picture: bool = True, pic_mode: str = 'auto',
                 graphs: Union[bool, GraphCache] = True):
        """Either `loader` (file reads) or `capture` (the whole capture kept
        on the device) must be given.  The parameters up to `nblocks` take
        the JAX package's positions; one default differs from it on
        purpose: `batch` is 8 here and 1 there (so `Framer(cfg, bank,
        loader)` decodes batched here and sequentially there).  `device`
        comes before `fetch_picture` and `pic_mode`, which JAX's Framer
        ends with: pass them by keyword.

        full_decode=False locates fields without decoding their content,
        as the JAX package does: at batch=1 a field skips the burst or
        pilot passes (its line locations stay at the hsync stage) and has
        no picture and no audio; at batch > 1 the fields decode in full.
        Either way readframe returns no frame (None) and its fields.

        batch > 1: batches of `batch` speculative fields run through the
        device pipeline, a loader's reads going into a sliding
        device-resident segment of `segment_samples`; the audio carry
        advances per field.  fetch_picture=False is the chain mode: the
        fields' pictures stay on the device and readframe returns the woven
        frame as a device tensor (int32) for the comb.  pic_mode ('auto',
        'codec' or 'raw') is how a fetched picture crosses to the host
        (tbc/pipeline.py): 'auto' measures the device-to-host rate once
        and takes the raw copy on the card and on the CPU.  graphs=True
        (the default; the JAX package always jits) replays each batch call
        as a CUDA graph on the card (utils/graphs.py; eager on the CPU);
        graphs=False runs it eagerly, for comparisons; a GraphCache is
        used as given.  At batch=1 the cache serves the decoder's
        sequential programs; at batch > 1 it serves the prefetcher, and the
        decoder's fallback for a batch head that does not lock stays eager:
        it runs for the first field of a segment and at a resync, too
        rarely to repay a capture.

        batch=1: one field a call, in order (the JAX package's default): a
        loader's window of each field is read and decoded by
        FieldDecoder.process, a resident capture's by process_resident;
        the audio carry advances per frame, and the pictures come to the
        host (fetch_picture is not read)."""
        FU.require_tbc(cfg)
        if (loader is None) == (capture is None):
            raise ValueError('give exactly one of loader= and capture=')
        self.cfg = cfg
        self.device = resolve_device(device)
        self.bank = bank.to(self.device)
        self.loader = loader
        self.full_decode = full_decode
        self.despackle = despackle
        self.rot_level = rot_level
        self.flip_fields = flip_fields
        self.bff = bff
        self.nblocks = nblocks
        self.graphs = as_cache(graphs, self.device)
        self.decoder = FieldDecoder(cfg, self.bank, nblocks, self.device,
                                    graphs=self.graphs if batch <= 1
                                    else False)

        self.capture_dev = None
        if capture is not None:
            self.capture_dev = to_device_capture(capture, self.device)
        self.prefetcher = None
        self._seg_samples = 0
        if batch > 1:
            self.prefetcher = FieldPrefetcher(self.decoder, self.capture_dev,
                                              batch,
                                              fetch_picture=fetch_picture,
                                              pic_mode=pic_mode,
                                              graphs=self.graphs)
        if self.prefetcher is not None and self.capture_dev is None:
            if segment_samples <= 0:
                segment_samples = 256 << 20      # 1 GiB of float32
            # lookahead the chain needs resident beyond any request
            horizon = ((self.prefetcher.DEPTH + 1) * batch
                       * self.prefetcher.field_pitch
                       + D.stream_len(cfg, nblocks))
            self._seg_samples = max(int(segment_samples), 2 * horizon)
            self._seg_horizon = horizon
            self._seg_base = -1                  # nothing loaded yet
            self._seg_eof = False
            self._seg_valid = 0

        self.outwidth = cfg.sys.outlinelen
        self.outlines = cfg.sys.frame_lines
        self.clvfps = 25 if cfg.system == 'PAL' else 30
        self.audio_offset = 0.0
        self.mtf_level = 1.0
        self.vbi = {'framenr': None, 'isclv': False, 'minutes': None}

    # ------------------------------------------------------------------

    def _load(self, infile, readsample: int) -> Optional[np.ndarray]:
        """Fetch the demod window so output index 0 == file sample
        `readsample` (reference head-cut alignment, lddecode_core.py:376-379):
        a window that starts before the file is zero-padded at its head."""
        start = readsample - self.cfg.blockcut
        n = D.stream_len(self.cfg, self.nblocks)
        if start < 0:
            data = self.loader(infile, 0, n + start)
            if data is None:
                return None
            return np.concatenate([np.zeros(-start, data.dtype), data])
        return self.loader(infile, start, n)

    def _ensure_segment(self, infile, sample: int) -> bool:
        """Segmented mode: make [sample, sample+horizon) device-resident.
        Returns False at end of file (nothing loadable at `sample`)."""
        if self._seg_samples == 0:
            return True
        n_stream = D.stream_len(self.cfg, self.nblocks)
        lo = self._seg_base
        seg_len = self._seg_valid
        if lo >= 0 and lo + self.cfg.blockcut <= sample and (
                sample + self._seg_horizon <= lo + seg_len
                # at the file tail no reload can extend coverage: accept
                # while one decode window still fits
                or (self._seg_eof and sample - lo + n_stream <= seg_len)):
            return True
        from ld_decode_tpu_torch.io.loaders import file_samples, load_available
        base = max(int(sample) - self.cfg.blockcut - 8 * self.cfg.linelen, 0)
        avail = file_samples(self.loader, infile)
        if avail is not None:
            n = min(self._seg_samples, avail - base)
            data = self.loader(infile, base, n) if n >= n_stream else None
        else:
            data = load_available(self.loader, infile, base,
                                  self._seg_samples, n_stream)
        if data is None or len(data) < n_stream:
            return False
        self._seg_eof = len(data) < self._seg_samples
        self._seg_valid = len(data)
        self._seg_base = base
        self.prefetcher.set_capture(to_device_capture(data, self.device),
                                    base, valid_len=self._seg_valid)
        return True

    def readfield(self, infile, sample: int):
        """Decode the field at `sample`, skipping invalid windows."""
        cfg = self.cfg
        readsample = int(sample)
        while True:
            if self.prefetcher is not None:
                if not self._ensure_segment(infile, readsample):
                    return None, None, None
                f = self.prefetcher.get(readsample, self.mtf_level,
                                        self.audio_offset)
                if f is None:
                    return None, None, None
                if f.valid and f.dsaudio is not None:
                    # batched mode: per-field audio carry
                    self.audio_offset = f.audio_next_offset
            elif self.capture_dev is not None:
                f = self.decoder.process_resident(
                    self.capture_dev, readsample, self.mtf_level,
                    self.audio_offset, self.full_decode)
                if f is None:
                    return None, None, None
            else:
                stream = self._load(infile, readsample)
                if stream is None:
                    return None, None, None
                f = self.decoder.process(stream, self.mtf_level,
                                         self.audio_offset, self.full_decode)
            # advance from the actual decode-window start
            base = f.readsample if f.readsample >= 0 else readsample
            nextsample = base + f.nextfieldoffset
            if not f.valid:
                if f.peak_count < 100:
                    # no recognizable data: jump 10s past possible spin-up
                    nextsample = readsample + int(cfg.freq_hz * 10)
                elif f.vsync_count == 0:
                    nextsample = readsample + int(cfg.freq_hz * 1)
                readsample = nextsample
            else:
                return f, readsample, nextsample

    def mergevbi(self, fields) -> dict:
        merged = dict(fields[0].vbi)
        for k, v in fields[1].vbi.items():
            if v is not None:
                merged[k] = v
        if merged.get('seconds') is not None:
            merged['framenr'] = (merged['minutes'] * 60 * self.clvfps
                                 + merged['seconds'] * self.clvfps
                                 + merged['clvframe'])
        return merged

    def formatoutput(self, fields):
        """Interlace weave incl. the visible half-line.  In chain mode both
        fields live on the device and so does the weave (an int32 tensor);
        otherwise a uint16 numpy frame."""
        if all(f.dspicture is None and f.dev_picture is not None
               for f in fields):
            top, bot = ((fields[1], fields[0]) if self.flip_fields
                        else fields)
            half = min(fields[0].linecount, fields[1].linecount)
            lf = int(np.argmax([fields[0].linecount, fields[1].linecount]))
            tail_ok = (half + 1) <= fields[lf].linecount
            lf_sel = (1 - lf) if self.flip_fields else lf
            pa, ia = top.dev_picture
            pb, ib = bot.dev_picture
            return weave_device(pa, ia, pb, ib, half, lf_sel, tail_ok,
                                self.outlines)
        for f in fields:
            if f.dspicture is None and f.dev_picture is not None:
                # mixed pair (one field came from the sequential fallback):
                # materialize the device one
                pics, i = f.dev_picture
                f.dspicture = pics[i].reshape(-1)[
                    :f.linecount * self.outwidth].cpu().numpy().astype(
                        np.uint16)
        W = self.outwidth
        half = min(fields[0].linecount, fields[1].linecount)
        linecount = half * 2
        combined = np.zeros(W * self.outlines, dtype=np.uint16)
        rows = combined.reshape(self.outlines, W)
        top, bot = (fields[1], fields[0]) if self.flip_fields else fields
        rows[0:linecount:2] = top.dspicture[:half * W].reshape(-1, W)
        rows[1:linecount:2] = bot.dspicture[:half * W].reshape(-1, W)
        lf = int(np.argmax([fields[0].linecount, fields[1].linecount]))
        cur = linecount // 2
        if (cur + 1) * W <= len(fields[lf].dspicture):
            combined[linecount * W:(linecount + 1) * W] = \
                fields[lf].dspicture[cur * W:cur * W + W]
        return combined

    def readframe(self, infile, sample: int, firstframe: bool = False,
                  CAV: bool = False):
        """Pair two fields into a frame: (frame u16, audio i16, next
        sample, fields), or Nones at EOF.  With full_decode=False the frame
        is None."""
        cfg = self.cfg
        fieldcount = 0
        fields = [None, None]
        audio = []
        f = None

        while fieldcount < 2:
            f, readsample, nextsample = self.readfield(infile, sample)
            if f is not None:
                if f.istop:
                    fields[0] = f
                else:
                    fields[1] = f
                if ((not CAV and (f.istop == (cfg.sys.topfirst ^ self.bff)))
                        or (CAV and (f.vbi['framenr'] or f.vbi['minutes']))):
                    fieldcount = 1
                elif fieldcount == 1:
                    fieldcount = 2
                if (fieldcount or not firstframe) and f.dsaudio is not None:
                    audio.append(f.dsaudio)
            elif readsample is None:
                return None, None, None, None
            sample = nextsample

        if audio:
            conaudio = np.concatenate(audio)
            self.audio_offset = f.audio_next_offset
        else:
            conaudio = None

        combined = self.formatoutput(fields) if self.full_decode else None
        if self.despackle and isinstance(combined, torch.Tensor):
            # despackle is a host numpy pass
            combined = combined.cpu().numpy().astype(np.uint16)
        if self.despackle and combined is not None:
            # rot concealment post-pass (reference tbc.cpp:1528-1565)
            from ld_decode_tpu_torch.tbc.despackle import despackle as _dsp
            scale = ((0xc800 - 0x0400) if cfg.system == 'NTSC'
                     else (0xd300 - 0x0100)) / (100 - cfg.sys.vsync_ire)
            off = 1024 if cfg.system == 'NTSC' else 256
            combined = _dsp(combined, self.outwidth, scale, off,
                            cfg.sys.vsync_ire, rot_level=self.rot_level)
        self.vbi = self.mergevbi(fields)

        # full line-0 metadata words (ld-decoder.h:227-252 spec)
        from ld_decode_tpu_torch.vbi.metadata import frame_metadata_words
        words = frame_metadata_words(fields, self.vbi, cfg)
        if isinstance(combined, torch.Tensor):
            combined[:16] = torch.from_numpy(
                np.asarray(words, np.int32)).to(combined.device)
        elif combined is not None:
            combined[:16] = words

        # MTF compensation feedback: the CAV frame number drives the RF
        # equalizer level; a large change forces a re-decode
        if not f.vbi['isclv'] and f.vbi['framenr'] is not None:
            newmtf = max(1 - (f.vbi['framenr'] / 10000), 0)
            oldmtf = self.mtf_level
            self.mtf_level = newmtf
            if abs(newmtf - oldmtf) > .1:
                return self.readframe(infile, sample, firstframe, CAV)

        return combined, conaudio, sample, fields


def findframe(infile, framer: Framer, target: int,
              nextsample: int = 0) -> Optional[int]:
    """Frame-accurate seek by decode-probe + jump."""
    cfg = framer.cfg
    samples_per_frame = int(cfg.freq_hz / cfg.sys.fps)
    framer.vbi = {'framenr': None, 'isclv': False, 'minutes': None}

    iscav = False
    tolerance = 0
    rv = None
    retry = 5
    while framer.vbi.get('framenr') is None and retry:
        rv = framer.readframe(infile, nextsample, CAV=False)
        if framer.vbi.get('isclv'):
            tolerance = 1
        else:
            tolerance = 0
            iscav = True
        if framer.vbi.get('framenr') is None:
            # only jump the 10 s spin-up distance on a FAILED probe
            nextsample = (rv[2] if rv[2] is not None else nextsample) \
                + int(cfg.freq_hz * 10)
        retry -= 1

    if framer.vbi.get('framenr') is None:
        return None

    if abs(target - framer.vbi['framenr']) <= tolerance:
        # the probe already landed on the target: point back at the frame
        # the probe consumed
        return rv[2] + samples_per_frame * (target - 1
                                            - framer.vbi['framenr'])

    retry = 5
    while abs(target - framer.vbi['framenr']) > tolerance and retry:
        if rv is None or rv[2] is None:
            return None
        offset = samples_per_frame * (target - 1 - framer.vbi['framenr'])
        nextsample = rv[2] + offset
        rv = framer.readframe(infile, nextsample, CAV=iscav)
        retry -= 1

    return nextsample
