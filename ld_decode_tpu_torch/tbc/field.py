"""Field decoder: host sync logic + the sequential device path (torch port
of ld_decode_tpu/tbc/field.py).

The host side (vsync voting, line numbering with gap repair) is numpy over
O(peaks) values and is the JAX package's code unchanged.  The device side
of the one path the port keeps, `process_resident`, runs the phase-A
analysis (demod + sync peaks) and the finish (refinement, resample,
outputs) for one field; the batched prefetcher (tbc/pipeline.py) falls
back to it when a batch head does not lock, which always happens for the
first field of a decode.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ld_decode_tpu_torch.utils.device import DEFAULT as DEFAULT_DEVICE
from ld_decode_tpu_torch.utils.device import resolve as resolve_device
from ld_decode_tpu_torch.utils.params import DecoderConfig
from ld_decode_tpu_torch.vbi.philips import decode_philips_line, interpret_philips
from ld_decode_tpu_torch.ops import demod as D
from ld_decode_tpu_torch.ops.filters import DemodBank
from ld_decode_tpu_torch.tbc import fused as FU


@dataclass
class FieldResult:
    valid: bool
    nextfieldoffset: int                  # input samples, from the read start
    istop: bool = False
    linecount: int = 0
    tbcstart: int = 0
    peak_count: int = 0
    vsync_count: int = 0
    linelocs: Optional[np.ndarray] = None
    burstlevel: Optional[np.ndarray] = None
    dspicture: Optional[np.ndarray] = None    # uint16 (linecount*outlinelen)
    dsaudio: Optional[np.ndarray] = None      # int16 interleaved
    audio_next_offset: float = 0.0
    vbi: Optional[dict] = None
    linecode: Optional[dict] = None
    # actual decode-window start (input samples); `nextfieldoffset` is
    # measured from it.  -1 = the window started at the caller's request.
    readsample: int = -1
    # white flag computed on the device by the batched pipeline (None on
    # the sequential path: the host computes it from dspicture)
    white_flag: Optional[bool] = None
    # chain mode (FieldPrefetcher(fetch_picture=False)): the picture stays
    # on the device as (batch pictures (B, max_lc, W) int32, index) and
    # dspicture is None
    dev_picture: Optional[tuple] = None


def hsync_stats(vals: np.ndarray) -> Tuple[float, float]:
    """Median/tolerance of regular-hsync peak levels."""
    sel = vals[(vals >= 0.6) & (vals <= 0.8)]
    if len(sel) == 0:
        return 0.7, 0.01
    med = float(np.median(sel))
    tol = max(float(np.std(sel)) * 2, .01)
    return med, tol


class FieldDecoder:
    """Decodes one field per call from a device-resident capture."""

    def __init__(self, cfg: DecoderConfig, bank: DemodBank,
                 nblocks: int = 66, device=DEFAULT_DEVICE):
        FU.require_tbc(cfg)
        need_lines = cfg.sys.field_lines + 0.5 + 21
        window_lines = nblocks * cfg.block_keep / cfg.linelen_float
        if window_lines < need_lines:
            raise ValueError(
                f'nblocks={nblocks} gives a {window_lines:.0f}-line window '
                f'but a {cfg.system} field needs >= {need_lines:.0f} lines '
                f'(use nblocks >= '
                f'{int(np.ceil(need_lines * cfg.linelen_float / cfg.block_keep))})')
        self.cfg = cfg
        self.device = resolve_device(device)
        self.bank = bank.to(self.device)
        self.nblocks = nblocks
        self.inlinelen = cfg.linelen
        self.outlinelen = cfg.sys.outlinelen
        self.field_lines = cfg.sys.frame_lines // 2
        self.colorphase = 90 + 1.5
        self.colorlevel = 1.45

    # ---------------- host-side sync logic ----------------

    def determine_field(self, peaks, vals, i, med, tol):
        """Field polarity vote from half-line gaps around a vsync."""
        if i < 11:
            return None, 0
        reg = (vals >= med - tol) & (vals <= med + tol)
        vote = 0
        line0 = None
        for j in range(i - 1, max(i - 20, -1), -1):
            if reg[j]:
                line0 = j
                if j + 1 < len(peaks):
                    gap1 = peaks[j + 1] - peaks[j]
                    if gap1 > self.inlinelen * .75:
                        vote -= 1
                break
        for j in range(i, min(i + 20, len(peaks))):
            if reg[j]:
                gap2 = peaks[j] - peaks[j - 1]
                if gap2 > self.inlinelen * .75:
                    vote += 1 if self.cfg.system == 'NTSC' else -1
                break
        if self.cfg.system == 'PAL':
            vote += 1
        return line0, vote

    def determine_vsyncs(self, peaks, vals) -> List[List[int]]:
        if len(peaks) < 200:
            return []
        med, tol = hsync_stats(vals)
        prev = np.concatenate([[1.0], vals[:-1]])
        cands = np.nonzero((vals > .9) & (prev < med - tol * 2))[0]
        out = []
        for i in cands:
            line0, vote = self.determine_field(peaks, vals, int(i), med, tol)
            if line0 is not None:
                out.append([int(i), line0, vote])
        if len(out) < 2:
            return out

        back = 6 if self.cfg.system == 'PAL' else 7
        for i in range(len(out)):
            if out[i][2] == 0:
                out[i][1] = -1
                if i < len(out) - 1 and out[i + 1][2] != 0:
                    out[i][2] = -out[i + 1][2]
                elif i >= 1 and out[i - 1][2] != 0:
                    out[i][2] = -out[i - 1][2]
            if out[i][1] <= 0:
                out[i][1] = out[i][0] - back
            out[i][2] = int(out[i][2] < 0)
        return out

    def compute_linelocs(self, peaks, vals, vsyncs, linecount):
        """Integer line numbering + gap interpolation."""
        med, tol = hsync_stats(vals)
        reg = (vals >= med - tol) & (vals <= med + tol)

        end = vsyncs[1][1]
        reg_idx = np.nonzero(reg[:end])[0]
        linelocs: Dict[int, float] = {}
        if len(reg_idx):
            ps = peaks[reg_idx].astype(np.float64)
            gaps = np.diff(ps)
            ok = (gaps / self.inlinelen >= .98) & (gaps / self.inlinelen
                                                   <= 1.02)
            inc = np.where(ok, 1, 0)
            for j in np.nonzero(~ok)[0]:
                hist = np.concatenate(
                    [[float(self.inlinelen)], gaps[:j][ok[:j]]])[-25:]
                inc[j] = int(round(gaps[j] / np.median(hist)))
            first = int(round((ps[0] - peaks[vsyncs[0][1]])
                              / self.inlinelen))
            nums = first + np.concatenate([[0], np.cumsum(inc)])
            for n, p in zip(nums, ps):       # later duplicates overwrite
                linelocs[int(n)] = float(p)

        present = np.array(sorted(linelocs), dtype=np.int64)
        filled = dict(linelocs)
        for l in range(1, linecount + 5):
            if l in linelocs:
                continue
            ins = np.searchsorted(present, l)
            prev_valid = None
            if ins > 0 and present[ins - 1] > -10:
                prev_valid = int(present[ins - 1])
            next_valid = None
            if ins < len(present) and present[ins] <= linecount:
                next_valid = int(present[ins])
            if prev_valid is None:
                filled[l] = linelocs[next_valid] - (self.inlinelen
                                                    * (next_valid - l))
            elif next_valid is not None:
                avglen = ((linelocs[next_valid] - linelocs[prev_valid])
                          / (next_valid - prev_valid))
                filled[l] = linelocs[prev_valid] + (avglen * (l - prev_valid))
            else:
                avglen = linelocs[prev_valid] - filled[prev_valid - 1]
                filled[l] = linelocs[prev_valid] + (avglen * (l - prev_valid))

        ll = np.array([filled[l] for l in range(1, linecount + 5)])
        bad = np.array([l not in linelocs for l in range(1, linecount + 5)])
        bad[:10] = False
        return ll, bad

    # ---------------- device-resident sequential path ----------------

    def analyze_resident(self, capture: torch.Tensor, readsample: int,
                         mtf_level: float):
        """Demod + peaks for one window (one read-back of the peak list).
        Returns (video, audio, peaks, vals) or None at EOF."""
        cfg = self.cfg
        n = D.stream_len(cfg, self.nblocks)
        readsample = max(readsample, cfg.blockcut)
        if readsample - cfg.blockcut + n > capture.shape[0]:
            return None
        video, audio, idx, val = FU.field_analyze(
            capture, readsample, self.bank, cfg, self.nblocks, mtf_level)
        idx = idx[0].cpu().numpy()
        val = val[0].cpu().numpy()
        nvalid = int((idx >= 0).sum())
        return video, audio, idx[:nvalid], val[:nvalid]

    def process_resident(self, capture: torch.Tensor, readsample: int,
                         mtf_level: float = 0.0, audio_offset: float = 0.0
                         ) -> Optional[FieldResult]:
        """One field: device analyze, host vsync/line numbering, device
        finish.  Returns None at EOF."""
        cfg = self.cfg
        rv = self.analyze_resident(capture, readsample, mtf_level)
        if rv is None:
            return None
        video, audio, peaks, vals = rv

        if len(peaks) == 0:
            return FieldResult(False, cfg.linelen * 200, peak_count=0,
                               vsync_count=0)
        vsyncs = self.determine_vsyncs(peaks, vals)
        if len(vsyncs) == 0:
            return FieldResult(False, cfg.linelen * 200,
                               peak_count=len(peaks), vsync_count=0)
        if len(vsyncs) == 1 or len(peaks) < vsyncs[1][1] + 4:
            jumpto = int(peaks[max(vsyncs[0][1] - 10, 0)])
            nfo = jumpto if jumpto != 0 else cfg.linelen * 240
            return FieldResult(False, nfo, peak_count=len(peaks),
                               vsync_count=len(vsyncs))

        nextfieldoffset = int(peaks[vsyncs[1][1] - 10])
        istop = bool(vsyncs[0][2])
        linecount = self.field_lines + (1 if istop else 0)

        try:
            linelocs1, linebad = self.compute_linelocs(peaks, vals, vsyncs,
                                                       linecount)
        except (KeyError, IndexError, TypeError, ValueError,
                ZeroDivisionError):
            # the reference surfaces unnumberable fields as exceptions
            return FieldResult(False, nextfieldoffset,
                               peak_count=len(peaks), vsync_count=len(vsyncs))

        n_audio1 = self.nblocks * self.bank.a_stage1_keep \
            if audio is not None else 0
        nmax = FU.max_nlines(cfg)
        ll1p, badp = FU.pad_linelocs(linelocs1, linebad, nmax, cfg.linelen)
        ll1i = np.floor(ll1p).astype(np.int32)
        ll1f = (ll1p - ll1i).astype(np.float32)
        dev = self.device

        def put(a):
            return torch.from_numpy(np.ascontiguousarray(a))[None].to(dev)

        out = FU.field_finish(
            video, audio, put(ll1i), put(ll1f), put(badp),
            torch.full((1,), linecount, dtype=torch.int32, device=dev),
            torch.full((1,), audio_offset, dtype=torch.float32, device=dev),
            self.bank, cfg, n_audio1,
            colorlevel=self.colorlevel, colorphase=self.colorphase)
        data = {k: v[0].cpu().numpy() for k, v in out.items()}

        nlines = len(linelocs1)
        linelocs = (data['linelocs_i'].astype(np.float64)
                    + data['linelocs_f'].astype(np.float64))[:nlines]
        linecode = {}
        for i, l in enumerate(cfg.sys.philips_codelines):
            linecode[l] = decode_philips_line(
                data['philips'][i], float(data['philips_frac'][i]), cfg)
        result = FieldResult(
            True, nextfieldoffset, istop=istop, linecount=linecount,
            tbcstart=nextfieldoffset, peak_count=len(peaks),
            vsync_count=len(vsyncs), linelocs=linelocs,
            burstlevel=data['burstlevel'].astype(np.float64)[:nlines],
            vbi=interpret_philips(linecode), linecode=linecode)
        result.dspicture = data['picture'].reshape(-1)[
            :linecount * cfg.sys.outlinelen].astype(np.uint16)
        if audio is not None:
            nout = (int(data['audio_count']) - 1) * 2
            result.dsaudio = data['audio'][:nout]
            result.audio_next_offset = float(data['audio_next_offset'])
        return result
