"""Field decoder: host sync logic + the sequential device paths (torch port
of ld_decode_tpu/tbc/field.py).

The host side (vsync voting, line numbering with gap repair) is numpy over
O(peaks) values and is the JAX package's code unchanged.  Two sequential
paths decode one field a call:

  * `process` (the `--batch 1` decode of a loader's window): the JAX
    package's host logic unchanged -- the float64 hsync repair loop and gap
    sanitizers, the burst-phase repair, the float64 u16 scaling with +0.5
    rounding and the burst flag words, the 48 kHz chase on the host --
    around the device work (demod, sync peaks, the hsync zero crossings,
    burst phases, the PAL pilot pass, audio stage 2) on tensors;
  * `process_resident`: the phase-A analysis (demod + sync peaks) and the
    batch path's finish (refinement, resample, outputs) for one field of a
    device-resident capture; the batched prefetcher (tbc/pipeline.py)
    falls back to it when a batch head does not lock, which always happens
    for the first field of a decode.

Every line resample of both goes through tbc/cuda_resample.py at B=1: the
hand-written kernel on the card, the plain version on the CPU.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ld_decode_tpu_torch.audio.downscale import downscale_audio
from ld_decode_tpu_torch.audio.stage2 import audio_stage2
from ld_decode_tpu_torch.utils.device import DEFAULT as DEFAULT_DEVICE
from ld_decode_tpu_torch.utils.device import resolve as resolve_device
from ld_decode_tpu_torch.utils.params import DecoderConfig
from ld_decode_tpu_torch.vbi.philips import decode_philips_line, interpret_philips
from ld_decode_tpu_torch.ops import demod as D
from ld_decode_tpu_torch.ops.filters import DemodBank
from ld_decode_tpu_torch.tbc import burst as B
from ld_decode_tpu_torch.tbc import fused as FU
from ld_decode_tpu_torch.tbc import sync as S
from ld_decode_tpu_torch.tbc.cuda_resample import resample_lines_batch


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


# the reference surfaces a field it cannot number as an exception
UNNUMBERABLE = (KeyError, IndexError, TypeError, ValueError,
                ZeroDivisionError)


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

    def _put(self, a: np.ndarray) -> torch.Tensor:
        """A host table as a (1, n) tensor on the decoder's device."""
        return torch.from_numpy(np.ascontiguousarray(a))[None].to(self.device)

    def _put_locs(self, linelocs: np.ndarray):
        """float64 host line locations as the device's split (int32 line
        start, float32 fraction) tables, split as the JAX package splits
        them."""
        lli = np.floor(linelocs).astype(np.int32)
        return self._put(lli), self._put((linelocs - lli).astype(np.float32))

    # ---------------- device-side wrappers (sequential path) ----------------

    def demod(self, samples, mtf_level: float):
        """Demod one field window of stream_len samples (the loader's
        values, not recentred, as the JAX package passes them): video and
        audio taps, each (1, n) on the device."""
        if not isinstance(samples, torch.Tensor):
            samples = torch.from_numpy(np.asarray(samples).astype(np.float32))
        return D.demod_stream(samples.to(self.device, torch.float32)[None],
                              self.bank, self.cfg, self.nblocks, mtf_level)

    def sync_peaks(self, video) -> Tuple[np.ndarray, np.ndarray]:
        window = int(self.inlinelen * 0.4)
        idx, val = S.find_sync_peaks(video['demod_sync'], window)
        idx = idx[0].cpu().numpy()
        val = val[0].cpu().numpy()
        n = int((idx >= 0).sum())
        return idx[:n], val[:n]

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

    def _field_vsyncs(self, peaks, vals):
        """The window's vsyncs, next-field offset, parity and line count,
        or the invalid FieldResult the reference returns when the window
        holds no whole field (reference lddecode_core.py:889-957)."""
        cfg = self.cfg
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
        istop = bool(vsyncs[0][2])
        return (vsyncs, int(peaks[vsyncs[1][1] - 10]), istop,
                self.field_lines + (1 if istop else 0))

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

    def refine_linelocs_hsync(self, video, linelocs1, linebad):
        """hsync zero crossings on the device, the sequential repair on the
        host in float64 (reference lddecode_core.py:715-787)."""
        cfg = self.cfg
        ll = linelocs1.copy()
        starts = ll.copy()
        starts[:9] -= 200          # search for the *beginning* of hsync

        # the starts cross as float32, as the JAX package's do with x64 off
        starts_i, zc_rel, refined_rel, bad_dev, found = S.refine_hsync_zc(
            video['demod_05'], self._put(starts.astype(np.float32)),
            int(round(cfg.freq_mhz)), cfg.iretohz(-20), cfg.iretohz(-60),
            cfg.iretohz(20), cfg.iretohz(100), cfg.iretohz(-10),
            cfg.iretohz(10))
        starts_i = starts_i[0].cpu().numpy().astype(np.float64)
        zc = starts_i + zc_rel[0].cpu().numpy().astype(np.float64)
        refined = starts_i + refined_rel[0].cpu().numpy().astype(np.float64)
        bad_dev = bad_dev[0].cpu().numpy()
        found = found[0].cpu().numpy()

        ll2 = starts.copy()
        bad = linebad.copy()
        n = len(ll2)
        for i in range(n):
            if found[i] and not bad[i]:
                if i >= 10:
                    ll2[i] = refined[i]
                    if bad_dev[i]:
                        bad[i] = True
                else:
                    ll2[i] = zc[i]
            else:
                bad[i] = True
            if i < 10:
                ll2[i] += 4.72 * cfg.freq_mhz
            if i > 10 and bad[i]:
                ll2[i] = ll2[i - 1] + (ll2[i - 1] - ll2[i - 2])

        # end-of-range gap sanitizers (reference lddecode_core.py:769-785)
        lo = self.inlinelen - (cfg.freq_mhz * .2)
        hi = self.inlinelen + (cfg.freq_mhz * .2)
        for i in range(9, -1, -1):
            gap = ll2[i + 1] - ll2[i]
            if not (lo <= gap <= hi):
                gap = self.inlinelen
            ll2[i] = ll2[i + 1] - gap
        for i in range(n - 10, n):
            gap = ll2[i] - ll2[i - 1]
            if not (lo <= gap <= hi):
                gap = self.inlinelen
            ll2[i] = ll2[i - 1] + gap
        return ll2, bad

    def _resample(self, data: torch.Tensor, linelocs: np.ndarray,
                  nlines: int, **window) -> torch.Tensor:
        """Lines of one field through K1's dispatcher at B=1, from float64
        host locations."""
        return resample_lines_batch(data, *self._put_locs(linelocs),
                                    self.outlinelen, nlines,
                                    float(self.inlinelen), **window)[0]

    def refine_linelocs_burst(self, video, linelocs, linecount):
        """(reference lddecode_core.py:1054-1133).  The burst window is the
        resample's grid columns 16..63 (the positions of the JAX package's
        full-width call, ld_decode_tpu/tbc/resample.py:89-92), whose burst
        starts at column 4."""
        cfg = self.cfg
        scaled = self._resample(video['demod_burst'], linelocs, linecount,
                                col0=16, ncols=48)

        hz_ire = 1700000 / 140
        ph0, ph1, level, level_ok, counts_ok = B.burst_phase_offsets(
            scaled, hz_ire, win0=4)
        ph0 = ph0.cpu().numpy().astype(np.float64)
        ph1 = ph1.cpu().numpy().astype(np.float64)
        level = level.cpu().numpy().astype(np.float64)
        level_ok = level_ok.cpu().numpy()
        counts_ok = counts_ok.cpu().numpy()

        n = len(linelocs)
        phaseavg = np.zeros((n, 2))
        ok = level_ok & counts_ok
        phaseavg[:linecount, 0] = np.where(ok, ph0, 0.0)
        phaseavg[:linecount, 1] = np.where(ok, ph1, 0.0)
        burstlevel = np.zeros(n, np.float64)
        burstlevel[:linecount] = np.where(level_ok, level, 0.0)

        cut = phaseavg[(phaseavg[:, 0] != 0) | (phaseavg[:, 1] != 0)]
        if len(cut) == 0:
            return linelocs.copy(), burstlevel
        if abs(np.median(cut[:, 0])) < abs(np.median(cut[:, 1])):
            pg = 0
        else:
            pg = 1

        adjset = phaseavg[:, pg]
        burstlevel[pg::2] = -burstlevel[pg::2]

        ll3 = linelocs.copy()
        px_per_phase = cfg.freq_mhz / (4 * 315 / 88)
        for l in range(n):
            if abs(adjset[l]) > 2:
                burstlevel[l] = 0
                continue
            ll3[l] -= adjset[l] * px_per_phase
        for l in range(2, n - 1):
            if burstlevel[l] == 0:
                ll3[l] = (ll3[l - 1] + ll3[l + 1]) / 2
        return ll3, burstlevel

    def downscale_picture(self, video, linelocs, linecount, burstlevel):
        """Final wow-corrected resample, 16-bit scale and line-flag words
        (reference lddecode_core.py:789-812, 1135-1158), the scaling in
        float64 on the host as the JAX package's sequential path does it."""
        cfg = self.cfg
        lineoffset = 1 if cfg.system == 'NTSC' else 3
        out = self._resample(video['demod'], linelocs[lineoffset:],
                             linecount)
        dsout = out.cpu().numpy().astype(np.float64).reshape(-1)

        sp = cfg.sys
        reduced = (dsout - sp.ire0) / sp.hz_ire - sp.vsync_ire
        if cfg.system == 'NTSC':
            out_scale = float(0xc800 - 0x0400) / (100 - sp.vsync_ire)
            offset = 1024
        else:
            out_scale = float(0xd300 - 0x0100) / (100 - sp.vsync_ire)
            offset = 256
        lines16 = np.clip((reduced * out_scale) + offset, 0, 65535)
        lines16 = (lines16 + 0.5).astype(np.uint16)

        if burstlevel is not None:
            hz_ire_scale = 1700000 / 140
            clevel = (1 / self.colorlevel) / hz_ire_scale
            for i in range(1, linecount - 1):
                lines16[i * self.outlinelen] = 16384 if burstlevel[i] > 0 \
                    else 32768
                lines16[i * self.outlinelen + 1] = np.uint16(
                    327.67 * clevel * abs(burstlevel[i]))
        return lines16

    def decode_vbi(self, video, linelocs):
        """Philips code slicing on the configured VBI lines
        (reference lddecode_core.py:814-884).  The host slicer gets a host
        copy of each line's window; the window starts at int(linestart),
        so the slicer sees the positions the whole demod would give it."""
        cfg = self.cfg
        demod = video['demod'][0]
        span = cfg.linelen + int(16 * cfg.freq_mhz)
        linecode = {}
        for l in cfg.sys.philips_codelines:
            w0 = max(int(linelocs[l]), 0)
            w1 = max(min(w0 + span, demod.shape[0]), w0)
            linecode[l] = decode_philips_line(demod[w0:w1].cpu().numpy(),
                                              linelocs[l] - w0, cfg)
        return linecode, interpret_philips(linecode)

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
                         mtf_level: float = 0.0, audio_offset: float = 0.0,
                         full_decode: bool = True) -> Optional[FieldResult]:
        """One field: device analyze, host vsync/line numbering, device
        finish.  Returns None at EOF.  full_decode=False leaves out the
        picture and the audio; the line locations are the finish's, as in
        the JAX package."""
        cfg = self.cfg
        rv = self.analyze_resident(capture, readsample, mtf_level)
        if rv is None:
            return None
        video, audio, peaks, vals = rv
        fv = self._field_vsyncs(peaks, vals)
        if isinstance(fv, FieldResult):
            return fv
        vsyncs, nextfieldoffset, istop, linecount = fv
        try:
            linelocs1, linebad = self.compute_linelocs(peaks, vals, vsyncs,
                                                       linecount)
        except UNNUMBERABLE:
            return FieldResult(False, nextfieldoffset,
                               peak_count=len(peaks), vsync_count=len(vsyncs))

        n_audio1 = self.nblocks * self.bank.a_stage1_keep \
            if audio is not None else 0
        nmax = FU.max_nlines(cfg)
        ll1p, badp = FU.pad_linelocs(linelocs1, linebad, nmax, cfg.linelen)
        dev = self.device
        out = FU.field_finish(
            video, audio, *self._put_locs(ll1p), self._put(badp),
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
        if not full_decode:
            return result
        result.dspicture = data['picture'].reshape(-1)[
            :linecount * cfg.sys.outlinelen].astype(np.uint16)
        if audio is not None:
            nout = (int(data['audio_count']) - 1) * 2
            result.dsaudio = data['audio'][:nout]
            result.audio_next_offset = float(data['audio_next_offset'])
        return result

    # ---------------- the --batch 1 decode ----------------

    def process(self, samples, mtf_level: float = 0.0,
                audio_offset: float = 0.0,
                full_decode: bool = True) -> FieldResult:
        """Decode one field from `samples` (length stream_len(cfg,
        nblocks)): the JAX package's FieldDecoder.process (reference
        lddecode_core.py:889-957, 1165-1191, 1037-1048).  full_decode=False
        skips the burst or pilot passes, the picture and the audio: the
        line locations stay at the hsync stage."""
        cfg = self.cfg
        video, audio = self.demod(samples, mtf_level)
        peaks, vals = self.sync_peaks(video)
        fv = self._field_vsyncs(peaks, vals)
        if isinstance(fv, FieldResult):
            return fv
        vsyncs, nextfieldoffset, istop, linecount = fv
        try:
            linelocs1, linebad = self.compute_linelocs(peaks, vals, vsyncs,
                                                       linecount)
            linelocs2, linebad = self.refine_linelocs_hsync(video, linelocs1,
                                                            linebad)
        except UNNUMBERABLE:
            return FieldResult(False, nextfieldoffset,
                               peak_count=len(peaks), vsync_count=len(vsyncs))

        burstlevel = None
        if not full_decode:
            linelocs = linelocs2
        elif cfg.system == 'NTSC':
            ll3, burstlevel = self.refine_linelocs_burst(video, linelocs2,
                                                         linecount)
            ll4, burstlevel = self.refine_linelocs_burst(video, ll3,
                                                         linecount)
            shift33 = self.colorphase * (np.pi / 180)
            px_per_phase = cfg.freq_mhz / (4 * 315 / 88)
            linelocs = ll4 + (shift33 - 8) * px_per_phase
        else:
            from ld_decode_tpu_torch.tbc import pal as PALK
            li2, lf2 = PALK.refine_pilot(
                video['demod'], video['demod_05'],
                *self._put_locs(linelocs2), cfg.linelen, cfg.freq_mhz)
            linelocs = (li2[0].cpu().numpy().astype(np.float64)
                        + lf2[0].cpu().numpy().astype(np.float64))

        linecode, vbi = self.decode_vbi(video, linelocs)

        result = FieldResult(
            True, nextfieldoffset, istop=istop, linecount=linecount,
            tbcstart=nextfieldoffset, peak_count=len(peaks),
            vsync_count=len(vsyncs), linelocs=linelocs,
            burstlevel=burstlevel, vbi=vbi, linecode=linecode)
        if not full_decode:
            return result
        result.dspicture = self.downscale_picture(video, linelocs, linecount,
                                                  burstlevel)
        if audio is not None:
            n1 = audio['audio_left'].shape[-1]
            l2, r2 = audio_stage2(audio['audio_left'], audio['audio_right'],
                                  self.bank, n1)
            a2 = {'audio_left': l2[0].cpu().numpy(),
                  'audio_right': r2[0].cpu().numpy()}
            result.dsaudio, result.audio_next_offset = downscale_audio(
                a2, linelocs, cfg, linecount, audio_offset)
        return result
