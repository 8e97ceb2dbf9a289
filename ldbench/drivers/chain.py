"""The `chain` entry: ldchain_torch.py's loop as that CLI builds it at `-F`.

`Framer(cfg, bank, loader, batch, segment_samples, fetch_picture=False)`
over the port's own .lds loader reading the benchmark's stream, graphs on:
the pictures stay on the card and the Framer weaves each frame there (a
host weave for a pair that crosses a segment swap).  Each frame goes to
`CombWindows(NTSCCombBatch(CombConfig(dim=3, opticalflow=False)), 8, 3)`
at the configuration's comb settings (`comb`: the CLI's defaults), the
comb's window loop (8 frames a window, 3 windows whose RGB48 is still
on its way to the host), and the frame's audio through `CXExpander`, in
the CLI's order.  `frame()` returns the next RGB frame on the host with
its line-0 words and its CX audio: the window's frame gaps are the gaps a
viewer of the RGB sees.  At dim 3 without flow the ring emits every frame
but the stream's first, in order, a window of frames after it decodes.

The entry's comparison (`Driver.judge`, on `ldbench/reference/comb.py` and
the decode's reference), its numbers keyed as the decode's are (the
harness holds every cell to the same four names):
  * every RGB frame of the window: its CAV number (line-0 words 14-15)
    against the source's at the place its fields were decoded, and its
    place the next frame of the source after the frame before it; its
    shape (480, 744, 3) uint16; its CX block as long as its audio;
  * the sampled frames' fields: parity and line count the source's, and
    their line locations against the reference's from line 10 on
    (`lineloc_px`, the largest distance; `lineloc_p99_px`), as the
    decode's judge holds them;
  * every window's AGC carry, from the stream's first, against the
    reference's float64 chain over the burst columns the port read;
  * every field's audio carry against the reference's chain;
  * the sampled frames' burst words (columns 0 and 1 of each field's rows
    1 to linecount - 2, which the decode's judge skips) against the
    reference's burst pass at the port's line locations
    (`reference/comb.py::BurstWords`): every phase flag equal, every level
    within BURST_REL of the reference's;
  * the sampled frames' RGB against the reference's: frames e-1, e, e+1
    demodulated and resampled at the port's line locations, woven, with
    frame e's burst words as the port wrote them (checked above), combed
    from the reference's AGC carry entering e: `picture_lsb`, the 99th
    percentile of the differences over the sampled frames' RGB; a frame
    whose largest difference is over RGB_LSB fails;
  * the sampled frames' CX audio against the reference CX run over every
    frame's audio from the first (`audio_p99_lsb`, the 99th percentile).
The control is the reference at the traffic's lower precision in the
program's place: its decode, its comb from its own AGC chain, its CX.
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ldbench import comb_yardstick as CY
from ldbench.harness import Verdict
from ldbench.reference import judge as J
from ldbench.reference.comb import BurstWords, CombReference, CXReference
from ldbench.reference.decode import Reference, weave

# the port's AGC runs in float32, whose update by 1 % of the difference
# stalls up to 50 ulps (6e-6) from the float64 level
AGC_REL = 1e-5
# the decode's second burst pass measures a line's level before it moves
# the line by its own phase estimate, a few hundredths of a sample that its
# final locations no longer show; the level, the largest of 40 noisy
# samples, moves with them: up to 0.8 % on a CPU tile, 0.80-0.93 % over
# 7 seeds on an H100, against 9 % for levels scaled by 1 / 1.1
BURST_REL = 0.02
# Split2D's 3x-dominance switch flips a pixel's chroma by up to about 6,000
# LSB where the two decodes' samples differ by 1-4 LSB (identical inputs
# agree to 1 LSB): the port's largest over 20 seeds on an H100 was 1619,
# the bfloat16 control's smallest 65535
RGB_LSB = 16384
RGB_SHAPE = (480, 744, 3)


class EndOfSide(RuntimeError):
    """The decode reached the end of the side (the source is too short
    for the run)."""


@dataclass
class FieldMark:
    """Where a field was decoded: its window's first sample, parity, line
    count and line locations (float64, in its window's coordinates)."""
    readsample: int
    istop: bool
    linecount: int
    linelocs: np.ndarray


@dataclass
class ChainOut:
    """One RGB frame as the chain delivered it."""
    rgb: np.ndarray                      # (480, 744, 3) uint16
    words: np.ndarray                    # its 16 line-0 words
    cx: Optional[np.ndarray]             # its frame's CX audio (uint16)
    audio_len: int                       # the samples fed to CX
    index: int                           # the frame decoded, from 0
    ring: Tuple[Tuple[FieldMark, FieldMark], ...]  # frames index-1..+1


class Driver:
    def __init__(self, cell: dict, src, device):
        from ld_decode_tpu_torch.audio.cx import CXExpander
        from ld_decode_tpu_torch.comb import batch as TB
        from ld_decode_tpu_torch.comb.comb_ntsc import CombConfig
        from ld_decode_tpu_torch.io import loaders as L
        from ld_decode_tpu_torch.ops import filters as F
        from ld_decode_tpu_torch.tbc import framer as FR
        from ld_decode_tpu_torch.utils.params import DecoderConfig
        traffic, conf = cell['traffic'], cell['config']
        self.src = src
        self.traffic = traffic
        self.cfg = DecoderConfig(system=conf['system'],
                                 freq_mhz=conf['freq_mhz'])
        bank = F.make_demod_bank(self.cfg, dtype=np.complex64, device=device)
        self.loader_seconds = 0.0
        self.loader_calls = 0
        load = L.loader_for_path('capture.lds')

        def loader(infile, sample, readlen):
            t0 = time.perf_counter()
            with torch.profiler.record_function('ldbench.loader'):
                out = load(infile, sample, readlen)
            self.loader_seconds += time.perf_counter() - t0
            self.loader_calls += 1
            return out

        loader.total_samples = src.total_samples
        self.batch = max(int(traffic['batch']), 2)
        self.framer = FR.Framer(
            self.cfg, bank, loader, batch=self.batch,
            segment_samples=int(traffic['segment_mb']) * (1 << 20) // 2,
            device=device, fetch_picture=False,
            graphs=bool(traffic['graphs']))
        self.comb = TB.NTSCCombBatch(
            CombConfig(dim=int(traffic['dim']),
                       opticalflow=bool(traffic['opticalflow']),
                       wide=int(traffic['width']) == 910, **conf['comb']),
            out8=False, device=device, graphs=self.framer.graphs)
        self.windows = TB.CombWindows(self.comb, int(traffic['comb_batch']),
                                      int(traffic['depth']), self._emit)
        self.cx = CXExpander(device=device) if traffic['cx'] else None

        # the AGC's round trips: (the carry entering the window, the first
        # frame it combs, the frames' columns 0 and 1 as uint16)
        self.agc_windows: List[Tuple[float, int, np.ndarray]] = []
        self._tb = TB
        self._burst_levels = TB.burst_levels
        TB.burst_levels = self._logged_levels
        # every field read from the first: (its audio carry, its line
        # count, whether it advanced the carry)
        self.carries: List[Tuple[float, int, bool]] = []
        framer = self.framer
        readfield = framer.readfield

        def logged(infile, sample):
            off = framer.audio_offset
            f, rs, ns = readfield(infile, sample)
            if f is not None:
                self.carries.append((float(off), int(f.linecount), bool(
                    f.valid and f.dsaudio is not None)))
            return f, rs, ns

        framer.readfield = logged
        self.audio: List[Optional[np.ndarray]] = []   # every frame's, pre-CX
        self._frames: Dict[int, tuple] = {}   # decoded, not yet emitted
        self._ready: deque = deque()           # RGB on the host, in order
        self.decoded = 0
        self.emitted = 0
        self._combed = 1        # the first frame the next AGC round combs
        spf = int(self.cfg.freq_hz / self.cfg.sys.fps) + 1
        self.sample = src.start_frame * spf
        self.first = True

    # --------------------------------------------------------------- hooks

    def _logged_levels(self, frames, aburstlev, cfg):
        out = self._burst_levels(frames, aburstlev, cfg)
        # after the port's own round trip: the columns are on the host
        cols = frames[:, :, :2].cpu().numpy().astype(np.uint16)
        self.agc_windows.append((float(aburstlev), self._combed, cols))
        self._combed += cols.shape[0]
        return out

    def _emit(self, rgb: np.ndarray, words: np.ndarray):
        self._ready.append((rgb, words))

    def _decode(self):
        """Decode the next frame, hand it to the comb's window loop and its
        audio to CX, as ldchain_torch.py does."""
        with torch.profiler.record_function('ldbench.readframe'):
            combined, audio, nxt, fields = self.framer.readframe(
                self.src, self.sample, self.first)
        if combined is None:
            raise EndOfSide(f'the decode reached the end of the side at '
                            f'sample {self.sample}')
        self.first = False
        self.sample = nxt
        k = self.decoded
        self.decoded += 1
        marks = tuple(FieldMark(
            int(f.readsample if f.readsample >= 0 else -1), bool(f.istop),
            int(f.linecount), np.asarray(f.linelocs, np.float64).copy())
            for f in fields)
        self.windows.push(combined.reshape(self.cfg.sys.frame_lines,
                                           self.cfg.sys.outlinelen))
        pcm = None if audio is None else np.asarray(audio).ravel()
        out = None
        if pcm is not None and self.cx is not None:
            out = self.cx.process(pcm)
        self.audio.append(pcm)
        self._frames[k] = (marks, out, 0 if pcm is None else len(pcm))

    def frame(self) -> ChainOut:
        """The next RGB frame on the host; raises EndOfSide at the side's
        end."""
        while not self._ready:
            self._decode()
        rgb, words = self._ready.popleft()
        e = self.emitted + 1
        self.emitted += 1
        marks, cx, n = self._frames[e]
        ring = tuple(self._frames[k][0] for k in (e - 1, e, e + 1))
        self._frames.pop(e - 1, None)
        return ChainOut(rgb, np.asarray(words), cx, n, e, ring)

    def warm_up(self, frames_after_swap: int) -> int:
        """Run until the first segment swap has come and gone and
        `frames_after_swap` RGB frames more: the batch call's, the weave's
        and the comb window's graphs are captured.  Returns the RGB frames
        delivered."""
        n = 0
        after = 0
        while after < frames_after_swap:
            self.frame()
            n += 1
            if self.loader_calls >= 2:
                after += 1
        return n

    def label_layers(self):
        """Name the prefetcher's dispatch and fetch, the segment swap, the
        comb's feeds and collects and CX in the trace, and keep the
        trace's launches for the comb's readers (a traced run only)."""
        fr = self.framer
        pf = fr.prefetcher
        for obj, name, label in ((pf, '_dispatch', 'ldbench.dispatch'),
                                 (pf, '_fetch_entries', 'ldbench.fetch'),
                                 (fr, '_ensure_segment', 'ldbench.segment'),
                                 (self.comb, 'feed', 'ldbench.comb'),
                                 (self.comb, 'collect', 'ldbench.comb'),
                                 (self.cx, 'process', 'ldbench.cx')):
            if obj is None:
                continue
            fn = getattr(obj, name)

            def wrapped(*a, _fn=fn, _label=label, **kw):
                with torch.profiler.record_function(_label):
                    return _fn(*a, **kw)

            setattr(obj, name, wrapped)
        CY.keep_trace_events()

    def counters(self) -> Dict[str, float]:
        """The program's counters that the per-layer metrics read."""
        fr = self.framer
        st = fr.prefetcher.stats
        cs = self.comb.stats
        graphs = sum(c.counts['eager_warmups'] + c.counts['captures']
                     for c in (fr.graphs, fr.weave_graphs))
        return {'batches': st['batches'], 't_fetch': st['t_fetch'],
                'loader_seconds': self.loader_seconds,
                'source_seconds': self.src.seconds,
                'graph_builds': graphs, 'batch': self.batch,
                'frames_decoded': self.decoded, 'rgb_frames': self.emitted,
                'comb_windows': cs['windows'], 'comb_t_feed': cs['t_feed'],
                'comb_t_collect': cs.get('t_collect', 0.0),
                'comb_frames_fed': cs.get('frames_fed', 0),
                'comb_frames_emitted': cs.get('frames_emitted', 0),
                'comb_batch': int(self.traffic['comb_batch'])}

    def mark(self, out: ChainOut):
        """What the judge checks of every frame: the CAV number its words
        carry, where its top field was decoded, and whether its shape and
        its CX block's length are the chain's."""
        w = out.words.astype(np.int64)
        top = out.ring[1][0]
        shape_ok = out.rgb.dtype == np.uint16 and out.rgb.shape == RGB_SHAPE
        cx_ok = out.cx is None or len(out.cx) == out.audio_len
        return (int(w[14] << 16 | w[15]), top.readsample,
                float(top.linelocs[0]), shape_ok, cx_ok)

    def notes(self) -> dict:
        return {'agc': list(self.agc_windows), 'audio': list(self.audio),
                'carries': list(self.carries)}

    def release(self):
        self._tb.burst_levels = self._burst_levels
        self.framer = self.comb = self.windows = self.cx = None
        self._frames.clear()
        self._ready.clear()

    # --------------------------------------------------------------- judge

    @staticmethod
    def judge(cell: dict, src, device, marks, sampled: List[ChainOut],
              notes: dict, control: bool) -> Verdict:
        conf = cell['config']
        ref = Reference(conf, device)
        settings = _comb_settings(conf)
        reasons: List[str] = []
        failed = 0

        def fault(msg):
            if len(reasons) < 8:
                reasons.append(msg)

        # every RGB frame: its number, its place, its shape, its CX block
        L = ref.cfg.sys.frame_lines
        last = None
        for i, (nr, rs, first, shape_ok, cx_ok) in enumerate(marks):
            line, _ = J.field_line(ref, rs, first)
            want = src.frame_number(line // L)
            bad = []
            if nr != want:
                bad.append(f'number {nr}, the source has {want}')
            if last is not None and line // L != last + 1:
                bad.append(f'source frame {line // L} after {last}')
            if not shape_ok:
                bad.append('RGB of another shape or type')
            if not cx_ok:
                bad.append('CX block of another length than its audio')
            last = line // L
            if bad:
                failed += 1
                fault(f'RGB frame {i}: ' + '; '.join(bad))

        _, carry_faults = J.audio_carries(ref.cfg, notes['carries'])
        if carry_faults:
            failed += len(carry_faults)
            fault(f'{len(carry_faults)} fields started at another audio '
                  f'carry than the reference chains')

        # the AGC: every window's carry against the float64 chain
        comb = CombReference(device, **settings)
        into, cols, agc_faults = _agc(comb, notes['agc'])
        for w, (got, want) in agc_faults[:3]:
            fault(f'comb window {w}: AGC carry {got!r}, the reference '
                  f'{want!r}')
        failed += len(agc_faults)

        sample = [o for o in sampled if o.index in into]
        wanted = {o.index for o in sample}
        burst = BurstWords(ref)
        worst = 0.0
        for o in sample:
            flags, rel = _burst_faults(burst, src, o, cols[o.index])
            worst = max(worst, rel)
            if flags or rel > BURST_REL:
                failed += 1
                fault(f'RGB frame {o.index}: {flags} burst flags other '
                      f'than the reference\'s, levels off by up to '
                      f'{rel:.4f} of it')
        judge = J.Judge(ref, src)
        # the sampled frames' fields: parity, line count, line locations
        truth = {}
        for o in sample:
            bad = []
            for k, f in enumerate(o.ring[1]):
                truth[o.index, k], wrong = _truth(ref, judge.window, f)
                if wrong:
                    bad.append(wrong)
            if bad:
                failed += 1
                fault(f'RGB frame {o.index}: ' + '; '.join(bad))
        locs = [_loc_diffs(o.ring[1][k].linelocs, truth[o.index, k],
                           o.ring[1][k].linecount)
                for o in sample for k in (0, 1)]
        rgb_want = [comb.frame(*_ring_frames(ref, judge, src, o, cols)[0],
                               comb.agc(cols[o.index][:, 1],
                                        into[o.index])[0])
                    for o in sample]
        cx_want = _cx_run(CXReference(), notes['audio'], wanted)
        numbers, rgb_max = _numbers(sample, locs, [o.rgb for o in sample],
                                    rgb_want, [o.cx for o in sample],
                                    cx_want)
        for o, m in zip(sample, rgb_max):
            if m > RGB_LSB:
                failed += 1
                fault(f'RGB frame {o.index}: {m:.0f} LSB off the '
                      f'reference\'s at a pixel')

        ctl = None
        if control:
            prec = cell['traffic']['control']
            cref = Reference(conf, device, precision=prec)
            ccomb = CombReference(device, prec, **settings)
            cinto, _, _ = _agc(ccomb, notes['agc'])
            crgb, clocs = [], []
            for o in sample:
                frames, mid = _ring_frames(cref, None, src, o, cols)
                crgb.append(ccomb.frame(*frames, ccomb.agc(
                    cols[o.index][:, 1], cinto[o.index])[0]))
                clocs += [_loc_diffs(ll, truth[o.index, k],
                                     o.ring[1][k].linecount)
                          for k, ll in enumerate(mid)]
            ccx = _cx_run(CXReference(prec), notes['audio'], wanted)
            cnumbers, cmax = _numbers(sample, clocs, crgb, rgb_want,
                                      [ccx.get(o.index) for o in sample],
                                      cx_want)
            ctl = Verdict(cnumbers, sum(m > RGB_LSB for m in cmax),
                          len(sample), extras={'rgb_lsb': max(cmax,
                                                              default=0.0)})
        return Verdict(numbers, failed, len(sample), reasons,
                       {'agc_windows': len(notes['agc']),
                        'frames_audio': len(notes['audio']),
                        'burst_rel_max': worst,
                        'rgb_lsb': max(rgb_max, default=0.0)}, ctl)


def _comb_settings(conf: dict) -> dict:
    """The configuration's comb settings as the reference takes them; the
    reference makes no chroma noise reduction."""
    settings = dict(conf['comb'])
    if settings.pop('nr_c'):
        raise ValueError('the reference comb makes chroma NR at 0 only')
    return settings


def _truth(ref: Reference, window, f: FieldMark) -> Tuple[np.ndarray, str]:
    """(the reference's line locations of the field the port decoded at
    `f`, what of its parity or line count is not the source's)."""
    cfg = ref.cfg
    line, top = J.field_line(ref, f.readsample, f.linelocs[0])
    wrong = ''
    if top != f.istop or f.linecount != cfg.sys.frame_lines // 2 + int(top):
        wrong = (f'field at {f.readsample}: istop {f.istop} lc '
                 f'{f.linecount}, the source has istop {top}')
    truth, _ = ref.linelocs(window(f.readsample), line, f.readsample,
                            len(f.linelocs))
    return truth, wrong


def _loc_diffs(linelocs, truth: np.ndarray, linecount: int) -> np.ndarray:
    """The distances of a field's line locations from the reference's, over
    its lines from 10 on (the decode's judge's span)."""
    hi = min(linecount, len(truth))
    return np.abs(np.asarray(linelocs, np.float64)[J.FIRST_LINE:hi]
                  - truth[J.FIRST_LINE:hi])


def _agc(comb: CombReference, windows):
    """(the reference's carry entering every frame the port combed, each
    frame's columns 0 and 1, the windows whose carry was another as
    (window, (the port's, the reference's)))."""
    into: Dict[int, float] = {}
    cols: Dict[int, np.ndarray] = {}
    faults = []
    c = -1.0
    for w, (got, first, block) in enumerate(windows):
        if abs(got - c) > AGC_REL * abs(c):
            faults.append((w, (got, c)))
        for j, col in enumerate(block):
            into[first + j] = c
            cols[first + j] = col
            _, c = comb.agc(col[:, 1], c)
    return into, cols, faults


def _burst_faults(burst: BurstWords, src, out: ChainOut, cols: np.ndarray
                  ) -> Tuple[int, float]:
    """(the burst flags of frame `out` other than the reference's, its
    levels' largest distance from the reference's, over the reference's
    level plus 1 LSB) over its fields' word rows; `cols` the frame's
    columns 0 and 1 as the port wrote them."""
    cfg = burst.ref.cfg
    W, L = cfg.sys.outlinelen, cfg.sys.frame_lines
    top, bottom = out.ring[1]
    rows, marks = [], []
    for f in (top, bottom):
        words = burst.words(burst.levels(burst.tap(src, f.readsample),
                                         f.linelocs, f.linecount))
        r = np.zeros((f.linecount, W), np.uint16)
        m = np.zeros((f.linecount, W), np.uint16)
        r[1:-1, :2] = words
        m[1:-1, :2] = 1
        rows.append(r.ravel())
        marks.append(m.ravel())
    want = weave(cfg, rows[0], top.linecount, rows[1], bottom.linecount
                 ).reshape(L, W)[:, :2].astype(np.float64)
    on = weave(cfg, marks[0], top.linecount, marks[1], bottom.linecount
               ).reshape(L, W)[:, 0].astype(bool)
    got = np.asarray(cols, np.float64)[on]
    want = want[on]
    flags = int((got[:, 0] != want[:, 0]).sum())
    rel = float((np.abs(got[:, 1] - want[:, 1]) / (want[:, 1] + 1)).max())
    return flags, rel


def _ring_frames(ref: Reference, judge: Optional[J.Judge], src,
                 out: ChainOut, cols
                 ) -> Tuple[List[np.ndarray], List[np.ndarray]]:
    """(frames index-1, index, index+1 of `out` as the reference decodes
    them (at the port's line locations with `judge`, at its own without:
    the control), woven, frame `index` with the burst columns the port
    read; the line locations of frame `index`'s two fields)."""
    cfg = ref.cfg
    frames, locs = [], []
    for top, bottom in out.ring:
        rows, at = [], []
        for f in (top, bottom):
            if judge is not None:
                win = judge.window(f.readsample)
                ll = f.linelocs
            else:
                win = ref.window(src, f.readsample)
                line, _ = J.field_line(ref, f.readsample, f.linelocs[0])
                ll, _ = ref.linelocs(win, line, f.readsample,
                                     len(f.linelocs))
            rows.append(ref.picture(win.video, ll, f.linecount))
            at.append(ll)
        locs.append(at)
        frames.append(weave(cfg, rows[0], top.linecount, rows[1],
                            bottom.linecount).reshape(
                                cfg.sys.frame_lines, cfg.sys.outlinelen))
    frames[1][:, :2] = cols[out.index]
    return frames, locs[1]


def _cx_run(cx: CXReference, audio, wanted) -> Dict[int, np.ndarray]:
    """The reference CX over every frame's audio from the first, in order;
    the outputs of the frames in `wanted`."""
    out = {}
    end = max(wanted, default=-1)
    for k, pcm in enumerate(audio[:end + 1]):
        if pcm is not None:
            y = cx.process(pcm)
            if k in wanted:
                out[k] = y
    return out


def _numbers(sample, locs, rgb_got, rgb_want, cx_got, cx_want
             ) -> Tuple[Dict[str, float], List[float]]:
    """(the verdict's numbers over the sampled frames, each frame's largest
    RGB difference)."""
    rgb, cx, worst = [], [], []
    for o, g, w, c in zip(sample, rgb_got, rgb_want, cx_got):
        d = np.abs(np.asarray(g).astype(np.int64)
                   - w.astype(np.int64)).ravel()
        rgb.append(d)
        worst.append(float(d.max()))
        if c is not None and o.index in cx_want:
            want = cx_want[o.index]
            n = min(len(c), len(want))
            cx.append(np.abs(np.asarray(c[:n]).astype(np.int64)
                             - want[:n].astype(np.int64)))
    ll = np.concatenate(locs) if locs else np.zeros(1)
    d = np.concatenate(rgb) if rgb else np.zeros(1, np.int64)
    a = np.concatenate(cx) if cx else np.zeros(1, np.int64)
    return {'lineloc_px': float(ll.max()),
            'lineloc_p99_px': float(np.percentile(ll, 99)),
            'picture_lsb': float(np.percentile(d, 99)),
            'audio_p99_lsb': float(np.percentile(a, 99))}, worst
