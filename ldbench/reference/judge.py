"""The comparison that decides `correct`: a decode's frames against the plain
reference (`ldbench/reference/decode.py`).

For every frame of the sample (drawn from the seed among the frames the
window delivered), and for each of its fields:

  * `lineloc_px`: the largest distance of a line location from the
    reference's, over a field's lines from 10 to its last (the first lines
    lie in the field's own vertical interval, whose equalising pulses carry
    no line start), and `lineloc_p99_px`, the 99th percentile of those
    distances; `far_lines` counts the lines more than 1 px off, and
    `unmoved_lines` the PAL lines that the reference's pilot pass leaves at
    their hsync location (no usable pilot crossing);
  * `picture_lsb`: the largest difference of the woven frame from the
    reference's weave of its reference rows, over every sample but the 16
    line-0 metadata words and, in NTSC, the burst flag and level words of
    columns 0 and 1;
  * `audio_p99_lsb`: the 99th percentile of the differences of the analog
    audio samples (both channels) from the reference's.

A frame counts as failed where its frame number is not the source's, a
field's parity or line count is not the source's, a field's audio has
another length than the reference's, or the frame's audio is not its
fields' audio in the order they were read.

The audio's 48 kHz carry runs on from field to field: the reference works
out every field's carry from the one before it, from the decode's first
field on (`audio_carries`), and a field of the window that started at
another carry counts as failed (`carry_faults`); the reference's audio of
a field starts at the reference's carry.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from ldbench.reference.decode import FieldOut, Reference, weave

FIRST_LINE = 10
GAP = 1.0 / 48000.0
# a carry that differs by more is another carry (one tick is 2.08e-5 s;
# the decode's own float32 chain agrees with itself to 1e-7)
CARRY_TOL = 1e-7


@dataclass
class FrameOut:
    """One frame as a decode delivered it."""
    combined: np.ndarray                 # (frame_lines * W,) uint16
    audio: Optional[np.ndarray]          # int16 L/R of the fields read
    picture_fields: Tuple[FieldOut, FieldOut]    # (top, bottom)
    read_fields: List[FieldOut]          # every field read, in order
    framenr: Optional[int]


@dataclass
class Judgement:
    lineloc_diffs: List[np.ndarray] = field(default_factory=list)
    worst_line: str = ''
    picture_lsb: float = 0.0
    audio_diffs: List[np.ndarray] = field(default_factory=list)
    failed: int = 0
    reasons: List[str] = field(default_factory=list)
    frames: int = 0
    unmoved_lines: int = 0

    @property
    def lineloc_px(self) -> float:
        if not self.lineloc_diffs:
            return 0.0
        return float(np.concatenate(self.lineloc_diffs).max())

    @property
    def lineloc_p99_px(self) -> float:
        if not self.lineloc_diffs:
            return 0.0
        return float(np.percentile(np.concatenate(self.lineloc_diffs), 99))

    @property
    def far_lines(self) -> int:
        if not self.lineloc_diffs:
            return 0
        return int((np.concatenate(self.lineloc_diffs) > 1.0).sum())

    @property
    def audio_p99_lsb(self) -> float:
        if not self.audio_diffs:
            return 0.0
        return float(np.percentile(np.concatenate(self.audio_diffs), 99))

    def numbers(self) -> Dict[str, float]:
        return {'lineloc_px': self.lineloc_px,
                'lineloc_p99_px': self.lineloc_p99_px,
                'picture_lsb': self.picture_lsb,
                'audio_p99_lsb': self.audio_p99_lsb}


def field_line(ref: Reference, readsample: int, first: float
               ) -> Tuple[int, bool]:
    """(the stream line at which a field starts, whether that start is a
    top field's), from where the field's first line lies (`first`, in its
    window's coordinates)."""
    cfg = ref.cfg
    spl = cfg.sys.line_period * cfg.freq_mhz
    L = cfg.sys.frame_lines
    est = (readsample + first - ref.offset_px) / spl
    frame = int(np.floor(est / L + 0.25))
    bottom = L // 2
    starts = [(frame * L, True), (frame * L + bottom, False),
              ((frame + 1) * L, True)]
    line, top = min(starts, key=lambda s: abs(s[0] - est))
    return line, top


def next_carry(cfg, offset: float, linecount: int) -> float:
    """The 48 kHz carry after a field of `linecount` lines that started
    at `offset`: ld-decode's downscale_audio in float32, its order of
    operations."""
    f32 = np.float32
    sp = cfg.sys
    lc = sp.frame_lines // 2 + 1
    maxt = int(np.ceil(sp.line_period * lc / 1e6 * 48000.0)) + 8
    off = f32(offset)
    frametime = f32(f32(sp.line_period) * f32(linecount)) / f32(1e6)
    count = int(min(max(np.ceil(f32(f32(frametime + f32(GAP)) - off)
                                / f32(GAP)), 1), maxt))
    return float(f32(f32(off + f32(f32(count - 1) * f32(GAP))) - frametime))


def audio_carries(cfg, fields: List[Tuple[float, int, bool]]
                  ) -> Tuple[np.ndarray, List[int]]:
    """(the reference's carry of every field read, the fields whose
    decode started at another): `fields` are each field's (carry the decode
    started it at, line count, whether it advanced the carry) in the order
    the decode read them, from its first field, whose carry is 0."""
    out = np.zeros(len(fields))
    bad = []
    c = 0.0
    for k, (got, lc, advanced) in enumerate(fields):
        out[k] = c
        if abs(got - c) > CARRY_TOL:
            bad.append(k)
        if advanced:
            c = next_carry(cfg, c, lc)
    return out, bad


class Judge:
    def __init__(self, ref: Reference, src, carries=None):
        self.ref = ref
        self.src = src
        self.carries = carries
        self._windows: Dict[int, object] = {}

    def window(self, readsample: int):
        if readsample not in self._windows:
            self._windows[readsample] = self.ref.window(self.src, readsample)
        return self._windows[readsample]

    def carry(self, f: FieldOut) -> float:
        """The reference's carry of a field (its own where the harness gave
        the fields' chain)."""
        if self.carries is not None and f.index >= 0:
            return float(self.carries[f.index])
        return f.audio_offset

    def frame(self, out: FrameOut, j: Judgement, label: str):
        ref = self.ref
        cfg = ref.cfg
        W = cfg.sys.outlinelen
        j.frames += 1
        rows = []
        fail = []
        for f in out.picture_fields:
            line, top = field_line(ref, f.readsample, f.linelocs[0])
            if top != f.istop or f.linecount != cfg.sys.frame_lines // 2 \
                    + int(top):
                fail.append(f'field at {f.readsample}: istop {f.istop} '
                            f'lc {f.linecount}, the source has istop {top}')
            win = self.window(f.readsample)
            truth, um = ref.linelocs(win, line, f.readsample,
                                     len(f.linelocs))
            hi = min(f.linecount, len(truth))
            d = np.abs(f.linelocs[FIRST_LINE:hi] - truth[FIRST_LINE:hi])
            if d.size and (not j.lineloc_diffs or d.max() > j.lineloc_px):
                j.worst_line = (f'{label}, {"top" if f.istop else "bottom"}'
                                f' field, line {FIRST_LINE + int(d.argmax())}')
            j.lineloc_diffs.append(d)
            j.unmoved_lines += int(((um >= FIRST_LINE) & (um < hi)).sum())
            rows.append(ref.picture(win.video, f.linelocs, f.linecount))
        (top, bottom), (rt, rb) = out.picture_fields, rows
        expect = weave(cfg, rt, top.linecount, rb, bottom.linecount)
        got = out.combined.astype(np.int64).reshape(cfg.sys.frame_lines, W)
        exp = expect.astype(np.int64).reshape(cfg.sys.frame_lines, W)
        c0 = 2 if cfg.system == 'NTSC' else 0
        diff = np.abs(got[:, c0:] - exp[:, c0:])
        diff[0, :max(16 - c0, 0)] = 0
        j.picture_lsb = max(j.picture_lsb, float(diff.max()))

        # the frame's audio is its fields' audio in the order they were read
        parts = [f.audio for f in out.read_fields if f.audio is not None]
        if out.audio is not None and parts and not np.array_equal(
                out.audio, np.concatenate(parts)):
            fail.append('frame audio is not its fields\' audio')
        for f in out.read_fields:
            if f.audio is None:
                continue
            win = self.window(f.readsample)
            want = ref.audio(win.a2l, win.a2r, f.linelocs, f.linecount,
                             self.carry(f))
            if len(want) != len(f.audio):
                fail.append(f'field at {f.readsample}: {len(f.audio)} audio '
                            f'samples, the reference {len(want)}')
            n = min(len(want), len(f.audio))
            j.audio_diffs.append(np.abs(f.audio[:n].astype(np.int64)
                                        - want[:n].astype(np.int64)))
        if fail:
            j.failed += 1
            j.reasons.append(f'{label}: ' + '; '.join(fail))


def frame_number_truth(ref: Reference, src, readsample: int,
                       first: float) -> int:
    """The CAV picture number the source put on the frame whose top field
    starts there (`field_line`'s arguments)."""
    line, _ = field_line(ref, readsample, first)
    return src.frame_number(line // ref.cfg.sys.frame_lines)


def control_frame(ctl: Reference, src, out: FrameOut,
                  judge: Judge) -> FrameOut:
    """The control in the decode's place: the reference at its lower
    precision decodes the same fields, at the same positions, from the
    reference's carries."""
    made: Dict[int, FieldOut] = {}

    def one(f: FieldOut) -> FieldOut:
        if id(f) not in made:
            line, _ = field_line(ctl, f.readsample, f.linelocs[0])
            c = ctl.decode_field(src, f.readsample, line, f.istop,
                                 f.linecount, len(f.linelocs),
                                 judge.carry(f))
            c.index = f.index
            made[id(f)] = c
        return made[id(f)]

    top, bottom = (one(f) for f in out.picture_fields)
    read = [one(f) for f in out.read_fields]
    combined = weave(ctl.cfg, top.picture, top.linecount, bottom.picture,
                     bottom.linecount)
    audio = np.concatenate([f.audio for f in read]) if read else None
    return FrameOut(combined, audio, (top, bottom), read, out.framenr)

