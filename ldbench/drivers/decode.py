"""The `decode` entry: lddecode_torch.py's loop as that CLI builds it.

`Framer(cfg, bank, loader, batch, segment_samples)` over the port's own .lds
loader (`io/loaders.py::load_packed_4_40`, the C++ unpack where it builds)
reading the benchmark's stream, graphs on, `pic_mode` as the traffic file
says (the CLI's `auto`), from the frame of the side the seed picked; each
`readframe` hands the frame's .tbc picture and .pcm audio, on the host, to
a sink that counts them.

The entry's comparison (`Driver.judge`): every frame's CAV number against
the source's, every field's audio carry against the reference's chain, and
the sampled frames' line locations, woven picture and audio against the
plain float64 reference (`ldbench/reference/judge.py`).
"""

from __future__ import annotations

import time
from typing import Dict, List, Tuple

import numpy as np
import torch

from ldbench.harness import Verdict
from ldbench.reference import judge as J
from ldbench.reference.decode import FieldOut, Reference
from ldbench.reference.judge import FrameOut


class EndOfSide(RuntimeError):
    """The decode reached the end of the side (the source is too short
    for the run)."""


class Driver:
    def __init__(self, cell: dict, src, device):
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
        seg = int(traffic['segment_mb']) * (1 << 20) // 2
        self.framer = FR.Framer(self.cfg, bank, loader,
                                batch=int(traffic['batch']),
                                segment_samples=seg, device=device,
                                pic_mode=traffic['pic_mode'],
                                graphs=bool(traffic['graphs']))
        self.batch = int(traffic['batch'])
        # each field the framer reads in this frame, with the 48 kHz carry
        # it started at and its place among all the fields read
        self._read: List[Tuple[object, float, int, int]] = []
        # every field read from the first: (its carry, its line count,
        # whether it advanced the carry), for the reference's carry chain
        self.carries: List[Tuple[float, int, bool]] = []
        framer = self.framer
        readfield = framer.readfield

        def logged(infile, sample):
            off = framer.audio_offset
            f, rs, ns = readfield(infile, sample)
            if f is not None:
                self._read.append((f, off, rs, len(self.carries)))
                self.carries.append((float(off), int(f.linecount), bool(
                    f.valid and f.dsaudio is not None)))
            return f, rs, ns

        framer.readfield = logged
        self.fields_read = 0
        spf = int(self.cfg.freq_hz / self.cfg.sys.fps) + 1
        self.sample = src.start_frame * spf
        self.first = True

    def label_layers(self):
        """Name the prefetcher's dispatch and fetch and the segment swap in
        the trace (a traced run only)."""
        fr = self.framer
        pf = fr.prefetcher
        for obj, name, label in ((pf, '_dispatch', 'ldbench.dispatch'),
                                 (pf, '_fetch_entries', 'ldbench.fetch'),
                                 (fr, '_ensure_segment', 'ldbench.segment')):
            fn = getattr(obj, name)

            def wrapped(*a, _fn=fn, _label=label, **kw):
                with torch.profiler.record_function(_label):
                    return _fn(*a, **kw)

            setattr(obj, name, wrapped)

    def frame(self) -> FrameOut:
        """Decode the next frame; raises EndOfSide at the side's end."""
        self._read.clear()
        with torch.profiler.record_function('ldbench.readframe'):
            combined, audio, nxt, fields = self.framer.readframe(
                self.src, self.sample, self.first)
        if combined is None:
            raise EndOfSide(f'the decode reached the end of the side at '
                            f'sample {self.sample}')
        self.first = False
        self.sample = nxt
        read = list(self._read)
        self._read.clear()
        self.fields_read += len(read)
        outs = {}
        for f, off, rs, k in read:
            outs[id(f)] = _field_out(f, off, rs, k)
        pic = tuple(outs.get(id(f)) or _field_out(f, 0.0, -1, -1)
                    for f in fields)
        return FrameOut(combined, audio, pic,
                        [outs[id(f)] for f, _, _, _ in read],
                        self.framer.vbi.get('framenr'))

    def warm_up(self, frames_after_swap: int) -> int:
        """Decode until the first segment swap has come and gone and
        `frames_after_swap` frames more: every shape of the window (the
        batch call's graph, the sequential first field of a segment, the
        picture copy) is warm.  Returns the frames decoded."""
        n = 0
        after = 0
        while after < frames_after_swap:
            self.frame()
            n += 1
            if self.loader_calls >= 2:
                after += 1
        self._read.clear()
        return n

    def counters(self) -> Dict[str, float]:
        """The program's counters that the per-layer metrics read."""
        fr = self.framer
        st = fr.prefetcher.stats
        graphs = sum(c.counts['eager_warmups'] + c.counts['captures']
                     for c in (fr.graphs, fr.weave_graphs))
        return {'batches': st['batches'], 't_fetch': st['t_fetch'],
                'refills': st['refills'], 'flushes': st['flush_sample']
                + st['flush_mtf'] + st['flush_audio'] + st['flight_flush'],
                'seq_fallback': st['seq_fallback'],
                'fields_read': self.fields_read,
                'loader_seconds': self.loader_seconds,
                'source_seconds': self.src.seconds,
                'graph_builds': graphs, 'batch': self.batch}

    def mark(self, out: FrameOut) -> Tuple[int, float, object]:
        """Where the frame's top field lies and the frame's number: what
        the judge checks of every frame of the window."""
        top = out.picture_fields[0]
        return top.readsample, float(top.linelocs[0]), out.framenr

    def notes(self) -> List[Tuple[float, int, bool]]:
        """Every field read from the first, for the reference's carry
        chain."""
        return list(self.carries)

    def release(self):
        self.framer = None
        self._read.clear()

    @staticmethod
    def judge(cell: dict, src, device, marks, sampled: List[FrameOut],
              carries, control: bool) -> Verdict:
        """The window's frame numbers (`marks`) and audio carries
        (`carries`, `notes`' list) and the sampled frames against the
        reference; with `control`, the control (the reference at the
        traffic's lower precision) in the decode's place on the same
        frames."""
        conf = cell['config']
        ref = Reference(conf, device)
        ref_carries, carry_faults = J.audio_carries(ref.cfg, carries)
        judge = J.Judge(ref, src, ref_carries)
        verdict = J.Judgement()
        wrong_numbers = 0
        for i, (rs, first, nr) in enumerate(marks):
            want = J.frame_number_truth(ref, src, rs, first)
            if nr != want:
                wrong_numbers += 1
                if wrong_numbers <= 3:
                    verdict.reasons.append(f'frame {i}: number {nr}, the '
                                           f'source has {want}')
        if carry_faults:
            k = carry_faults[0]
            verdict.reasons.append(
                f'{len(carry_faults)} fields started at another audio carry '
                f'than the field before them gives: field {k} at '
                f'{carries[k][0]!r}, the reference {float(ref_carries[k])!r}')
        for k, out in enumerate(sampled):
            judge.frame(out, verdict, f'sampled frame {k}')
        ctl = None
        if control:
            cref = Reference(conf, device,
                             precision=cell['traffic']['control'])
            cj = J.Judgement()
            for k, out in enumerate(sampled):
                judge.frame(J.control_frame(cref, src, out, judge), cj,
                            f'control frame {k}')
            ctl = Verdict(cj.numbers(), cj.failed, cj.frames, cj.reasons)
        return Verdict(
            verdict.numbers(),
            verdict.failed + wrong_numbers + len(carry_faults),
            verdict.frames, verdict.reasons,
            {'far_lines': verdict.far_lines,
             'unmoved_lines': verdict.unmoved_lines,
             'worst': verdict.worst_line}, ctl)


def _field_out(f, offset: float, requested: int, index: int) -> FieldOut:
    rs = int(f.readsample) if f.readsample >= 0 else int(requested)
    return FieldOut(rs, bool(f.istop), int(f.linecount),
                    np.asarray(f.linelocs, np.float64),
                    f.dspicture, f.dsaudio, float(offset), index)
