"""The plain reference of a LaserDisc field decode, and its judge.

Plain PyTorch in float64 (on the card or the CPU), with no kernel, cache or
batch of the port: it imports nothing of `ld_decode_tpu_torch`.  The
filters are ld-decode's, designed by the frozen copy of the port's design
code (`ldbench/reference/filters.py`); the demodulation is the textbook
form of the same overlap-save arithmetic (whole complex spectra, not the
port's one-sided split).

What the reference computes for a field of the port's output:

  * its line locations: on this synthetic source the time base is known
    exactly (`ldbench/source/stream.py` puts line l of the stream at
    l times the line period).  NTSC's two burst passes lock a line to its
    colour burst, so the reference's location of an NTSC line is that time
    plus ld-decode's line-start convention, `lineloc_offset_px` of the
    configuration.  PAL's one damped pilot pass does not: the reference
    works out ld-decode's hsync stage and pilot pass again from its own
    demodulation (`ldbench/reference/tbc.py`), starting from the line's
    time plus the hsync stage's convention, `hsync_offset_px`;
  * its picture rows: the demodulated video of the field's decode window
    resampled at the port's own line locations (the outputs judged, as a
    served model's tokens are fed back to judge its logits), with the
    port's Catmull-Rom resample, wow amplitude correction and 16-bit scale;
    the weave of the two fields into the frame;
  * its analog audio: both carriers' two-stage FM demodulation and the
    48 kHz chase over the port's line locations from the carry offset the
    field started at.

`precision` 'float64' is the reference; 'bfloat16' is its control: the
same computation with every value rounded to bfloat16 after each step
(the transforms run in float32 between the roundings).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from ldbench.reference import filters as FD
from ldbench.reference import tbc as TBC
from ldbench.source.params import DecoderConfig

TAU = 2 * np.pi
NBLOCKS = 66


def unpack_4_40(raw: np.ndarray) -> np.ndarray:
    """5 bytes -> 4 10-bit samples, the .lds layout (plain numpy)."""
    b = raw[:len(raw) // 5 * 5].reshape(-1, 5).astype(np.uint16)
    out = np.empty((b.shape[0], 4), np.uint16)
    out[:, 0] = (b[:, 0] << 2) | (b[:, 1] >> 6)
    out[:, 1] = ((b[:, 1] & 0x3f) << 4) | (b[:, 2] >> 4)
    out[:, 2] = ((b[:, 2] & 0x0f) << 6) | (b[:, 3] >> 2)
    out[:, 3] = ((b[:, 3] & 0x03) << 8) | b[:, 4]
    return out.reshape(-1)


def read_samples(src, s0: int, n: int) -> np.ndarray:
    """Samples [s0, s0 + n) of the source, read again as bytes by position
    and unpacked here."""
    g0 = s0 // 4
    src.seek(g0 * 5)
    raw = np.array(src.read((-(-(s0 + n) // 4) - g0) * 5))
    return unpack_4_40(raw)[s0 - 4 * g0:s0 - 4 * g0 + n]


class _Precision:
    def __init__(self, name: str):
        if name not in ('float64', 'bfloat16'):
            raise ValueError(f'precision {name!r}')
        self.name = name
        self.real = torch.float64 if name == 'float64' else torch.float32
        self.cplx = (torch.complex128 if name == 'float64'
                     else torch.complex64)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if self.name == 'float64':
            return x
        if x.is_complex():
            return torch.complex(self(x.real), self(x.imag))
        return x.to(torch.bfloat16).to(torch.float32)


@dataclass
class FieldOut:
    """What a decode gives for one field, in its window's coordinates
    (index 0 = absolute sample `readsample`)."""
    readsample: int
    istop: bool
    linecount: int
    linelocs: np.ndarray            # float64
    picture: np.ndarray             # (linecount * W,) uint16
    audio: Optional[np.ndarray]     # int16 interleaved L/R
    audio_offset: float             # the 48 kHz carry it started at
    index: int = -1                 # its place among the fields read


@dataclass
class Window:
    """The reference's demodulation of one field's decode window."""
    video: torch.Tensor             # the video (Hz), in line coordinates
    video05: torch.Tensor           # its 0.5 MHz low-pass, aligned
    a2l: torch.Tensor               # stage-2 audio, left
    a2r: torch.Tensor               # and right
    host: dict = field(default_factory=dict)

    def numpy(self, name: str) -> np.ndarray:
        """A tap as float64 on the host (kept for the field's lines)."""
        if name not in self.host:
            self.host[name] = getattr(self, name).double().cpu().numpy()
        return self.host[name]


class Reference:
    def __init__(self, conf: dict, device, precision: str = 'float64'):
        self.cfg = DecoderConfig(system=conf['system'],
                                 freq_mhz=conf['freq_mhz'])
        self.conf = conf
        self.device = torch.device(device)
        self.q = _Precision(precision)
        cfg = self.cfg
        v = FD.design_video_filters(cfg)
        a = FD.design_audio_filters(cfg)
        put = self._put
        self.rf_video = put(v.rf_video)
        self.mtf = put(v.mtf)
        self.f_video = put(v.f_video)
        # the 0.5 MHz low-pass's FIR delay taken out (ld-decode's roll)
        k = np.arange(cfg.blocklen)
        self.f_video05 = put(v.f_video05 * np.exp(
            2j * np.pi * k * v.f05_offset / cfg.blocklen))
        self.a = a
        self.lfilt, self.rfilt = put(a.lfilt), put(a.rfilt)
        self.lpf2 = put(a.lpf2[:len(a.lpf2) // 2 + 1])
        self.offset_px = float(conf['lineloc_offset_px'])
        self.hsync_offset_px = conf.get('hsync_offset_px')
        self.mtf_level = float(conf['mtf_level'])

    def _put(self, x: np.ndarray) -> torch.Tensor:
        return self.q(torch.as_tensor(np.asarray(x, np.complex128)).to(
            self.device, self.q.cplx))

    @property
    def stream_len(self) -> int:
        cfg = self.cfg
        return NBLOCKS * cfg.block_keep + cfg.blockcut + cfg.blockcut_end

    # ---------------------------------------------------------------- demod

    def _phase_step(self, z: torch.Tensor) -> torch.Tensor:
        """Per-sample phase advance in [0, tau), the first sample 0."""
        q = self.q
        d = q(z[..., 1:] * torch.conj(z[..., :-1]))
        dphi = q(torch.remainder(torch.angle(d), TAU))
        return torch.nn.functional.pad(dphi, (1, 0))

    def demod(self, samples: np.ndarray, mtf_level: float):
        """(video (n,) in Hz, its 0.5 MHz low-pass, audio stage-1 left,
        right) of a decode window of `stream_len` samples; video[i] is
        window sample blockcut + i."""
        cfg, q, a = self.cfg, self.q, self.a
        n, keep, cut = cfg.blocklen, cfg.block_keep, cfg.blockcut
        x = q(torch.as_tensor(samples.astype(np.float64)).to(
            self.device, self.q.real))
        blocks = x.unfold(0, n, keep)[:NBLOCKS]
        X = q(torch.fft.fft(blocks))
        w = q(self.rf_video * self.mtf ** mtf_level)
        hz = q(self._phase_step(q(torch.fft.ifft(q(X * w))))
               * (cfg.freq_hz / TAU))
        HZ = q(torch.fft.fft(hz))
        video = q(torch.fft.ifft(q(HZ * self.f_video)).real)
        video = video[:, cut:cut + keep].reshape(-1)
        video05 = q(torch.fft.ifft(q(HZ * self.f_video05)).real)
        video05 = video05[:, cut:cut + keep].reshape(-1)

        lo, hi = a.slice_lo
        sliced = torch.cat([X[:, lo:hi], X[:, n - hi:n - lo]], dim=-1)
        acut = cut // (n // a.stage1_len)
        chans = []
        for filt in (self.lfilt, self.rfilt):
            z = q(torch.fft.ifft(q(sliced * filt)))
            s1 = q(self._phase_step(z) * (a.freq_arf / TAU) + a.lowfreq)
            chans.append(s1[:, acut:acut + a.stage1_keep].reshape(-1))
        return video, video05, chans[0], chans[1]

    def stage2(self, s1: torch.Tensor) -> torch.Tensor:
        """The second audio stage: 16384-sample blocks, the 21 kHz LPF and
        a quarter of the rate, 64-sample head skips (ld-decode's block
        layout, the last block at end - blocklen - 1)."""
        q, fdiv2, askip, bl = self.q, self.a.fdiv2, 64, 16384
        n = s1.shape[0]
        sjump = bl - askip * fdiv2
        starts = [0] + list(range(sjump, n - sjump, sjump)) + [n - bl - 1]
        outs = []
        nbins = bl // (fdiv2 * 2) + 1
        for s in starts:
            idx = torch.arange(s, s + bl, device=s1.device).clamp(0, n - 1)
            spec = q(q(torch.fft.rfft(s1[idx]))[:nbins] * self.lpf2[:nbins])
            outs.append(q(torch.fft.irfft(spec, bl // fdiv2) / fdiv2))
        n_out = n // fdiv2
        head = torch.cat([outs[0]] + [o[askip:] for o in outs[1:-1]])
        head = head[:n_out]
        if head.shape[0] < n_out:
            head = torch.nn.functional.pad(head, (0, n_out - head.shape[0]))
        tail = outs[-1][askip:]
        return torch.cat([head[:n_out - tail.shape[0]], tail])

    # ------------------------------------------------------------- outputs

    def picture(self, video: torch.Tensor, linelocs: np.ndarray,
                linecount: int) -> np.ndarray:
        """(linecount * W,) uint16 rows at the given line locations."""
        cfg, q = self.cfg, self.q
        sp = cfg.sys
        W = sp.outlinelen
        off = 1 if cfg.system == 'NTSC' else 3
        ll = q(torch.as_tensor(linelocs[off:off + linecount + 1],
                               dtype=torch.float64).to(self.device,
                                                       q.real))
        step = q(ll[1:] - ll[:-1])
        k = torch.arange(W, dtype=q.real, device=self.device)
        pos = q(ll[:-1, None] + q(k[None, :] * q(step[:, None] / W)))
        n = video.shape[0]
        pos = pos.clamp(1.0, n - 3.0)
        i0 = torch.floor(pos)
        t = q(pos - i0)
        i0 = i0.long()
        t2, t3 = q(t * t), q(t * t * t)
        wts = (q(-0.5 * t3 + t2 - 0.5 * t), q(1.5 * t3 - 2.5 * t2 + 1.0),
               q(-1.5 * t3 + 2.0 * t2 + 0.5 * t), q(0.5 * t3 - 0.5 * t2))
        out = sum(q(wt * video[i0 + d]) for wt, d in zip(wts, (-1, 0, 1, 2)))
        out = q(q(out) * q(step / float(cfg.linelen))[:, None])
        reduced = q(q(out - sp.ire0) / sp.hz_ire - sp.vsync_ire)
        if cfg.system == 'NTSC':
            scale, offset = float(0xc800 - 0x0400) / (100 - sp.vsync_ire), \
                1024
        else:
            scale, offset = float(0xd300 - 0x0100) / (100 - sp.vsync_ire), \
                256
        lines = torch.floor(torch.clamp(q(reduced * scale) + offset, 0,
                                        65535) + 0.5)
        return lines.reshape(-1).cpu().numpy().astype(np.uint16)

    def audio(self, a2l: torch.Tensor, a2r: torch.Tensor,
              linelocs: np.ndarray, linecount: int,
              offset: float) -> np.ndarray:
        """The 48 kHz chase (ld-decode's downscale_audio): int16 L/R."""
        cfg, q = self.cfg, self.q
        sp = cfg.sys
        dev = self.device
        lc = sp.frame_lines // 2 + 1
        maxt = int(np.ceil(sp.line_period * lc / 1e6 * 48000.0)) + 8
        gap = 1.0 / 48000.0
        # the tick count is a length, decided in float32 as ld-decode's
        # chase decides it (its carry is float32 arithmetic)
        f32 = np.float32
        frametime = f32(f32(sp.line_period) * f32(linecount)) / f32(1e6)
        count = int(min(max(np.ceil(f32(f32(frametime + f32(gap))
                                        - f32(offset)) / f32(gap)), 1),
                        maxt))
        ll = q(torch.as_tensor(linelocs, dtype=torch.float64).to(dev,
                                                                 q.real))
        n = ll.shape[0]
        ticks = q(offset + torch.arange(count - 1, dtype=q.real,
                                        device=dev) * gap)
        linenum = q(ticks * (1e6 / sp.line_period) + 1)
        li = linenum.long().clamp(0, n - 1)
        li1 = (li + 1).clamp(max=n - 1)
        delta = torch.where(li + 1 < n, q(ll[li1] - ll[li]),
                            torch.full_like(ll[li], float(cfg.linelen)))
        frac = q(linenum - torch.floor(linenum))
        sampleloc = q(ll[li] + q(delta * frac))
        swow = q(delta / float(cfg.linelen))
        idx = torch.floor(sampleloc / 64).long().clamp(0, a2l.shape[0] - 1)
        out = []
        for a2, carrier in ((a2l, sp.audio_lfreq), (a2r, sp.audio_rfreq)):
            x = q(q(a2[idx] * swow) - carrier)
            v = torch.round(q(x * 32767.0) / 150000.0).clamp(-32766, 32766)
            out.append(v)
        return torch.stack(out, dim=-1).reshape(-1).cpu().numpy().astype(
            np.int16)

    def line_times(self, field_line: int, readsample: int, nlines: int,
                   offset: float) -> np.ndarray:
        """Where the source put the lines of a field whose first line is
        line `field_line` of the stream, in its window's coordinates, plus
        a line-start convention `offset`."""
        spl = self.cfg.sys.line_period * self.cfg.freq_mhz
        return ((field_line + np.arange(nlines)) * spl + offset
                - readsample)

    def first_field(self, field_line: int) -> bool:
        """Whether a field starting at stream line `field_line` is a
        frame's first (top) field."""
        return field_line % self.cfg.sys.frame_lines == 0

    def linelocs(self, win: Window, field_line: int, readsample: int,
                 nlines: int):
        """(the reference's line locations of a field whose first line is
        line `field_line` of the stream, in its window's coordinates; the
        PAL lines its pilot pass left at their hsync location)."""
        unmoved = np.zeros(0, np.int64)
        if self.cfg.system == 'PAL':
            nominal = self.line_times(field_line, readsample, nlines,
                                      float(self.hsync_offset_px))
            d05 = win.numpy('video05')
            pre = TBC.hsync_locations(d05, nominal, self.cfg,
                                      self.first_field(field_line))
            ll, unmoved = TBC.pilot_pass(win.numpy('video'), d05, pre,
                                         self.cfg)
        else:
            ll = self.line_times(field_line, readsample, nlines,
                                 self.offset_px)
        if self.q.name != 'float64':
            ll = self.q(torch.as_tensor(ll)).double().numpy()
        return ll, unmoved

    # ------------------------------------------------------------- decode

    def window(self, src, readsample: int) -> Window:
        """The reference's demodulation of the decode window of a field
        that starts at `readsample`."""
        s0 = readsample - self.cfg.blockcut
        x = read_samples(src, s0, self.stream_len)
        video, video05, l1, r1 = self.demod(x, self.mtf_level)
        return Window(video, video05, self.stage2(l1), self.stage2(r1))

    def decode_field(self, src, readsample: int, field_line: int,
                     istop: bool, linecount: int, nlines: int,
                     audio_offset: float) -> FieldOut:
        """The reference put in a decoder's place for one field (the
        control runs it at bfloat16)."""
        win = self.window(src, readsample)
        ll, _ = self.linelocs(win, field_line, readsample, nlines)
        return FieldOut(readsample, istop, linecount, ll,
                        self.picture(win.video, ll, linecount),
                        self.audio(win.a2l, win.a2r, ll, linecount,
                                   audio_offset),
                        audio_offset)


def weave(cfg: DecoderConfig, top: np.ndarray, lc_top: int,
          bottom: np.ndarray, lc_bottom: int) -> np.ndarray:
    """Two fields' rows into a frame (ld-decode's weave with the visible
    half line; the 16 line-0 metadata words are not part of it)."""
    W, L = cfg.sys.outlinelen, cfg.sys.frame_lines
    half = min(lc_top, lc_bottom)
    combined = np.zeros(W * L, np.uint16)
    rows = combined.reshape(L, W)
    rows[0:2 * half:2] = top[:half * W].reshape(-1, W)
    rows[1:2 * half:2] = bottom[:half * W].reshape(-1, W)
    longer = top if lc_top >= lc_bottom else bottom
    if (half + 1) * W <= len(longer):
        combined[2 * half * W:(2 * half + 1) * W] = \
            longer[half * W:(half + 1) * W]
    return combined
