"""The NTSC and PAL field pipeline on the device (torch port of
ld_decode_tpu/tbc/fused.py).

`field_pipeline_batch` decodes a speculative batch of field windows in one
call with no read-back to the host: demod, sync-peak NMS, device vsync
voting and line numbering (tbc/sync_dev.py), hsync refinement, two burst
passes (NTSC) or one pilot pass (PAL, tbc/pal.py), the picture resample,
u16 scaling, audio stage 2 with the 48 kHz chase, and the on-device
Philips slice.  The start and audio carries come
in and go out as device scalars, so consecutive batches chain on the
device.  Results come back as a dict of tensors: the raw picture, and with
codec=True also the lossless transport codec's payloads (tbc/codec.py,
re-exported here under the JAX names; the JAX package's bundle packing is
not part of the port).

The per-line recurrences (bad-line propagation, the head/tail gap
sanitizers and the burst neighbour repair) are Python loops over lines,
vectorized over the batch.  Every line resample goes through the
dispatcher in tbc/cuda_resample.py: the hand-written kernel on the card,
the plain version on the CPU.

The sequential single-field path (`field_analyze` + `field_finish`) serves
the framer's fallback for the first field, as in the JAX package;
`field_analyze_batch` / `field_finish_batch` are its batched forms and
`field_finish_core` its unbatched finish.
"""

from __future__ import annotations

from typing import Dict, Union

import numpy as np
import torch
import torch.nn.functional as F

from ld_decode_tpu_torch.utils.params import DecoderConfig
from ld_decode_tpu_torch.audio.stage2 import audio_stage2
from ld_decode_tpu_torch.ops import demod as D
from ld_decode_tpu_torch.ops.filters import DemodBank
from ld_decode_tpu_torch.tbc import burst as B
from ld_decode_tpu_torch.tbc import sync as S
from ld_decode_tpu_torch.tbc import sync_dev as SD
from ld_decode_tpu_torch.tbc.sync_dev import _take
from ld_decode_tpu_torch.tbc.codec import (  # noqa: F401
    CODEC_BW, CODEC_NPLANES, CODEC_QCAP_BITS, _CODEC_UNIT, _RICE_M,
    _bit_transpose16, _block_rank, _block_rank_np, _codec_residual,
    _popcount16, bcls_words, codec_cap_rows, codec_cap_words,
    codec_qcap_words, compact_planes, compact_qstreams,
    decode_image_planes, decode_picture_planes, encode_image_planes,
    encode_picture_payload, encode_picture_planes, pack_tab,
    pic_codec_params, shipped_plane_words_np, tab_words, unpack_tab)
from ld_decode_tpu_torch.tbc.cuda_resample import resample_lines_batch
from ld_decode_tpu_torch.utils.graphs import GraphCache, api_cache, owned
from ld_decode_tpu_torch.vbi.philips import slice_philips_dev

PHILIPS_MARGIN = 16  # us beyond one line gathered for the VBI slicer


def require_tbc(cfg: DecoderConfig):
    """The laserdisc TBC decodes NTSC and PAL; the tape systems have their
    own chain."""
    if cfg.system not in ('NTSC', 'PAL'):
        raise ValueError(
            f'system={cfg.system!r} is demod-only: use '
            f'ld_decode_tpu_torch.tape.vhs, not the TBC')


def audio_maxt(cfg) -> int:
    """Fixed 48 kHz tick-buffer size > any field's tick count."""
    lc = cfg.sys.frame_lines // 2 + 1
    return int(np.ceil(cfg.sys.line_period * lc / 1e6 * 48000.0)) + 8


def max_linecount(cfg: DecoderConfig) -> int:
    return cfg.sys.frame_lines // 2 + 1


def max_nlines(cfg: DecoderConfig) -> int:
    return max_linecount(cfg) + 4


def philips_window_len(cfg: DecoderConfig) -> int:
    return cfg.linelen + int(PHILIPS_MARGIN * cfg.freq_mhz)


def pad_linelocs(linelocs1: np.ndarray, linebad: np.ndarray, nmax: int,
                 linelen: int):
    """Pad a host line-location table to the max length by linear
    extrapolation (padded lines are beyond every consumer's reach)."""
    npad = nmax - len(linelocs1)
    if npad <= 0:
        return np.asarray(linelocs1, np.float64), np.asarray(linebad, bool)
    ext = linelocs1[-1] + linelen * np.arange(1, npad + 1)
    ll = np.concatenate([np.asarray(linelocs1, np.float64), ext])
    bad = np.concatenate([np.asarray(linebad, bool), np.zeros(npad, bool)])
    return ll, bad


# ---------------------------------------------------------------------------
# split positions: float32 cannot hold absolute sample positions (~1e6) to
# sub-sample precision, so line locations travel as (int32 anchor, float32
# offset) pairs; every update keeps the offset small and renormalizes.

def split_norm(i: torch.Tensor, f: torch.Tensor):
    q = torch.floor(f)
    return (i + q.to(torch.int32)).to(torch.int32), (f - q).to(torch.float32)


def split_sub(ai, af, bi, bf):
    """(a - b) as a plain float32 (valid when |a-b| is small)."""
    return (ai - bi).to(torch.float32) + (af - bf)


def _tdiv(x: torch.Tensor, c: float) -> torch.Tensor:
    """x / c as a true float32 division on every device (CUDA turns
    division by a host scalar into a reciprocal multiply, which can move
    a ceil/floor decision by one)."""
    return x / torch.full((), c, dtype=torch.float32, device=x.device)


def _scalar(v, dtype, device) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v.to(dtype=dtype, device=device)
    return torch.full((), v, dtype=dtype, device=device)


# ---------------------------------------------------------------------------
# phase A: demod + sync peaks

def capture_windows(capture: torch.Tensor, starts: torch.Tensor,
                    n: int) -> torch.Tensor:
    """(B,) window starts -> (B, n) streams capture[start : start+n].
    Rows of a strided view are gathered: no (B, n) index tensor."""
    return capture.unfold(0, n, 1).index_select(0, starts)


def _analyze_core(capture: torch.Tensor, starts: torch.Tensor,
                  bank: DemodBank, cfg: DecoderConfig, nblocks: int,
                  mtf_level):
    """Demod + sync peaks for a batch of field windows.

    starts: (B,) file-sample index of demod output 0 (the head cut is
    applied here).  Returns (video, audio, peak idx, peak val)."""
    n = D.stream_len(cfg, nblocks)
    s0 = (starts - cfg.blockcut).clamp(0, capture.shape[0] - n)
    stream = capture_windows(capture, s0, n)
    video, audio = D.demod_blocks(stream, bank, cfg, nblocks, mtf_level)
    idx, val = S.find_sync_peaks(video['demod_sync'], int(cfg.linelen * 0.4))
    return video, audio, idx, val.to(torch.float32)


def field_analyze(capture: torch.Tensor, start, bank: DemodBank,
                  cfg: DecoderConfig, nblocks: int, mtf_level):
    """Phase A for one field window (batch of 1).  start: an int, or a
    device tensor of one element (what a replayed graph takes, since a
    capture would freeze a host value)."""
    starts = _scalar(start, torch.int32, capture.device).reshape(1)
    return _analyze_core(capture, starts, bank, cfg, nblocks, mtf_level)


def field_analyze_batch(capture: torch.Tensor, starts: torch.Tensor,
                        bank: DemodBank, cfg: DecoderConfig, nblocks: int,
                        mtf_level,
                        graphs: Union[bool, GraphCache] = True):
    """Phase A over a (B,) tensor of window starts (the JAX package's vmap
    of the analyze phase; the capture and the bank are shared).  Returns
    (video, audio, peak idx (B, MAX_PEAKS), peak val (B, MAX_PEAKS)).
    The JAX function packs idx/val into one flat u16 bundle for its
    device-to-host tunnel (`PEAKS_SPEC`); bundles do not carry over to the
    port, which returns the tensors.

    graphs=True (the default; the JAX function is jitted) replays the call
    as one CUDA graph a (cfg, nblocks, B) key on the card, the capture
    and the bank read in place, and returns clones of its outputs
    (utils/graphs.py::api_cache; eager on the CPU); False runs it eagerly;
    a GraphCache is used as given and returns its static outputs."""
    cache, clone = api_cache(graphs, capture.device)
    out = cache(
        ('field_analyze_batch', cfg, nblocks, starts.shape[0]),
        lambda s, m: _analyze_core(capture, s, bank, cfg, nblocks, m),
        (starts.to(capture.device, torch.int32),
         D._level(mtf_level, bank.rdtype, capture.device)),
        reads=(capture,) + tuple(bank.buffers()))
    return owned(out) if clone else out


# ---------------------------------------------------------------------------
# refinement

def _hsync_refine(video, lli, llf, linebad, lc, cfg: DecoderConfig):
    """hsync zero-crossing refinement incl. the sequential repairs, over
    (B, n) split line tables; lc (B,) true line counts."""
    freq = int(round(cfg.freq_mhz))
    n = lli.shape[-1]
    idx = torch.arange(n, device=lli.device)
    si = torch.where(idx < 9, lli - 200, lli)

    starts_i, zc_rel, refined_rel, bad_dev, found = S.refine_hsync_zc(
        video['demod_05'], si, freq,
        cfg.iretohz(-20), cfg.iretohz(-60), cfg.iretohz(20),
        cfg.iretohz(100), cfg.iretohz(-10), cfg.iretohz(10))

    usable = found & ~linebad
    chosen = torch.where(idx >= 10, refined_rel, zc_rel)
    bi = torch.where(usable, starts_i, si)
    bf = torch.where(usable, chosen, llf)
    bad = torch.where(usable, linebad | ((idx >= 10) & bad_dev), True)
    bf = torch.where(idx < 10, bf + 4.72 * cfg.freq_mhz, bf)
    bi, bf = split_norm(bi, bf)

    # bad lines past line 10 continue the last two lines' slope; lines
    # 0..10 are never replaced, so the walk starts at line 11
    outs_i = [bi[:, i] for i in range(11)]
    outs_f = [bf[:, i] for i in range(11)]
    take = bad & (idx > 10)
    p1i, p1f, p2i, p2f = bi[:, 10], bf[:, 10], bi[:, 9], bf[:, 9]
    for i in range(11, n):
        vi = p1i + (p1i - p2i)
        vf = p1f + (p1f - p2f)
        oi = torch.where(take[:, i], vi, bi[:, i])
        of = torch.where(take[:, i], vf, bf[:, i])
        outs_i.append(oi)
        outs_f.append(of)
        p2i, p2f, p1i, p1f = p1i, p1f, oi, of
    ll2i = torch.stack(outs_i, dim=-1)
    ll2f = torch.stack(outs_f, dim=-1)

    # head/tail gap sanitizers: short sequential walks over the ends
    lo = cfg.linelen - (cfg.freq_mhz * .2)
    hi = cfg.linelen + (cfg.freq_mhz * .2)

    def sane(gap):
        return torch.where((gap >= lo) & (gap <= hi), gap,
                           float(cfg.linelen))

    ci, cf = ll2i[:, 10], ll2f[:, 10]             # sanitized ll2[i + 1]
    head_f = []
    for i in range(9, -1, -1):
        cf = cf - sane(split_sub(ci, cf, ll2i[:, i], ll2f[:, i]))
        head_f.append(cf)
    head_i = ci[:, None].expand(-1, 10)
    head_f = torch.stack(head_f[::-1], dim=-1)

    # tail sanitizer over the last 10 TRUE lines (true nlines = lc + 4);
    # the arrays may be padded by one
    nlines_true = lc + 4
    pi, pf = ll2i[:, n - 12], ll2f[:, n - 12]    # sanitized ll2[k - 1]
    tail_i, tail_f = [], []
    for k in range(n - 11, n):
        oi, of = ll2i[:, k], ll2f[:, k]
        active = k >= (nlines_true - 10)
        gap = sane(split_sub(oi, of, pi, pf))
        pi = torch.where(active, pi, oi)
        pf = torch.where(active, pf + gap, of)
        tail_i.append(pi)
        tail_f.append(pf)
    ll2i = torch.cat([head_i, ll2i[:, 10:n - 11],
                      torch.stack(tail_i, dim=-1)], dim=-1)
    ll2f = torch.cat([head_f, ll2f[:, 10:n - 11],
                      torch.stack(tail_f, dim=-1)], dim=-1)
    return split_norm(ll2i, ll2f) + (bad,)


def _masked_nanmedian(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """numpy nanmedian over the masked elements of each row: the two
    middles averaged for an even count (torch.nanmedian returns the lower
    one), NaN for an empty row."""
    cnt = mask.sum(dim=-1)
    return torch.where(cnt == 0, torch.nan, SD._masked_median(x, mask, cnt))


def _burst_refine_post(scaled, lli, llf, max_lc: int, lc,
                       cfg: DecoderConfig):
    """Burst phase estimation + repair from the (B, max_lc, 48) scaled
    burst windows; returns the refined split locations and burst levels."""
    Bn, n = lli.shape
    dev = lli.device
    hz_ire = 1700000 / 140
    ph0, ph1, level, level_ok, counts_ok = B.burst_phase_offsets(
        scaled, hz_ire, win0=4)
    inrow = torch.arange(max_lc, device=dev) < lc[:, None]
    ok = level_ok & counts_ok & inrow
    pad = n - max_lc
    pa0 = F.pad(torch.where(ok, ph0, 0.), (0, pad))
    pa1 = F.pad(torch.where(ok, ph1, 0.), (0, pad))
    bl = F.pad(torch.where(level_ok & inrow, level, 0.), (0, pad))

    has = (pa0 != 0) | (pa1 != 0)
    med0 = _masked_nanmedian(pa0, has)
    med1 = _masked_nanmedian(pa1, has)
    use1 = (med0.abs() >= med1.abs())[:, None]   # else group 0
    any_valid = has.any(dim=-1, keepdim=True)

    adjset = torch.where(any_valid, torch.where(use1, pa1, pa0), 0.)
    ar = torch.arange(n, device=dev)
    parity = (ar % 2) == use1.to(torch.int64)
    # (with no valid burst lines the reference returns before flip/adjust)
    bl = torch.where(parity & any_valid, -bl, bl)

    badadj = (adjset.abs() > 2) & any_valid
    bl = torch.where(badadj, 0., bl)
    px = cfg.freq_mhz / (4 * 315 / 88)
    o_i = lli
    o_f = torch.where(badadj, llf, llf - adjset * px)

    # sequential neighbour repair for zero-burst lines:
    # ll3[l] = (ll3[l-1] + orig[l+1]) / 2, with ll3[l-1] possibly repaired
    take = (bl == 0) & (ar >= 2) & (ar <= lc[:, None] + 2)
    outs_i = [o_i[:, 0], o_i[:, 1]]
    outs_f = [o_f[:, 0], o_f[:, 1]]
    pi, pf = o_i[:, 1], o_f[:, 1]
    for l in range(2, n):
        nl = min(l + 1, n - 1)
        s_i = pi + o_i[:, nl]
        s_f = pf + o_f[:, nl]
        vi = torch.div(s_i, 2, rounding_mode='floor')
        vf = (s_f + (s_i % 2).to(torch.float32)) / 2
        pi = torch.where(take[:, l], vi, o_i[:, l])
        pf = torch.where(take[:, l], vf, o_f[:, l])
        outs_i.append(pi)
        outs_f.append(pf)
    r_i, r_f = split_norm(torch.stack(outs_i, dim=-1),
                          torch.stack(outs_f, dim=-1))
    return r_i, r_f, bl


def _burst_pass(video, lli, llf, lc, cfg: DecoderConfig):
    """One burst refinement pass: the 48-column burst-window resample
    (grid columns 16..63; the burst window is 20:60) + phase repair."""
    max_lc = max_linecount(cfg)
    scaled = resample_lines_batch(video['demod_burst'], lli, llf,
                                  cfg.sys.outlinelen, max_lc,
                                  float(cfg.linelen), col0=16, ncols=48)
    return _burst_refine_post(scaled, lli, llf, max_lc, lc, cfg)


def _refine_batch(video, ll1i, ll1f, linebad, lc, cfg: DecoderConfig,
                  colorphase: float):
    """hsync refinement, then two NTSC burst passes and the colour-phase
    shift, or one PAL pilot pass (burst levels zero) -> final split line
    locations and burst levels."""
    require_tbc(cfg)
    lli, llf, _bad = _hsync_refine(video, ll1i, ll1f, linebad, lc, cfg)
    if cfg.system == 'PAL':
        from ld_decode_tpu_torch.tbc import pal as PALK
        lli, llf = PALK.refine_pilot(video['demod'], video['demod_05'], lli,
                                     llf, cfg.linelen, cfg.freq_mhz)
        return lli, llf, torch.zeros_like(llf)
    bl = None
    for _pass in range(2):
        lli, llf, bl = _burst_pass(video, lli, llf, lc, cfg)
    shift33 = colorphase * (np.pi / 180)
    px = cfg.freq_mhz / (4 * 315 / 88)
    lli, llf = split_norm(lli, llf + (shift33 - 8) * px)
    return lli, llf, bl


def _picture_scaled(video, lli, llf, cfg: DecoderConfig):
    """Wow-corrected picture resample, (B, max_lc, W) float32."""
    lineoffset = 1 if cfg.system == 'NTSC' else 3
    return resample_lines_batch(video['demod'], lli[:, lineoffset:],
                                llf[:, lineoffset:], cfg.sys.outlinelen,
                                max_linecount(cfg), float(cfg.linelen))


# ---------------------------------------------------------------------------
# outputs

def _scale_u16(out, lc, burstlevel, cfg: DecoderConfig, colorlevel: float):
    """(B, max_lc, W) resampled picture -> u16 values as int32, with the
    burst flag/level words in columns 0/1 where `burstlevel` is given
    (NTSC; a PAL line keeps its picture there)."""
    sp = cfg.sys
    reduced = (out - sp.ire0) / sp.hz_ire - sp.vsync_ire
    if cfg.system == 'NTSC':
        out_scale = float(0xc800 - 0x0400) / (100 - sp.vsync_ire)
        offset = 1024
    else:
        out_scale = float(0xd300 - 0x0100) / (100 - sp.vsync_ire)
        offset = 256
    lines16 = torch.clamp(reduced * out_scale + offset, 0, 65535)
    lines16 = torch.floor(lines16 + 0.5)

    if burstlevel is not None:
        max_lc = out.shape[1]
        hz_ire_scale = 1700000 / 140
        clevel = (1 / colorlevel) / hz_ire_scale
        row = torch.arange(max_lc, device=out.device)
        flagrow = (row >= 1) & (row < lc[:, None] - 1)
        bl = burstlevel[:, :max_lc]
        flags = torch.where(bl > 0, 16384.0, 32768.0)
        levels = torch.floor(327.67 * clevel * bl.abs())
        lines16 = torch.cat([
            torch.where(flagrow, flags, lines16[..., 0])[..., None],
            torch.where(flagrow, levels, lines16[..., 1])[..., None],
            lines16[..., 2:]], dim=-1)
    return lines16.to(torch.int32)


def _downscale_audio_dev(a2l, a2r, lli, llf, lc, audio_offset,
                         cfg: DecoderConfig):
    """48 kHz chase resample of the stage-2 audio, per field: fixed-size
    (B, maxt*2) int16 output + valid tick count + the next carry offset."""
    sp = cfg.sys
    maxt = audio_maxt(cfg)
    frametime = _tdiv(sp.line_period * lc.to(torch.float32), 1e6)
    gap = 1.0 / 48000.0
    n = lli.shape[-1]
    dev = lli.device

    off = audio_offset[:, None]
    ticks = off + torch.arange(maxt, device=dev) * gap
    count = torch.ceil(_tdiv(frametime + gap - audio_offset, gap)
                       ).to(torch.int32).clamp(1, maxt)

    linenum = _tdiv(ticks * 1e6, sp.line_period) + 1
    li = linenum.to(torch.int32).clamp(0, n - 1)
    cur_i = _take(lli, li)
    cur_f = _take(llf, li)
    has_next = (li + 1) < n
    li1 = (li + 1).clamp(0, n - 1)
    delta = torch.where(
        has_next,
        (_take(lli, li1) - cur_i).to(torch.float32)
        + (_take(llf, li1) - cur_f),
        float(cfg.linelen))
    frac = linenum - torch.floor(linenum)
    # sampleloc = cur + delta*frac; int(sampleloc/64) needs only the floor
    sl_f = cur_f + delta * frac
    sl_i = cur_i + torch.floor(sl_f).to(torch.int32)
    swow = _tdiv(delta, cfg.linelen)
    idx = torch.div(sl_i, 64, rounding_mode='floor').clamp(
        0, a2l.shape[-1] - 1)
    left = _take(a2l, idx) * swow - sp.audio_lfreq
    right = _take(a2r, idx) * swow - sp.audio_rfreq

    def to16(x):
        v = torch.round(_tdiv(x * 32767.0, 150000.0))
        return v.clamp(-32766, 32766).to(torch.int16)

    inter = torch.stack([to16(left), to16(right)], dim=-1).reshape(
        lli.shape[0], -1)
    next_offset = audio_offset + (count - 1) * gap - frametime
    return inter, count, next_offset.to(torch.float32)


def _philips_windows(demod: torch.Tensor, lli, llf, cfg: DecoderConfig):
    """(B, ncl, wp) VBI line windows + (B, ncl) start fractions."""
    wp = philips_window_len(cfg)
    nsamp = demod.shape[-1]
    # one column per code line (indexing by a Python list would copy the
    # list to the device, a host sync)
    li = torch.stack([lli[:, l] for l in cfg.sys.philips_codelines], dim=1)
    lf = torch.stack([llf[:, l] for l in cfg.sys.philips_codelines], dim=1)
    w0 = li.clamp(0, nsamp - wp)
    idx = w0[..., None] + torch.arange(wp, device=demod.device,
                                       dtype=torch.int32)
    wins = demod.gather(1, idx.reshape(demod.shape[0], -1).long()).reshape(
        *li.shape, wp)
    fracs = (li - w0).to(torch.float32) + lf
    return wins, fracs


def _finish_output(video, audio1, lli, llf, scaled, lc, audio_offset,
                   bank: DemodBank, cfg: DecoderConfig, n_audio1: int,
                   colorlevel: float, burstlevel,
                   philips_windows: bool) -> Dict[str, torch.Tensor]:
    """Output generation from refined line locations + resampled picture.

    philips_windows=True returns the raw VBI line windows for the host
    slicer; False slices the Philips codes on the device."""
    Bn = lli.shape[0]
    dev = lli.device
    picture = _scale_u16(scaled, lc,
                         burstlevel if cfg.system == 'NTSC' else None, cfg,
                         colorlevel)

    if audio1 is not None:
        a2l, a2r = audio_stage2(audio1['audio_left'], audio1['audio_right'],
                                bank, n_audio1)
        audio, acount, anext = _downscale_audio_dev(
            a2l, a2r, lli, llf, lc, audio_offset, cfg)
    else:
        audio = torch.zeros((Bn, audio_maxt(cfg) * 2), dtype=torch.int16,
                            device=dev)
        acount = torch.ones(Bn, dtype=torch.int32, device=dev)
        anext = torch.zeros(Bn, dtype=torch.float32, device=dev)

    out = {'picture': picture, 'audio': audio, 'audio_count': acount,
           'audio_next_offset': anext, 'linelocs_i': lli,
           'linelocs_f': llf, 'burstlevel': burstlevel}
    wins, fracs = _philips_windows(video['demod'], lli, llf, cfg)
    if philips_windows:
        out['philips'] = wins
        out['philips_frac'] = fracs
    else:
        ncl = wins.shape[1]
        nib, ok = slice_philips_dev(wins.reshape(Bn * ncl, -1),
                                    fracs.reshape(-1), cfg.freq_mhz,
                                    cfg.iretohz(50))
        out['philips_nib'] = nib.reshape(Bn, ncl, 6)
        out['philips_ok'] = ok.reshape(Bn, ncl)
    return out


def field_finish(video, audio1, ll1i, ll1f, linebad, lc, audio_offset,
                 bank: DemodBank, cfg: DecoderConfig, n_audio1: int,
                 colorlevel: float = 1.45, colorphase: float = 91.5):
    """Refinement + outputs for fields whose line tables came from the
    host (the sequential path); all arguments batched (B, ...), line
    tables padded to max_nlines(cfg)."""
    lli, llf, burstlevel = _refine_batch(video, ll1i, ll1f, linebad, lc,
                                         cfg, colorphase)
    scaled = _picture_scaled(video, lli, llf, cfg)
    return _finish_output(video, audio1, lli, llf, scaled, lc, audio_offset,
                          bank, cfg, n_audio1, colorlevel, burstlevel,
                          philips_windows=True)


def field_finish_core(video, audio1, ll1i, ll1f, linebad, lc, audio_offset,
                      bank: DemodBank, cfg: DecoderConfig, n_audio1: int,
                      colorlevel: float = 1.45, colorphase: float = 91.5):
    """The finish of ONE field, unbatched as the JAX function is: video
    taps (n,), audio taps (n1,) or None, line tables (max_nlines(cfg),),
    lc and audio_offset scalars.  Returns `field_finish`'s dict for that
    field (no batch axis), where the JAX function returns one packed u16
    buffer (`finish_bundle_spec`): bundles do not carry over to the port.
    The picture goes through tbc/cuda_resample.py at B=1 (K1 on the card,
    its plain version on the CPU), bit-equal to the XLA resample JAX uses
    here (`_picture_scaled_xla`)."""
    def one(t):
        return t.reshape(1, *t.shape)

    video = {k: one(v) for k, v in video.items()}
    if audio1 is not None:
        audio1 = {k: one(v) for k, v in audio1.items()}
    out = field_finish(video, audio1, one(ll1i), one(ll1f), one(linebad),
                       one(lc), one(audio_offset), bank, cfg, n_audio1,
                       colorlevel, colorphase)
    return {k: v[0] for k, v in out.items()}


def field_finish_batch(video, audio1, ll1i, ll1f, linebad, lc, audio_offset,
                       bank: DemodBank, cfg: DecoderConfig, n_audio1: int,
                       colorlevel: float = 1.45, colorphase: float = 91.5,
                       pallas: bool = False,
                       graphs: Union[bool, GraphCache] = True):
    """The finish over a leading batch-of-fields axis (B, ...): one K1
    launch for the whole batch's picture ((B, 263, 910) NTSC, (B, 313,
    1135) PAL from line 3) and, for NTSC, two for its burst windows.
    Returns `field_finish`'s dict of (B, ...) tensors, where the JAX
    function returns the fields' packed u16 buffers, flat: bundles do not
    carry over to the port.

    `pallas` takes its JAX position and changes nothing here: in JAX it
    picks the TPU kernel for the batch's resamples (which differs from the
    XLA graph by up to 4 LSB, ld_decode_tpu/tbc/fused.py:977-981) over the
    vmapped XLA gathers; the port always takes its one resample dispatcher,
    whose kernel and plain version both hold to the XLA contract.

    graphs as in `field_analyze_batch`: one CUDA graph a (cfg, n_audio1,
    B) key (with colorlevel and colorphase; the taps' shapes carry
    nblocks), K1's launches credited on every replay.  The video and
    audio taps are dynamic inputs, copied into the graph's own, so any
    caller's taps replay one key."""
    del pallas
    cache, clone = api_cache(graphs, ll1i.device)
    vkeys = sorted(video)
    akeys = sorted(audio1) if audio1 is not None else []
    with_audio = audio1 is not None

    def finish(*args):
        v = dict(zip(vkeys, args[:len(vkeys)]))
        n = len(vkeys) + len(akeys)
        a = dict(zip(akeys, args[len(vkeys):n])) if with_audio else None
        return field_finish(v, a, *args[n:], bank, cfg, n_audio1,
                            colorlevel, colorphase)

    out = cache(
        ('field_finish_batch', cfg, n_audio1, ll1i.shape[0], colorlevel,
         colorphase, tuple(vkeys), tuple(akeys), with_audio), finish,
        [video[k] for k in vkeys] + [audio1[k] for k in akeys]
        + [ll1i, ll1f, linebad, lc,
           _scalar(audio_offset, torch.float32, ll1i.device)],
        reads=tuple(bank.buffers()))
    return owned(out) if clone else out


# ---------------------------------------------------------------------------
# the whole speculative batch: analyze + vsync/linelocs + finish

def _audio_offset_chain(offset0: torch.Tensor, lcs: torch.Tensor,
                        cfg: DecoderConfig):
    """Chained 48 kHz resampler carry offsets across the batch, with the
    exact float32 op order of `_downscale_audio_dev`."""
    maxt = audio_maxt(cfg)
    gap = 1.0 / 48000.0
    off = offset0.to(torch.float32)
    offs = []
    for b in range(lcs.shape[0]):
        frametime = _tdiv(cfg.sys.line_period * lcs[b].to(torch.float32),
                          1e6)
        count = torch.ceil(_tdiv(frametime + gap - off, gap)
                           ).to(torch.int32).clamp(1, maxt)
        offs.append(off)
        off = (off + (count - 1) * gap - frametime).to(torch.float32)
    return torch.stack(offs), off


def pipeline_starts(start0, batch_index: int, nbatch: int, field_pitch: int,
                    valid_len, cfg: DecoderConfig, nblocks: int,
                    device=None) -> torch.Tensor:
    """Clamped speculative window starts of fields [batch_index,
    batch_index + nbatch) of a batch chain (a shard of a sharded batch
    starts at its first field's index); windows clamp at the real end of
    the capture (`valid_len`, an int or a device scalar: JAX's traced
    scalar, the real samples of a segment zero-padded to a constant
    size), so EOF repeats a start instead of decoding the pad."""
    n_stream = D.stream_len(cfg, nblocks)
    s0 = _scalar(start0, torch.int32, device)
    smax = _scalar(valid_len, torch.int32, s0.device) \
        - (n_stream - cfg.blockcut)
    ar = torch.arange(batch_index, batch_index + nbatch, dtype=torch.int32,
                      device=s0.device)
    return torch.minimum((s0 + ar * field_pitch).clamp(min=cfg.blockcut),
                         smax)


def pipeline_analyze(capture, starts, mtf_level, bank: DemodBank,
                     cfg: DecoderConfig, nblocks: int):
    """Demod + sync peaks + device vsync voting / line numbering for a
    batch of field windows.  Returns (video, audio1, lld, lc, valid,
    istop, nfo, nv, vs_count)."""
    video, audio1, pidx, pval = _analyze_core(capture, starts, bank, cfg,
                                              nblocks, mtf_level)
    P = pidx.shape[1]
    nv = (pidx >= 0).sum(dim=-1).to(torch.int32)
    is_pal = cfg.system == 'PAL'
    field_lines = cfg.sys.frame_lines // 2

    vsd = SD.determine_vsyncs_dev(pidx, pval, nv, cfg.linelen, is_pal)
    istop = vsd.istop[:, 0]
    lc = (field_lines + istop.to(torch.int32)).to(torch.int32)
    line0_1 = vsd.line0[:, 1]
    valid_vs = (vsd.count >= 2) & (nv >= line0_1 + 4)

    lld = SD.compute_linelocs_dev(pidx, pval, nv, vsd.med, vsd.tol,
                                  vsd.line0[:, 0], line0_1, lc, cfg.linelen,
                                  max_nlines(cfg))
    valid = valid_vs & lld.ok
    nfo = _take(pidx, (line0_1 - 10).clamp(0, P - 1)[:, None])[:, 0]
    return video, audio1, lld, lc, valid, istop, nfo, nv, vsd.count


def pipeline_finish(video, audio1, lld, lc, valid, istop, nfo, nv, vs_count,
                    starts, offs_used, bank: DemodBank, cfg: DecoderConfig,
                    n_audio1: int, colorlevel: float, colorphase: float,
                    codec: bool = False) -> Dict[str, torch.Tensor]:
    """Refinement + outputs + per-field meta words for a batch; codec=True
    adds the picture codec's payloads (`encode_picture_payload`)."""
    lli, llf, burstlevel = _refine_batch(video, lld.lli, lld.llf, lld.bad,
                                         lc, cfg, colorphase)
    scaled = _picture_scaled(video, lli, llf, cfg)
    out = _finish_output(video, audio1, lli, llf, scaled, lc, offs_used,
                         bank, cfg, n_audio1, colorlevel, burstlevel,
                         philips_windows=False)

    # white flag on the device (reference tbc.cpp:1633-1644; same row
    # window and threshold as vbi/metadata.white_flag)
    out_scale = ((0xc800 - 0x0400) if cfg.system == 'NTSC'
                 else (0xd300 - 0x0100)) / (100 - cfg.sys.vsync_ire)
    pic_off = 1024 if cfg.system == 'NTSC' else 256
    thresh = (80.0 - cfg.sys.vsync_ire) * out_scale + pic_off
    wrows = out['picture'][:, 8:12, 2:]
    white = ((wrows.to(torch.float32) > thresh).sum(dim=-1) >= 200).any(
        dim=-1) & (lc > 11)

    out['meta_i'] = torch.stack(
        [valid.to(torch.int32), istop.to(torch.int32), lc,
         nfo.to(torch.int32), nv, vs_count, starts.to(torch.int32),
         white.to(torch.int32)], dim=1)
    out['meta_f'] = offs_used
    if codec:
        out.update(encode_picture_payload(out['picture'], cfg))
    return out


def field_pipeline_batch(capture: torch.Tensor, start0, audio_offset0,
                         mtf_level, bank: DemodBank, cfg: DecoderConfig,
                         nblocks: int, n_audio1: int, batch: int,
                         field_pitch: int, colorlevel: float = 1.45,
                         colorphase: float = 91.5, valid_len=None,
                         batch_index: int = 0, gather_carry=None,
                         codec: bool = False):
    """The whole speculative field batch in one call with no host read.

    capture: 1-D float32 resident capture (16-bit samples).  start0 /
    audio_offset0 / mtf_level / valid_len (the capture's real samples,
    default all of it) may be device scalars; the chained
    (next_start0, next_offset0) come back as device scalars, so
    consecutive batches chain on the device.  Returns (outputs dict of
    (batch, ...) tensors, next_start0, next_offset0).

    A shard of a larger batch (parallel/mesh.py) decodes fields
    [batch_index, batch_index + batch) of it and passes `gather_carry`,
    which maps its (3, batch) int32 carries (line counts, next-field
    offsets, window starts) to the whole batch's (3, total); the audio
    offset chain is then replayed over the whole batch, so the chained
    scalars are the whole batch's.

    codec=True adds the lossless picture codec's payloads to the outputs:
    'pic_tab' (batch, words) packed block tables, 'dense' and 'dense_q'
    (the batch's compacted plane words and quotient streams, int16 holding
    16-bit words, capacity-sized: the host copies their used prefixes) and
    'rows2' (2, batch) int32 words a field; the raw picture stays in the
    outputs (on the device) as the decode's fallback.  The default is
    False here (JAX: True), so that every caller keeps its outputs;
    FieldPrefetcher passes the flag its pic_mode resolves to."""
    require_tbc(cfg)
    if valid_len is None:
        valid_len = capture.shape[0]
    dev = capture.device
    starts = pipeline_starts(start0, batch_index, batch, field_pitch,
                             valid_len, cfg, nblocks, device=dev)
    (video, audio1, lld, lc, valid, istop, nfo, nv,
     vs_count) = pipeline_analyze(capture, starts, mtf_level, bank, cfg,
                                  nblocks)
    lc_all, nfo_all, starts_all = lc, nfo, starts
    if gather_carry is not None:
        lc_all, nfo_all, starts_all = gather_carry(
            torch.stack([lc, nfo.to(torch.int32), starts]))
    offs_all, next_offset0 = _audio_offset_chain(
        _scalar(audio_offset0, torch.float32, dev), lc_all, cfg)
    offs_used = offs_all[batch_index:batch_index + batch]
    next_start0 = starts_all[-1] + nfo_all[-1]
    out = pipeline_finish(video, audio1, lld, lc, valid, istop, nfo, nv,
                          vs_count, starts, offs_used, bank, cfg, n_audio1,
                          colorlevel, colorphase, codec)
    return out, next_start0, next_offset0
