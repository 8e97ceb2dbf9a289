"""Device-side vsync detection + line numbering (torch port of
ld_decode_tpu/tbc/sync_dev.py).

Fixed-shape masked programs over the padded (B, MAX_PEAKS) sync-peak
arrays, one row per field: hsync level statistics, vsync candidate voting
and integer line numbering with gap interpolation.  Nothing here reads a
value back to the host, so a whole field batch stays queued on the device.

  * the candidate list keeps the first MAX_VSYNCS valid vsyncs, compacted
    with a cumsum + scatter (a fixed-shape `nonzero`);
  * line tables are (B, max_nlines) with the true line count per field;
  * positions use (int32 anchor, float32 frac) splits.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from ld_decode_tpu_torch.tbc.sync import first_true

MAX_VSYNCS = 8
_INT32_MIN = -(1 << 31)
_INT32_MAX = (1 << 31) - 1


def _masked_median(x: torch.Tensor, mask: torch.Tensor, cnt: torch.Tensor):
    """np.median over the masked elements of each row (the two middles
    averaged for an even count)."""
    s = torch.sort(torch.where(mask, x, torch.inf), dim=-1).values
    c = cnt.clamp(min=1)
    lo = s.gather(-1, ((c - 1) // 2).clamp(min=0)[..., None].long())[..., 0]
    hi = s.gather(-1, (c // 2)[..., None].long())[..., 0]
    return (lo + hi) * 0.5


def hsync_stats_dev(vals: torch.Tensor, valid: torch.Tensor):
    """Median / 2*std of the peak values in the regular-hsync band
    0.6..0.8, per row."""
    sel = valid & (vals >= 0.6) & (vals <= 0.8)
    cnt = sel.sum(dim=-1)
    med = _masked_median(vals, sel, cnt)
    c = cnt.clamp(min=1).to(torch.float32)
    zero = torch.zeros((), dtype=vals.dtype, device=vals.device)
    mean = torch.where(sel, vals, zero).sum(dim=-1) / c
    var = torch.where(sel, (vals - mean[..., None]) ** 2, zero).sum(
        dim=-1) / c
    tol = torch.clamp(torch.sqrt(var) * 2, min=0.01)
    med = torch.where(cnt == 0, 0.7, med)
    tol = torch.where(cnt == 0, 0.01, tol)
    return med, tol


class VsyncsDev(NamedTuple):
    idx: torch.Tensor      # (B, MAX_VSYNCS) peak index of each candidate
    line0: torch.Tensor    # (B, MAX_VSYNCS) repaired line0 peak index
    istop: torch.Tensor    # (B, MAX_VSYNCS) bool, vote < 0
    count: torch.Tensor    # (B,) int32
    med: torch.Tensor      # (B,)
    tol: torch.Tensor      # (B,)


def _take(x: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """Per-row gather x[b, i[b, ...]]."""
    return x.gather(-1, i.reshape(x.shape[0], -1).long()).reshape(i.shape)


def determine_vsyncs_dev(peaks: torch.Tensor, vals: torch.Tensor,
                         nv: torch.Tensor, inlinelen: int,
                         is_pal: bool) -> VsyncsDev:
    """Vsync candidates, field-polarity votes and the repair pass, as
    masked vector ops over (B, P) peaks."""
    B, P = peaks.shape
    dev = peaks.device
    ar = torch.arange(P, device=dev)
    valid = ar < nv[:, None]
    med, tol = hsync_stats_dev(vals, valid)
    med_, tol_ = med[:, None], tol[:, None]
    reg = valid & (vals >= med_ - tol_) & (vals <= med_ + tol_)

    prevval = F.pad(vals[:, :-1], (1, 0), value=1.0)
    cand = valid & (vals > 0.9) & (prevval < med_ - tol_ * 2)

    # backward scan j = i-1 .. max(i-20,-1)+1 for the first regular peak
    offs = torch.arange(1, 20, device=dev)
    jb = ar[:, None] - offs[None, :]                         # (P, 19)
    jbok = (jb >= 0) & (jb > torch.clamp(ar[:, None] - 20, min=-1))
    mb = jbok & _take(reg, jb.clamp(min=0).expand(B, P, 19))
    foundb = mb.any(dim=-1)
    ob = first_true(mb)
    line0 = ar - 1 - ob                                      # (B, P)
    l0c = line0.clamp(min=0)
    gap1 = _take(peaks, (l0c + 1).clamp(max=P - 1)) - _take(peaks, l0c)
    vote_b = torch.where((l0c + 1 < nv[:, None])
                         & (gap1 > inlinelen * 0.75), -1, 0)

    # forward scan j = i .. min(i+20, nv)-1 for the first regular peak
    offf = torch.arange(0, 20, device=dev)
    jf = ar[:, None] + offf[None, :]                         # (P, 20)
    mf = (jf < nv[:, None, None]) & _take(reg, jf.clamp(max=P - 1).expand(
        B, P, 20))
    foundf = mf.any(dim=-1)
    of = first_true(mf)
    je = (ar + of).clamp(max=P - 1)
    gap2 = _take(peaks, je) - _take(peaks, (je - 1).clamp(min=0))
    fvote = -1 if is_pal else 1
    vote_f = torch.where(foundf & (gap2 > inlinelen * 0.75), fvote, 0)

    vote = vote_b + vote_f + (1 if is_pal else 0)
    keep = cand & (ar >= 11) & foundb

    # fixed-size compaction of the first MAX_VSYNCS kept positions
    pos = torch.cumsum(keep.to(torch.int32), dim=-1) - 1
    pos = torch.where(keep & (pos < MAX_VSYNCS), pos, MAX_VSYNCS)
    kidx = torch.full((B, MAX_VSYNCS + 1), -1, dtype=torch.int64,
                      device=dev).scatter(1, pos.long(), ar.expand(B, P))
    kidx = kidx[:, :MAX_VSYNCS]
    kvalid = kidx >= 0
    ki = torch.where(kvalid, kidx, 0)
    k_i = torch.where(kvalid, ki, -1).to(torch.int32)
    k_line0 = torch.where(kvalid, _take(line0, ki), -1).to(torch.int32)
    k_vote = torch.where(kvalid, _take(vote, ki), 0).to(torch.int32)
    count = kvalid.sum(dim=-1).to(torch.int32)
    # the reference bails out entirely with < 200 peaks
    count = torch.where(nv < 200, 0, count)

    # repair pass: the host loop converts each vote to its 0/1 istop form
    # IN PLACE, so step k reads the raw vote of k+1 but the converted vote
    # of k-1 -- replicated exactly, vectorized over the batch
    back = 6 if is_pal else 7
    l0 = [k_line0[:, k] for k in range(MAX_VSYNCS)]
    raw = [k_vote[:, k] for k in range(MAX_VSYNCS)]
    conv = []
    run = count >= 2
    for k in range(MAX_VSYNCS):
        inrange = run & (k < count)
        zero = raw[k] == 0
        l0[k] = torch.where(inrange & zero, -1, l0[k])
        if k + 1 < MAX_VSYNCS:
            nxt_ok = (k + 1 < count) & (raw[k + 1] != 0)
            nxt = raw[k + 1]
        else:
            nxt_ok = torch.zeros_like(zero)
            nxt = raw[k]
        if k >= 1:
            prv_ok = conv[k - 1] != 0
            prv = conv[k - 1]
        else:
            prv_ok = torch.zeros_like(zero)
            prv = raw[k]
        newv = torch.where(nxt_ok, -nxt, torch.where(prv_ok, -prv, 0))
        vk = torch.where(inrange & zero, newv, raw[k])
        l0[k] = torch.where(inrange & (l0[k] <= 0), k_i[:, k] - back, l0[k])
        conv.append(torch.where(inrange, (vk < 0).to(torch.int32), 0))

    istop = torch.stack([c > 0 for c in conv], dim=-1)
    return VsyncsDev(k_i, torch.stack(l0, dim=-1).to(torch.int32), istop,
                     count, med, tol)


def _rolling_ok_median(gap: torch.Tensor, ok: torch.Tensor, inlinelen: int):
    """For each gap position j, the median of the last 25 regular gaps
    before j, seeded with the nominal line length."""
    B, P = gap.shape
    dev = gap.device
    ordn = torch.cumsum(ok.to(torch.int64), dim=-1)          # inclusive
    # dense sequence of ok gaps: okg[ordn[j]-1] = gap[j] for ok j (slot P
    # takes the dropped writes)
    okg = torch.zeros((B, P + 1), dtype=gap.dtype, device=dev).scatter(
        1, torch.where(ok, ordn - 1, P),
        torch.where(ok, gap, torch.zeros((), dtype=gap.dtype, device=dev)))
    cbefore = ordn - ok.to(torch.int64)
    w = torch.arange(25, device=dev)
    widx = cbefore[..., None] - 25 + w                       # (B, P, 25)
    seed = torch.where(widx == -1, float(inlinelen), torch.inf).to(gap.dtype)
    vals = torch.where(widx >= 0, _take(okg, widx.clamp(0, P)), seed)
    m = widx >= -1
    cnt = m.sum(dim=-1)
    s = torch.sort(torch.where(m, vals, torch.inf), dim=-1).values
    lo = s.gather(-1, ((cnt - 1) // 2)[..., None])[..., 0]
    hi = s.gather(-1, (cnt // 2)[..., None])[..., 0]
    return (lo + hi) * 0.5


class LinelocsDev(NamedTuple):
    lli: torch.Tensor      # (B, R) int32 anchors
    llf: torch.Tensor      # (B, R) float32 fractions
    bad: torch.Tensor      # (B, R) bool
    ok: torch.Tensor       # (B,) bool: numbering succeeded


def _floordiv(a: torch.Tensor, b: int) -> torch.Tensor:
    return torch.div(a, b, rounding_mode='floor')


def compute_linelocs_dev(peaks: torch.Tensor, vals: torch.Tensor,
                         nv: torch.Tensor, med, tol,
                         v0_line0: torch.Tensor, v1_line0: torch.Tensor,
                         lc: torch.Tensor, inlinelen: int,
                         max_nlines: int) -> LinelocsDev:
    """Line numbering with fixed-shape (B, max_nlines) tables.  Rows
    l = 1..max_nlines map to table entries 0..max_nlines-1; entries beyond
    lc+4 are linearly extrapolated."""
    B, P = peaks.shape
    R = max_nlines
    dev = peaks.device
    ar = torch.arange(P, device=dev)
    valid = ar < nv[:, None]
    end = v1_line0.clamp(0, P)
    reg = valid & (vals >= (med - tol)[:, None]) \
        & (vals <= (med + tol)[:, None]) & (ar < end[:, None])

    # previous regular peak for each position
    prev_reg = F.pad(torch.cummax(torch.where(reg, ar, -1), dim=-1).values
                     [:, :-1], (1, 0), value=-1)
    has_prev = reg & (prev_reg >= 0)
    gap = (peaks - _take(peaks, prev_reg.clamp(min=0))).to(torch.float32)
    rel = gap / inlinelen
    ok = has_prev & (rel >= 0.98) & (rel <= 1.02)

    med25 = _rolling_ok_median(gap, ok, inlinelen)
    inc = torch.where(ok, 1, torch.where(
        has_prev, torch.round(gap / med25).to(torch.int32), 0))

    any_reg = reg.any(dim=-1)
    fidx = first_true(reg)
    v0 = _take(peaks, v0_line0.clamp(0, P - 1)[:, None])[:, 0]
    pf = _take(peaks, fidx[:, None])[:, 0]
    first = torch.round((pf - v0).to(torch.float32)
                        / inlinelen).to(torch.int32)
    num = first[:, None] + torch.cumsum(torch.where(has_prev, inc, 0),
                                        dim=-1)
    num = torch.where(reg, num, -(1 << 20)).to(torch.int64)  # sentinel

    # ---- table build over rows l = 1..R ----
    lrow = torch.arange(1, R + 1, device=dev)                # (R,)
    numr = num[:, None, :]                                   # (B, 1, P)
    regr = reg[:, None, :]
    lcol = lrow[None, :, None]                               # (1, R, 1)

    # prev: largest num <= l with num > -10; the LAST peak wins among
    # equal nums
    pmask = regr & (numr <= lcol) & (numr > -10)
    pkey = numr * P + ar
    pk = torch.where(pmask, pkey, _INT32_MIN).amax(dim=-1)
    has_p = pmask.any(dim=-1)
    pj = torch.where(has_p, pk - _floordiv(pk, P) * P, 0)
    pnum = torch.where(has_p, _floordiv(pk, P), 0)
    ploc = _take(peaks, pj.clamp(0, P - 1))

    # next: smallest num >= l with num <= lc; the LAST peak wins
    nmask = regr & (numr >= lcol) & (numr <= lc[:, None, None])
    nkey = numr * P + (P - 1 - ar)
    nk = torch.where(nmask, nkey, _INT32_MAX).amin(dim=-1)
    has_n = nmask.any(dim=-1)
    nj = torch.where(has_n, P - 1 - (nk - _floordiv(nk, P) * P), 0)
    nnum = torch.where(has_n, _floordiv(nk, P), 0)
    nloc = _take(peaks, nj.clamp(0, P - 1))

    exact = (pmask & (numr == lcol)).any(dim=-1)

    # pass 1: rows with an exact peak, interpolation, or head extrapolation
    lrow = lrow[None, :]
    dd_p = (lrow - pnum).to(torch.float32)
    dd_n = nnum - lrow
    head_i = nloc - inlinelen * dd_n
    avglen = (nloc - ploc).to(torch.float32) \
        / torch.clamp((nnum - pnum).to(torch.float32), min=1.0)
    ai = torch.round(avglen)
    mid_i = ploc + (ai * dd_p).to(torch.int32)
    mid_f = (avglen - ai) * dd_p

    f1_i = torch.where(has_p, mid_i, head_i).to(torch.int32)
    f1_f = torch.where(has_p, mid_f, 0.0)
    tail = has_p & ~has_n

    # tail rows need avglen = ploc - filled[pnum-1]; the chain through
    # nums > lc is at most a few rows deep
    fi, ff = f1_i, f1_f
    ref_row = (pnum - 2).clamp(0, R - 1)
    for _ in range(5):
        av_t = (ploc - _take(fi, ref_row)).to(torch.float32) \
            - _take(ff, ref_row)
        at = torch.round(av_t)
        t_i = ploc + (at * dd_p).to(torch.int32)
        t_f = (av_t - at) * dd_p
        fi = torch.where(tail, t_i, f1_i).to(torch.int32)
        ff = torch.where(tail, t_f, f1_f)

    # rows beyond lc+4: linear extrapolation from row lc+3
    lcc = lc[:, None]
    last_row = (lcc + 3).clamp(0, R - 1)
    over = lrow > lcc + 4
    ext_i = _take(fi, last_row) + inlinelen * (lrow - (lcc + 4))
    fi = torch.where(over, ext_i, fi)
    ff = torch.where(over, _take(ff, last_row), ff)

    # renormalize so |frac| < 1
    q = torch.floor(ff)
    fi = (fi + q.to(torch.int32)).to(torch.int32)
    ff = (ff - q).to(torch.float32)

    bad = ~exact & ~over
    bad[:, :10] = False

    # failure modes the host path surfaces as exceptions -> invalid field
    inrange = lrow <= lcc + 4
    fillable = torch.where(inrange, has_p | has_n, True).all(dim=-1)
    chain_ok = torch.where(inrange & tail, pnum >= 2, True).all(dim=-1)
    okflag = any_reg & fillable & chain_ok
    return LinelocsDev(fi, ff, bad, okflag)
