"""Sync-pulse detection and zero-crossing search (torch port of
ld_decode_tpu/tbc/sync.py).

Fixed-shape data-parallel programs: non-maximum suppression over a
windowed maximum for peak finding, and batched gather + first-true-index
searches for zero crossings.  Every function takes leading batch
dimensions (one row per field).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

MAX_PEAKS = 1024
_NEG = float('-inf')


def first_true(mask: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Index of the first True along `dim` (0 where none): argmax over a
    bool mask, which torch only takes as an integer tensor."""
    return torch.argmax(mask.to(torch.uint8), dim=dim)


def seq_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the (short) last dim, left to right, as the JAX package's
    compiled XLA graph sums a row on the CPU.  A tree sum rounds
    differently, and these sums feed sub-sample line positions."""
    s = x[..., 0]
    for i in range(1, x.shape[-1]):
        s = s + x[..., i]
    return s


def seq_mean(x: torch.Tensor) -> torch.Tensor:
    """`seq_sum` times the float32 reciprocal of the count (XLA's
    rounding of a mean)."""
    return seq_sum(x) * (1.0 / x.shape[-1])


def sliding_max(x: torch.Tensor, radius: int) -> torch.Tensor:
    """Centered sliding maximum over +-radius along the last dim, via the
    van Herk/Gil-Werman two-pass block cummax."""
    L = 2 * radius + 1
    n = x.shape[-1]
    lead = x.shape[:-1]
    xp = F.pad(x, (radius, radius), value=_NEG)
    m = xp.shape[-1]
    nb = -(-m // L)
    xb = F.pad(xp, (0, nb * L - m), value=_NEG).reshape(*lead, nb, L)
    pre = torch.cummax(xb, dim=-1).values
    suf = torch.cummax(xb.flip(-1), dim=-1).values.flip(-1)
    s = suf.reshape(*lead, -1)
    p = F.pad(pre.reshape(*lead, -1), (0, L), value=_NEG)
    return torch.maximum(s[..., :n], p[..., L - 1:L - 1 + n])


def find_sync_peaks(ds: torch.Tensor, window: int,
                    threshold: float = 0.2
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Local maxima of the filtered sync channel, (B, n) -> (idx, val) of
    shape (B, MAX_PEAKS): int32 indices padded with -1, and the values.

    A sample is a peak if it equals the running max over +-window, exceeds
    `threshold` and strictly rises from its left neighbour.  Indices are
    compacted as top-2 per block of BL samples, a cumsum over the block
    counts and one scatter into an oversize buffer (slot MAX_PEAKS takes
    the dropped writes)."""
    B, n = ds.shape
    dev = ds.device
    wmax = sliding_max(ds, window)
    left = F.pad(ds[:, :-1], (1, 0), value=_NEG)
    is_peak = (ds >= wmax) & (ds > threshold) & (ds > left)

    BL = min(512, window)
    nb = -(-n // BL)
    mp = F.pad(is_peak, (0, nb * BL - n)).reshape(B, nb, BL)
    ar = torch.arange(BL, dtype=torch.int32, device=dev)
    i1 = first_true(mp).to(torch.int32)
    has1 = mp.any(dim=-1)
    mp2 = mp & (ar > i1[..., None])
    i2 = first_true(mp2).to(torch.int32)
    has2 = mp2.any(dim=-1)

    cnt = has1.to(torch.int32) + has2.to(torch.int32)
    off = torch.cumsum(cnt, dim=-1, dtype=torch.int32) - cnt
    base = torch.arange(nb, dtype=torch.int32, device=dev) * BL
    idxs = torch.stack([base + i1, base + i2], dim=-1).reshape(B, -1)
    pos = torch.stack([off, off + 1], dim=-1).reshape(B, -1)
    ok = torch.stack([has1, has2], dim=-1).reshape(B, -1)
    pos = torch.where(ok & (pos < MAX_PEAKS), pos, MAX_PEAKS)
    idx = torch.full((B, MAX_PEAKS + 1), -1, dtype=torch.int32, device=dev)
    idx = idx.scatter(1, pos.long(), idxs)[:, :MAX_PEAKS]
    val = torch.where(idx >= 0, ds.gather(1, idx.clamp(min=0).long()),
                      torch.zeros((), dtype=ds.dtype, device=dev))
    return idx, val


def first_crossing(rows: torch.Tensor, target, rising: torch.Tensor):
    """Vectorized `calczc` core over (..., W+1) windows where
    rows[..., j] = data[start-1+j]; the search begins at rows[..., 1].
    target: scalar or (...,) per row.  Returns (zc, found): zc relative to
    `start`, found False where no crossing exists in the window."""
    tcol = target[..., None] if isinstance(target, torch.Tensor) else target
    body = rows[..., 1:]
    cond = torch.where(rising[..., None], body >= tcol, body <= tcol)
    found = cond.any(dim=-1)
    fidx = first_true(cond)
    a = rows.gather(-1, fidx[..., None])[..., 0] - target
    b = rows.gather(-1, fidx[..., None] + 1)[..., 0] - target
    d = a - b
    y = a / torch.where(d == 0, torch.ones_like(d), d)
    zc = (fidx - 1).to(rows.dtype) + y
    return zc, found


def gather_windows(data: torch.Tensor, starts: torch.Tensor, width: int):
    """data (B, n), starts (B, L) -> (B, L, width) windows
    data[b, start + 0..width-1], starts clamped to the array bounds."""
    B, n = data.shape
    starts = starts.clamp(0, n - width)
    idx = starts[..., None] + torch.arange(width, dtype=starts.dtype,
                                           device=data.device)
    return data.gather(1, idx.reshape(B, -1).long()).reshape(
        *starts.shape, width)


def refine_hsync_zc(demod_05: torch.Tensor, starts: torch.Tensor,
                    freq: int, ire_m20: float, ire_m60: float,
                    ire_p20: float, ire_p100: float, ire_m10: float,
                    ire_p10: float):
    """Vectorized hsync-end refinement over (B, L) line starts: the -20 IRE
    crossing within 400 samples, the reference's rot/wow sanity windows and
    the mid-level re-crossing zc2.  Returns (starts_i, zc_rel, refined_rel,
    bad, found); positions are relative to the clipped integer starts."""
    n = demod_05.shape[-1]
    starts_i = starts.to(torch.int32).clamp(1, n - 402)

    rows = gather_windows(demod_05, starts_i - 1, 402)
    rising = rows[..., 1] < ire_m20
    zc_rel, found = first_crossing(rows, ire_m20, rising)
    zc_i = (starts_i + torch.floor(zc_rel).to(torch.int32)).clamp(0, n - 1)

    w_hsync1 = gather_windows(demod_05, starts_i - 2 * freq, 4 * freq)
    w_hsync = gather_windows(demod_05, zc_i - 1 * freq, 4 * freq)
    # the burst window [zc+f, zc+3f) is the tail half of w_hsync
    w_burst = w_hsync[..., 2 * freq:4 * freq]

    def mn(w):
        return w.amin(dim=-1)

    def mx(w):
        return w.amax(dim=-1)

    bad_range = ((mn(w_hsync) < ire_m60) | (mx(w_hsync) > ire_p20)
                 | (mn(w_hsync1) < ire_m60) | (mx(w_hsync1) > ire_p100)
                 | (mn(w_burst) < ire_m10) | (mx(w_burst) > ire_p10))

    low = seq_mean(w_hsync[..., 0:20])
    high = seq_mean(w_hsync[..., 100:120])
    mid = (low + high) / 2
    rising2 = w_hsync[..., 0] < mid
    rows2 = torch.cat([w_hsync[..., :1], w_hsync], dim=-1)
    zc2_rel, found2 = first_crossing(rows2, mid, rising2)
    found2 = found2 & (zc2_rel > 0)
    zc2r = zc2_rel + (zc_i - 1 * freq - starts_i).to(zc2_rel.dtype)
    zc2_ok = found2 & (torch.abs(zc2r - zc_rel) < freq / 4)

    refined_rel = torch.where(zc2_ok & ~bad_range, zc2r, zc_rel)
    bad = ~found | bad_range | (~zc2_ok & ~bad_range)
    return starts_i, zc_rel, refined_rel, bad, found
