"""The chain's fixed arithmetic, beside yardstick.py's: the least bytes a
comb window must move, and the device operations the program launched
inside its comb spans.

The least bytes are the chain's contract, not the implementation's: each
frame a window emits reads its 525 x 910 .tbc samples once at 2 bytes and
writes its 480 x 744 RGB48 frame once at 6 bytes.

A device operation belongs to a span where the host call that launched it
(a kernel, a copy, a CUDA graph's launch, whose kernels share its
correlation) began inside one of the span's records.  The harness's trace
summary keeps the slice's operations without their launches, so a traced
run of the chain entry has `yardstick.trace_events` also keep its result
here (`keep_trace_events`, from the entry's `label_layers`); it returns
what it returned before.
"""

from __future__ import annotations

import bisect
from typing import List, Optional, Sequence, Tuple

from ldbench import program_spans as P
from ldbench import yardstick as Y

IN_Y, IN_X = 525, 910
OUT_Y, OUT_X = 480, 744
COMB_SPANS = ('comb.feed', 'comb.levels', 'comb.replay', 'comb.collect')

_kept: dict = {}


def comb_frame_bytes() -> int:
    """Bytes one combed frame must move: its .tbc samples read, its RGB48
    written."""
    return IN_Y * IN_X * 2 + OUT_Y * OUT_X * 6


def comb_least_ms(frames: int) -> float:
    """The least time of `frames` combed frames at the card's memory
    rate, ms."""
    return frames * comb_frame_bytes() / Y.HBM_BYTES_S * 1e3


def keep_trace_events():
    """Have `yardstick.trace_events` keep its last result for the comb's
    readers (once a process)."""
    if getattr(Y.trace_events, 'keeps', False):
        return
    real = Y.trace_events

    def keeping(prof):
        out = real(prof)
        _kept['events'] = out
        return out

    keeping.keeps = True
    Y.trace_events = keeping


def _slice(host) -> Optional[Tuple[float, float]]:
    sl = [(a, b) for a, b, name in host if name == 'ldbench.slice']
    return sl[0] if sl else None


def launched_in(run, intervals: Sequence[Tuple[float, float]]
                ) -> Optional[List[List[Tuple[float, float, str]]]]:
    """For each (start_us, end_us) host interval, the device operations
    (start_us, end_us, name) launched inside it; None without the kept
    trace."""
    ev = _kept.get('events')
    if run.trace is None or ev is None:
        return None
    dev, _, launches = ev
    by_corr: dict = {}
    for a, b, name, _, corr in dev:
        by_corr.setdefault(corr, []).append((a, b, name))
    times = [t for t, _ in launches]
    out = []
    for a, b in intervals:
        lo = bisect.bisect_left(times, a)
        hi = bisect.bisect_right(times, b)
        ops = []
        for _, corr in launches[lo:hi]:
            ops += by_corr.get(corr, [])
        out.append(ops)
    return out


def comb_records(run, names=COMB_SPANS):
    """The slice's span records named in `names` as (name, start_us,
    end_us), and the slice (lo_us, hi_us); None without them."""
    recs = P.records(run)
    ev = _kept.get('events')
    if recs is None or ev is None:
        return None
    sl = _slice(ev[1])
    if sl is None:
        return None
    mine = [(n, a / 1e3, b / 1e3) for n, a, b, _, _ in recs if n in names]
    return (mine, sl) if mine else None


def is_kernel(name: str) -> bool:
    """A kernel, not a copy or a fill."""
    return not name.startswith(('Memcpy', 'Memset'))
