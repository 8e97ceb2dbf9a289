"""The program's own spans (`ld_decode_tpu_torch/utils/spans.py`) as the
per-layer metrics read them.

A span keeps a record only while a torch profiler runs, and in a `--trace
1` run the profiler runs over the traced slice alone: the program's ring
then holds that slice's records, (name, start_ns, end_ns, parent, frame),
on the clock of the trace's device operations (`run.trace['ops']`, in
microseconds).  Durations are taken in whole nanoseconds: an epoch time in
microseconds as a float keeps only a quarter of one.
A run without a trace, or a program without spans (an older commit), gives
no records, and every reader of them returns None.
"""

from __future__ import annotations

import statistics
from typing import Dict, List, Optional, Sequence, Tuple

from ldbench import yardstick as Y


def records(run) -> Optional[List[tuple]]:
    """The traced slice's span records as (name, start_ns, end_ns, parent,
    frame), `parent` an index into the list; None without a trace, without
    the program's spans, or without a record."""
    if run.trace is None:
        return None
    try:
        from ld_decode_tpu_torch.utils import spans
    except ImportError:
        return None
    return spans.records() or None


def _ms(values: Sequence[int]) -> Optional[float]:
    """The median of durations in nanoseconds, in ms (None if empty)."""
    return statistics.median(values) / 1e6 if values else None


def median_ms(run, name: str) -> Optional[float]:
    """The median wall time of the records named `name`, ms."""
    recs = records(run)
    if recs is None:
        return None
    return _ms([b - a for n, a, b, _, _ in recs if n == name])


def per_swap_ms(run, name: str) -> Optional[float]:
    """The median over the slice's segment swaps of the time each spent in
    records named `name` inside it (at any depth), ms; swaps without such
    a record are left out."""
    recs = records(run)
    if recs is None:
        return None
    inside: Dict[int, int] = {}
    for n, a, b, p, _ in recs:
        if n != name:
            continue
        while p >= 0 and recs[p][0] != 'segment.swap':
            p = recs[p][3]
        if p >= 0:
            inside[p] = inside.get(p, 0) + (b - a)
    return _ms(list(inside.values()))


def self_ms(run, name: str) -> Optional[float]:
    """The median self time of the records named `name`: each one's wall
    time less what the records directly inside it cover, ms."""
    recs = records(run)
    if recs is None:
        return None
    child = [0] * len(recs)
    for _, a, b, p, _ in recs:
        if p >= 0:
            child[p] += b - a
    return _ms([b - a - child[i] for i, (n, a, b, _, _) in enumerate(recs)
                if n == name])


def union(intervals) -> List[Tuple[float, float]]:
    """The disjoint, sorted union of (start, end) intervals."""
    out: list = []
    for a, b in sorted(intervals):
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def idle_share(run, names: Sequence[str]) -> Optional[float]:
    """The device's idle time inside the records named in `names` (their
    union less the union of the device operations clipped to it), over
    the slice's wall time."""
    recs = records(run)
    if recs is None or run.trace['window_s'] <= 0:
        return None
    spans = union((a / 1e3, b / 1e3) for n, a, b, _, _ in recs
                  if n in names)
    if not spans:
        return None
    ops = run.trace['ops']
    idle = 0.0
    for a, b in spans:
        inside = [(x, y) for x, y, *_ in ops if x < b and y > a]
        idle += b - a - Y._busy_us(inside, a, b)
    return idle / 1e6 / run.trace['window_s']


def outside_share(run, name: str) -> Optional[float]:
    """The share of the slice's wall time outside every record named
    `name`."""
    recs = records(run)
    if recs is None or run.trace['window_s'] <= 0:
        return None
    spans = union((a, b) for n, a, b, _, _ in recs if n == name)
    if not spans:
        return None
    inside = sum(b - a for a, b in spans) / 1e9
    return 1.0 - inside / run.trace['window_s']
