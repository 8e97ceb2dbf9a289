"""Spans: named, nested timers of the host's layers of the decode, on the
profiler's clock.

    from ld_decode_tpu_torch.utils.spans import span
    with span('segment.swap') as sp:
        ...
    sp.seconds              # its wall time, once it has closed

Every span adds to its name's count, total seconds and self seconds (its
wall time less what the spans directly inside it cover): `totals()`.  That
is all a span does while no torch profiler runs: it touches no device and
calls no operator.

While a `torch.profiler` session runs (torch's own flag,
`torch.autograd.profiler._is_profiler_enabled`, read as a Python value), a
span also opens a `record_function` of its name, so it shows in the trace
beside the kernels it launched, and keeps a record (name, start_ns, end_ns,
parent, frame) in a ring of the last RING spans: `records()`.  Its times
are `perf_counter_ns()` plus an offset fixed at import: the Unix-epoch
nanoseconds of the profiler's own host events, so a record lines up with
the trace's host events (and its device operations, as far as the
trace's device times are right), and a step of the wall clock cannot
bend it.  `parent` is the index in `records()` of the record the span lies in
(-1 at the root, or where that record has left the ring); `frame` is the
number of the recorded `frame` span it lies in, which all the spans of one
decoded frame share (-1 outside every frame; a `frame` span inside another
keeps its number).

Like utils/log.py, dependency-free and global-state-minimal.  Spans nest
on a stack of their thread's own, so a span opened on another thread (the
Framer's read-ahead, tbc/framer.py) lies under that thread's open spans
and never under the decode's: a root span there has `parent` -1 and
`frame` -1.  The totals and the ring are kept under one lock, so spans
closing on two threads at once lose no count and no record.
"""

from __future__ import annotations

import sys
import threading
import time
from typing import Dict, List, Tuple

RING = 1 << 16

_now = time.perf_counter_ns
_OFFSET_NS = time.time_ns() - time.perf_counter_ns()

_totals: Dict[str, List[int]] = {}   # name -> [count, total_ns, self_ns]
_ring: list = [None] * RING          # a record, or None while it is open
_opened = 0                          # records opened so far
_frames = 0                          # frame numbers handed out
_local = threading.local()           # .top: the thread's innermost span
_lock = threading.Lock()             # over _totals, _ring, _opened, _frames
_autograd = None                     # torch.autograd.profiler once loaded


def _profiler():
    """torch.autograd.profiler where torch is loaded, else None (no
    profiler can run without torch)."""
    global _autograd
    _autograd = sys.modules.get('torch.autograd.profiler')
    return _autograd


class span:
    """`with span(name):` times its body; see the module docstring."""

    __slots__ = ('name', '_wall', '_t0', '_child', '_up', '_frame', '_rec',
                 '_rf')

    def __init__(self, name: str):
        self.name = name
        self._wall = 0

    @property
    def seconds(self) -> float:
        """The span's wall time, once it has closed."""
        return self._wall * 1e-9

    def __enter__(self) -> 'span':
        local = _local
        up = self._up = getattr(local, 'top', None)
        self._child = 0
        self._rf = None
        prof = _autograd or _profiler()
        if prof is not None and prof._is_profiler_enabled:
            self._record(prof, up)
        local.top = self
        self._t0 = _now()
        return self

    def _record(self, prof, up):
        """Open the span's record and its record_function."""
        global _frames, _opened
        frame = up._frame if up is not None and up._rf is not None else -1
        with _lock:
            if frame < 0 and self.name == 'frame':
                frame = _frames
                _frames += 1
            self._rec = _opened
            _ring[_opened % RING] = None
            _opened += 1
        self._frame = frame
        self._rf = prof.record_function(self.name)
        self._rf.__enter__()

    def __exit__(self, et, ev, tb) -> bool:
        t1 = _now()
        wall = self._wall = t1 - self._t0
        up = _local.top = self._up
        if up is not None:
            up._child += wall
        if self._rf is not None:
            self._rf.__exit__(None, None, None)
        with _lock:
            t = _totals.get(self.name)
            if t is None:
                t = _totals[self.name] = [0, 0, 0]
            t[0] += 1
            t[1] += wall
            t[2] += wall - self._child
            if self._rf is not None and _opened - self._rec <= RING:
                _ring[self._rec % RING] = (
                    self.name, self._t0 + _OFFSET_NS, t1 + _OFFSET_NS,
                    up._rec if up is not None and up._rf is not None
                    else -1, self._frame)
        return False


def totals() -> Dict[str, Tuple[int, float, float]]:
    """name -> (count, total seconds, self seconds) of every span closed
    since the start or the last `reset()`."""
    with _lock:
        return {k: (c, tot * 1e-9, own * 1e-9)
                for k, (c, tot, own) in _totals.items()}


def records() -> List[Tuple[str, int, int, int, int]]:
    """The closed spans of the ring, in the order they opened, as (name,
    start_ns, end_ns, parent, frame); `parent` an index into this list."""
    with _lock:
        opened, ring = _opened, list(_ring)
    out, pos = [], {}
    for n in range(max(0, opened - RING), opened):
        r = ring[n % RING]
        if r is None:
            continue
        name, a, b, parent, frame = r
        pos[n] = len(out)
        out.append((name, a, b, pos.get(parent, -1), frame))
    return out


def reset() -> None:
    """Forget every total and record, and every thread's open spans
    (tests)."""
    global _opened, _frames, _local
    with _lock:
        _totals.clear()
        _ring[:] = [None] * RING
        _opened = 0
        _frames = 0
        _local = threading.local()
