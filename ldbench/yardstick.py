"""The benchmark's fixed arithmetic: the card's published peaks, a kernel's
least time, K1's bytes from its shapes, the device's busy time from a
profiler trace, and the card's name and power limit.

Frozen copies, from commit 84674a0: `_busy_us` and `device_info` of
bench_torch.py, `HBM_BYTES_S`, `F32_FLOP_S`, `_bound` and `_k1_bytes` of
chip_smoke.py (K1's bytes taken from the shapes of its tables rather than
from tensors, the same count).  The trace reduction is new: it reads the
profiler's raw event list, which is far quicker than `prof.events()` on a
batch call's thousands of kernels, and leaves out the benchmark source's
own device work.
"""

from __future__ import annotations

import bisect
import subprocess
from collections import defaultdict
from typing import Dict, List, Sequence, Tuple

HBM_BYTES_S = 3.35e12  # H100 SXM memory rate (NVIDIA data sheet)
F32_FLOP_S = 67e12     # H100 SXM float32 outside the tensor cores


def _busy_us(intervals, lo=None, hi=None) -> float:
    """Microseconds of the union of (start, end) intervals, within [lo, hi]
    where given (a kernel and a copy that overlap count once)."""
    busy, end = 0.0, None
    for a, b in sorted(intervals):
        if lo is not None:
            a, b = max(a, lo), min(b, hi)
        if b <= a:
            continue
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    return busy


def device_info(device) -> dict:
    """The card's name and power limit as nvidia-smi reports them, and the
    device count."""
    import torch
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, timeout=60, check=True)
    idx = device.index or 0
    name, limit = [x.strip() for x in
                   smi.stdout.strip().splitlines()[idx].split(',')]
    return {'name': name, 'power_limit': limit,
            'count': torch.cuda.device_count()}


def _bound(nbytes: int, flops: int):
    """Least time for the work on this card, ms: bytes at the memory rate
    or operations at the float32 rate, whichever is longer."""
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = flops / F32_FLOP_S * 1e3
    return (t_bytes, 'bytes') if t_bytes >= t_ops else (t_ops, 'operations')


def k1_bytes(batch: int, nlines: int, ncols: int, outwidth: int,
             steplen: float, table_width: int) -> int:
    """Bytes a K1 call must move (chip_smoke.py's `_k1_bytes`): the demod
    samples under the output columns of each line (with the 4 taps), the
    two line tables, the output once; lines of the nominal length."""
    span = batch * nlines * (steplen * ncols / outwidth + 4)
    return int(4 * (span + 2 * batch * table_width
                    + batch * nlines * ncols))


def k1_least_ms(batch: int, nlines: int, ncols: int, outwidth: int,
                steplen: float, table_width: int) -> float:
    nbytes = k1_bytes(batch, nlines, ncols, outwidth, steplen, table_width)
    return _bound(nbytes, 30 * batch * nlines * ncols)[0]


# ---------------------------------------------------------------- traces

def trace_events(prof):
    """(device operations [(start_us, end_us, name, stream, correlation)],
    host ranges [(start_us, end_us, name)] of the benchmark's own
    `ldbench.*` record_function ranges, launches [(start_us,
    correlation)] of the host's runtime calls) of a finished torch.profiler
    run, from its raw event list."""
    from torch.autograd import DeviceType
    dev, host, launches = [], [], []
    for e in prof.profiler.kineto_results.events():
        a, b, name = e.start_ns() / 1e3, e.end_ns() / 1e3, e.name()
        if e.device_type() == DeviceType.CUDA:
            if not e.is_user_annotation():
                dev.append((a, b, name, e.device_resource_id(),
                            e.correlation_id()))
        elif name.startswith('ldbench.'):
            host.append((a, b, name))
        elif e.correlation_id():
            launches.append((a, e.correlation_id()))
    dev.sort()
    host.sort()
    launches.sort()
    return dev, host, launches


def split_source_ops(dev, host, launches):
    """(the benchmark source's device operations, the others as (start_us,
    end_us, name)): the source's are those launched inside its
    `ldbench.source` ranges, and every operation on the streams they ran
    on, which are the source's own."""
    ranges = [(a, b) for a, b, name in host if name == 'ldbench.source']
    starts = [r[0] for r in ranges]
    mine = set()
    for t, corr in launches:
        i = bisect.bisect_right(starts, t) - 1
        if i >= 0 and t <= ranges[i][1]:
            mine.add(corr)
    streams = {d[3] for d in dev if d[4] in mine}
    src = [d for d in dev if d[3] in streams]
    rest = [d[:3] for d in dev if d[3] not in streams]
    return src, rest


def idle_gaps(dev: Sequence[Tuple[float, float, str]], lo: float, hi: float
              ) -> List[Tuple[float, float]]:
    """The spans of [lo, hi] in which no device operation ran."""
    gaps, end = [], lo
    for a, b, _ in dev:
        a, b = max(a, lo), min(b, hi)
        if b <= a:
            continue
        if a > end:
            gaps.append((end, a))
        end = max(end, b)
    if hi > end:
        gaps.append((end, hi))
    return gaps


def label_gaps(gaps, host) -> Dict[str, float]:
    """Idle seconds by the innermost benchmark range the host was in when
    each gap began ('host' outside all of them).  The source's own range
    names no gap: one that begins while it makes bytes is the loader's,
    which waits on it as it would on a disk."""
    host = [h for h in host if h[2] != 'ldbench.source']
    starts = [h[0] for h in host]
    out: Dict[str, float] = defaultdict(float)
    for a, b in gaps:
        i = bisect.bisect_right(starts, a) - 1
        label = 'host'
        best = None
        for k in range(i, max(i - 256, -1), -1):
            s, e, name = host[k]
            if e >= a and (best is None or s > best):
                best, label = s, name
        out[label] += (b - a) / 1e6
    return dict(out)


def top_ops(dev, lo: float, hi: float, n: int = 10
            ) -> List[Tuple[str, float]]:
    """The device operations that took most time in [lo, hi], seconds, by
    name (a kernel's name cut to 160 characters)."""
    tot: Dict[str, float] = defaultdict(float)
    for a, b, name in dev:
        a, b = max(a, lo), min(b, hi)
        if b > a:
            tot[name[:160]] += (b - a) / 1e6
    return sorted(tot.items(), key=lambda kv: -kv[1])[:n]


def slice_summary(dev, host, lo_us: float, hi_us: float) -> dict:
    """The device's side of the traced slice [lo_us, hi_us]: busy and wall
    seconds, the operations by time, the idle time by what the host was
    doing, and each operation's (start, end, name) for the kernel readers.
    `dev` are (start_us, end_us, name), `host` `trace_events`'s."""
    busy = _busy_us([(a, b) for a, b, _ in dev], lo_us, hi_us)
    gaps = idle_gaps(dev, lo_us, hi_us)
    labels = sorted(label_gaps(gaps, host).items(), key=lambda kv: -kv[1])
    return {'busy_s': busy / 1e6, 'window_s': (hi_us - lo_us) / 1e6,
            'device_ops': top_ops(dev, lo_us, hi_us),
            'idle_gaps': labels[:10],
            'ops': [d for d in dev if d[1] > lo_us and d[0] < hi_us]}
