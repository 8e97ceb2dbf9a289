"""One run of one cell: set-up, the measured window, the per-layer readings
and the verdict that decides `correct`.

Everything a cell needs is found by name: its entry in BENCHMARK.json names
its configuration (`ldbench/configs/<name>.json`) and its traffic
(`ldbench/traffic/<name>.json`, whose `entry` names the driver
`ldbench/drivers/<entry>.py`); its limits are `ldbench/limits/<cell>.json`;
each per-layer metric is read by `ldbench/metrics/<metric>.py`.

The comparison is the entry's: its `Driver` marks every frame of the window
(`mark`), hands over what its judge needs of the run (`notes`), and judges
the marks and the seeded sample of frames against its own reference
(`Driver.judge`, which returns a `Verdict`).  The harness holds the verdict
to the cell's limits.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
import subprocess
import sys
import time
from dataclasses import dataclass, field
from types import SimpleNamespace
from typing import Dict, List, Optional

import numpy as np

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
JAX_NAMES = ('jax', 'jaxlib', 'flax', 'ld_decode_tpu')


def _profiled():
    import torch
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def resolve(workload: str, root: str = ROOT) -> dict:
    """The cell `workload` of BENCHMARK.json with its configuration, its
    traffic, its limits and the metrics it reports."""
    bench = _json(os.path.join(root, 'BENCHMARK.json'))
    cells = {w['name']: w for w in bench['workloads']}
    if workload not in cells:
        raise KeyError(f'no workload {workload!r} in BENCHMARK.json')
    w = cells[workload]
    conf = next(c for c in bench['configs'] if c['name'] == w['config'])

    def applies(m):
        return 'workloads' not in m or workload in m['workloads']

    e2e = [m for m in bench['end_to_end'] if applies(m)]
    per_layer = [m for m in bench['per_layer'] if applies(m)]
    return {'name': workload, 'workload': w, 'chips': w['chips'],
            'config': _json(os.path.join(root, conf['file'])),
            'traffic': _json(os.path.join(BENCH_DIR, 'traffic',
                                          w['traffic'] + '.json')),
            'limits': _json(os.path.join(BENCH_DIR, 'limits',
                                         workload + '.json')),
            'end_to_end': e2e, 'per_layer': per_layer}


def driver_class(entry: str):
    return importlib.import_module(f'ldbench.drivers.{entry}').Driver


def metric_reader(name: str):
    path = os.path.join(BENCH_DIR, 'metrics', name + '.py')
    spec = importlib.util.spec_from_file_location(
        'ldbench_metric_' + name.replace('.', '_'), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def jax_loaded() -> List[str]:
    """The JAX modules, and the JAX package's, that the process holds."""
    return sorted({m.split('.')[0] for m in sys.modules}
                  & set(JAX_NAMES))


@dataclass
class Verdict:
    """An entry's judgement of a run: its `numbers`, keyed as the cell's
    limits; the `frames` it judged and how many `failed`, with the
    `reasons`; further readings for standard error (`extras`); and, where
    the control was asked for, the control's verdict on the same frames."""
    numbers: Dict[str, float]
    failed: int
    frames: int
    reasons: List[str] = field(default_factory=list)
    extras: Dict[str, object] = field(default_factory=dict)
    control: Optional['Verdict'] = None


class Reservoir:
    """A uniform sample of `size` items of a stream, drawn from a seed."""

    def __init__(self, size: int, seed: int):
        self.size = size
        self.items: List = []
        self.rng = np.random.default_rng([int(seed), 7])
        self.seen = 0

    def offer(self, item):
        if len(self.items) < self.size:
            self.items.append(item)
        else:
            r = int(self.rng.integers(0, self.seen + 1))
            if r < self.size:
                self.items[r] = item
        self.seen += 1


def percentile99(gaps: List[float]) -> float:
    return float(np.percentile(np.asarray(gaps), 99)) if gaps else 0.0


def run(cell: dict, seed: int, seconds: float, trace: bool, device,
        t_start: float, control: bool = False,
        tile_frames: Optional[int] = None) -> dict:
    """Run the cell once; returns the result object that run.py prints
    (the keys that begin with '_' are the run's notes for standard error).
    `control` also asks the entry's judge for the control's verdict on the
    window's sample of frames; `tile_frames` shortens the tile (tests on the CPU).

    The window starts `warmup_frames_after_swap` frames after a segment
    swap and ends, once `seconds` have passed, on the frame that lies as
    many frames after a swap: it holds a whole number of swap cycles, so
    where its end falls in the cycle does not move the rate."""
    import torch
    from ldbench.source.stream import SideStream
    from ldbench import yardstick as Y

    device = torch.device(device)
    on_card = device.type == 'cuda'
    activities = _profiled()
    traffic, conf = cell['traffic'], cell['config']
    phase = int(traffic['warmup_frames_after_swap'])
    src = SideStream(conf, seed, device, tile_frames=tile_frames)
    entry = driver_class(traffic['entry'])
    drv = entry(cell, src, device)
    drv.warm_up(phase)
    if on_card:
        torch.cuda.synchronize(device)

    prof = None
    slice_at = traffic['trace_slice'][0] * seconds
    slice_len = traffic['trace_slice'][1] * seconds
    if trace:
        drv.label_layers()
        # the profiler's first start (CUPTI's) is slow: pay it in set-up
        with torch.profiler.profile(activities=activities):
            torch.ones(1, device=device).add_(1)
    before = drv.counters()
    source_s = src.seconds
    sample = Reservoir(int(traffic['check_frames']), seed)
    marks = []          # the entry's mark of every frame
    times = []          # when each frame was on the host
    ends = []           # the stream sample after each frame
    swaps = []          # (frame index, gap) of each frame that swapped
    start_sample = drv.sample
    loads = drv.loader_calls
    since = phase       # frames since the last swap, its frame the first
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    deadline = t0 + seconds
    slice_rf = None
    profiler_s = 0.0
    while True:
        out = drv.frame()
        t = time.perf_counter()
        if drv.loader_calls != loads:
            loads = drv.loader_calls
            since = 1
            swaps.append((len(times), t - (times[-1] if times else t0)))
        else:
            since += 1
        times.append(t)
        ends.append(drv.sample)
        sample.offer(out)
        marks.append(drv.mark(out))
        if trace:
            # the traced slice: from the first frame `slice_at` into the
            # window, `slice_len` seconds from the profiler's start
            if prof is None and t - t0 >= slice_at:
                prof = torch.profiler.profile(activities=activities)
                prof.__enter__()
                slice_rf = torch.profiler.record_function('ldbench.slice')
                slice_rf.__enter__()
                t_slice = time.perf_counter()
            elif slice_rf is not None and t - t_slice >= slice_len:
                if on_card:
                    torch.cuda.synchronize(device)
                slice_rf.__exit__(None, None, None)
                t_stop = time.perf_counter()
                prof.__exit__(None, None, None)
                slice_rf = None
                # the profiler's own stop (it collects the trace) is no
                # time of the decode's
                profiler_s = time.perf_counter() - t_stop
        if t > deadline and since == phase and slice_rf is None:
            break
        if t > deadline + seconds:
            break       # no swap cycle closed in as long again
    after = drv.counters()
    source_s = src.seconds - source_s
    program_peak, device_peak = src.memory_peaks()
    notes = drv.notes()

    # the window: every frame of it, and all its time
    window_s = times[-1] - t0
    gaps = np.diff(np.asarray([t0] + times)) * 1e3
    rf_msa_s = (ends[-1] - start_sample) / window_s / 1e6

    # the per-layer shares are of the window's time less the profiler's
    reading = SimpleNamespace(window_s=window_s - profiler_s, before=before,
                              after=after, cell=cell, trace=None)
    if prof is not None:
        reading.trace = _summarise(prof, Y)
    metrics: Dict[str, dict] = {}
    if trace:
        for m in cell['per_layer']:
            v = metric_reader(m['name'])(reading)
            if v is not None:
                metrics[m['name']] = {'value': v, 'unit': m['unit']}
    else:
        values = {'rf_msa_s': rf_msa_s,
                  'frame_gap_p99_ms': percentile99(list(gaps)),
                  'peak_mem_gib': program_peak / 2 ** 30,
                  'setup_s': setup_s}
        for m in cell['end_to_end']:
            metrics[m['name']] = {'value': values[m['name']],
                                  'unit': m['unit']}

    # ---- the comparison, once the program's state is freed
    drv.release()
    del drv
    if on_card:
        torch.cuda.empty_cache()
    verdict = entry.judge(cell, src, device, marks, sample.items, notes,
                          control)
    limits = cell['limits']
    numbers, failed = verdict.numbers, verdict.failed
    correct = (failed == 0 and verdict.frames > 0
               and all(numbers[k] <= limits[k] for k in limits))

    result = {'correct': bool(correct), 'attempted': len(times),
              'failed': int(failed), 'metrics': metrics,
              'device': {'platform': 'gpu' if on_card else 'cpu',
                         'kind': (torch.cuda.get_device_name(device)
                                  if on_card else 'cpu'),
                         'count': 1, 'memory_peak_bytes': int(device_peak)}}
    if trace and reading.trace is not None:
        result['device']['busy_s'] = reading.trace['busy_s']
        result['device']['window_s'] = reading.trace['window_s']
        result['breakdown'] = {
            'device_ops': [[n, s] for n, s in reading.trace['device_ops']],
            'idle_gaps': [[n, s] for n, s in reading.trace['idle_gaps']]}
    result['checks'] = {k: {'value': numbers[k], 'limit': limits[k]}
                        for k in limits}
    result['checks']['failed_frames'] = {'value': failed, 'limit': 0}
    result['_reasons'] = verdict.reasons
    result['_source'] = {'start_frame': src.start_frame,
                         'seconds_in_window': source_s,
                         'reads_total': src.reads,
                         'resident_bytes': src.resident_bytes}
    result['_window'] = dict(
        {k: after[k] - before[k] for k in after},
        seconds=window_s, profiler_seconds=profiler_s, frames=len(times),
        whole_cycles=since == phase,
        program_peak_bytes=int(program_peak))
    result['_cycles'] = swap_cycles(swaps, times, t0)
    if reading.trace is not None:
        result['_trace'] = {k: reading.trace[k] for k in (
            'source_ops', 'source_busy_s')}
    result['_sampled_frames'] = verdict.frames
    if on_card:
        try:
            result['_card'] = Y.device_info(device)
        except (OSError, subprocess.SubprocessError, ValueError) as e:
            result['_card'] = f'nvidia-smi: {e}'
    result['_extras'] = verdict.extras
    ctl = verdict.control
    if ctl is not None:
        result['_control'] = dict(
            ctl.numbers, failed=ctl.failed, correct=ctl.failed == 0 and all(
                ctl.numbers[k] <= limits[k] for k in limits))
    return result


def swap_cycles(swaps, times, t0) -> dict:
    """The window's segment swaps: how many, the gap of each frame that
    swapped, and the seconds and frames of each whole cycle between two
    swaps (min, median, max)."""
    def mmm(x):
        return [float(np.min(x)), float(np.median(x)), float(np.max(x))] \
            if len(x) else []
    idx = [i for i, _ in swaps]
    at = [times[i] for i in idx]
    return {'swaps': len(swaps), 'swap_gap_s': mmm([g for _, g in swaps]),
            'cycle_s': mmm(np.diff(at)), 'cycle_frames': mmm(np.diff(idx))}


def _summarise(prof, Y) -> dict:
    dev, host, launches = Y.trace_events(prof)
    sl = [h for h in host if h[2] == 'ldbench.slice']
    if not sl:
        raise RuntimeError('the trace holds no ldbench.slice range')
    mine, dev = Y.split_source_ops(dev, host, launches)
    out = Y.slice_summary(dev, host, sl[0][0], sl[0][1])
    out['source_ops'] = len(mine)
    out['source_busy_s'] = Y._busy_us([(a, b) for a, b, *_ in mine],
                                      sl[0][0], sl[0][1]) / 1e6
    return out
