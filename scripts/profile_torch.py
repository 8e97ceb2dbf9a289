#!/usr/bin/env python3
"""Where the time goes on the card: the PyTorch port's decode path
(Framer, batch 16, 40 MSa/s; NTSC with nblocks 52, or with --pal PAL with
nblocks 56 on a `palbars` capture) and, with --comb, one window of the
chain's dim-3 comb (NTSC: optical flow; PAL: the temporal ring), and with
--stream the two-step path: one field of the sequential decode
(Framer(loader=..., batch=1)) and one frame of the streaming comb
(NTSCComb dim 3 with flow, or PALComb dim 3), under torch.profiler.

    python3 scripts/profile_torch.py [--pal] [--frames 16] [--comb]
                                     [--stream] [--graphs]
                                     [--trace out.json]

The decode and the comb window run as the user's path runs them: each
batch call and each NTSC flow-comb window replayed as a CUDA graph
(utils/graphs.py).  --graphs profiles each of those windows twice, eager
(graphs=False) and then replayed, and adds the host's time per call
(the prefetcher's t_dispatch a batch, the comb's t_feed a window) and its
launch calls (kernel launches and graph launches) beside the device's
busy and idle share.

Prints the card's name and power limit, then for each profiled window its
wall time, the device's busy and idle share (summed kernel and copy time
over the window's wall time; the port runs on one stream), the device
operations per unit of work (per field batch for the decode, per emitted
RGB frame for the comb, per field or frame for --stream), the launches and
device time of the hand-written kernels K1 (resample_lines_kernel), K2
(take_rows_kernel, the row gather, and take_along_axis_kernel, the general
path) and K3 (cx_envelope_kernel) and the kernels that take the most
device time.  Fails without a CUDA device.
"""

import argparse
import os
import subprocess
import sys
import time

import numpy as np
import torch
from torch.autograd import DeviceType

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from ld_decode_tpu_torch.comb.batch import (  # noqa: E402
    CombWindows, NTSCCombBatch, PALCombBatch)
from ld_decode_tpu_torch.comb.comb_ntsc import (  # noqa: E402
    CombConfig, NTSCComb)
from ld_decode_tpu_torch.comb.comb_pal import (  # noqa: E402
    CombPALConfig, PALComb)
from ld_decode_tpu_torch.io.loaders import make_array_loader  # noqa: E402
from ld_decode_tpu_torch.models import encode as E  # noqa: E402
from ld_decode_tpu_torch.ops import filters as F  # noqa: E402
from ld_decode_tpu_torch.tbc import framer as FR  # noqa: E402
from ld_decode_tpu_torch.utils.params import DecoderConfig  # noqa: E402


def profiled(fn, trace=None):
    """Run fn() under the profiler; returns (wall s, device events)."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    if trace:
        prof.export_chrome_trace(trace)
    return wall, prof.key_averages()


HAND_KERNELS = (('K1 resample_lines', ('resample_lines_kernel',)),
                ('K2 take_along_axis', ('take_rows_kernel',
                                        'take_along_axis_kernel')),
                ('K3 cx_envelope', ('cx_envelope_kernel',)))


def report(label, wall, events, units, unit_name):
    dev = [e for e in events if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in dev)
    launches = sum(e.count for e in dev)
    host = [e for e in events if e.device_type == DeviceType.CPU]
    kcalls = sum(e.count for e in host if 'LaunchKernel' in e.key)
    gcalls = sum(e.count for e in host if 'GraphLaunch' in e.key)
    print(f'== {label}: {wall:.4f} s wall, {units} {unit_name}s')
    print(f'device busy {busy_us / 1e3:.2f} ms of {wall * 1e3:.2f} ms wall: '
          f'idle share {1 - busy_us / 1e6 / wall:.4f}')
    print(f'device ops {launches} ({launches / max(units, 1):.0f} per '
          f'{unit_name}), mean {busy_us / max(launches, 1):.2f} us each')
    print(f'host launch calls: {kcalls} kernel launches '
          f'({kcalls / max(units, 1):.0f} per {unit_name}), {gcalls} graph '
          f'launches')
    for kernel, names in HAND_KERNELS:
        ks = [e for e in dev if any(n in e.key for n in names)]
        n = sum(e.count for e in ks)
        t = sum(e.self_device_time_total for e in ks)
        print(f'{kernel}: {n} launches, {t / 1e3:.3f} ms device, '
              f'{t / max(n, 1):.2f} us each, {t / max(busy_us, 1):.4f} of '
              f'device time')
    print(f'{"kernel":70s} {"count":>7s} {"total ms":>9s} {"share":>6s}')
    for e in sorted(dev, key=lambda e: -e.self_device_time_total)[:20]:
        print(f'{e.key[:70]:70s} {e.count:7d} '
              f'{e.self_device_time_total / 1e3:9.3f} '
              f'{e.self_device_time_total / max(busy_us, 1):6.3f}')
    host = sorted((e for e in events if e.device_type == DeviceType.CPU),
                  key=lambda e: -e.self_cpu_time_total)[:12]
    print(f'{"host op":70s} {"count":>7s} {"self ms":>9s}')
    for e in host:
        print(f'{e.key[:70]:70s} {e.count:7d} '
              f'{e.self_cpu_time_total / 1e3:9.3f}')


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--frames', type=int, default=16,
                    help='frames decoded inside the profiled window')
    ap.add_argument('--pal', action='store_true',
                    help='profile the PAL decode (and PAL comb) instead')
    ap.add_argument('--comb', action='store_true',
                    help='also profile one comb window of 8 frames')
    ap.add_argument('--stream', action='store_true',
                    help='also profile one field of the sequential decode '
                         'and one frame of the streaming comb')
    ap.add_argument('--graphs', action='store_true',
                    help='profile the decode and comb windows eager '
                         '(graphs=False) and then replayed as CUDA graphs')
    ap.add_argument('--trace', default=None,
                    help='write a Chrome trace of the decode window here')
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit('no CUDA device: this script profiles the card only')
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0])

    system, pattern, nblocks, start = (
        ('PAL', 'palbars', 56, 2560 * 14) if args.pal
        else ('NTSC', 'ramp', 52, 33046))
    cfg = DecoderConfig(system=system, freq_mhz=40.0)
    nwarm = 16
    cap = E.encode_frames(cfg, nwarm + args.frames + 8,
                          E.EncodeSpec(pattern=pattern, cav_start_frame=900))
    bank = F.make_demod_bank(cfg, np.complex64, device='cuda')
    modes = (False, True) if args.graphs else (True,)
    for graphs in modes:
        fr, sample = decode_window(args, cfg, cap, bank, nblocks, start,
                                   nwarm, graphs)
    if args.comb:
        for graphs in modes:
            comb_window(args, cfg, cap, bank, nblocks, start, graphs)
    if args.stream:
        stream_windows(cfg, cap, bank, nblocks, start, fr, sample)


def _mode(graphs: bool) -> str:
    return 'graphs' if graphs else 'eager'


def decode_window(args, cfg, cap, bank, nblocks, start, nwarm, graphs):
    """args.frames frames of the decode after nwarm frames of warm-up (the
    graph captured), profiled; returns the Framer and its next sample."""
    fr = FR.Framer(cfg, bank, capture=cap, batch=16, nblocks=nblocks,
                   device='cuda', graphs=graphs)
    rv = fr.readframe(None, start, True)
    for _ in range(nwarm):
        rv = fr.readframe(None, rv[2], False)

    stats0 = dict(fr.prefetcher.stats)
    state = {'rv': rv}

    def decode():
        for _ in range(args.frames):
            state['rv'] = fr.readframe(None, state['rv'][2], False)
            if state['rv'][0] is None:
                sys.exit('capture ended inside the profiled window')

    wall, events = profiled(decode, args.trace)
    st = fr.prefetcher.stats
    batches = st['batches'] - stats0['batches']
    spf = cfg.freq_hz / cfg.sys.fps
    print(f'{cfg.system} decode ({_mode(graphs)}): {args.frames} frames, '
          f'{args.frames * spf / wall / 1e6:.2f} MSa/s under the profiler; '
          f't_dispatch {(st["t_dispatch"] - stats0["t_dispatch"]) / max(batches, 1) * 1e3:.3f} '
          f'ms a batch; graphs {fr.prefetcher.graphs.counts}')
    report(f'decode window ({_mode(graphs)})', wall, events, batches,
           'batch')
    return fr, state['rv'][2]


def comb_window(args, cfg, cap, bank, nblocks, start, graphs):
    """32 woven device frames of the chain, pushed through the chain's
    window loop (windows of 8, none left in flight): the first three
    windows warm the comb (NTSC: frame 0 dropped, the flow carry seeded,
    the 9-frame window's graph warmed up and captured; PAL: frame 0
    combed 2D, two frames left pending; from the second window on every
    window has the same shape, so its FFT plans and buffers exist), the
    fourth is profiled (NTSC: a replay)."""
    Y, X = cfg.sys.frame_lines, cfg.sys.outlinelen
    chain = FR.Framer(cfg, bank, capture=cap, batch=16, nblocks=nblocks,
                      device='cuda', fetch_picture=False, graphs=graphs)
    frames, s = [], start
    for i in range(32):
        rv = chain.readframe(None, s, i == 0)
        frames.append(rv[0].reshape(Y, X))
        s = rv[2]
    comb = PALCombBatch(CombPALConfig(dim=3), device='cuda') if args.pal \
        else NTSCCombBatch(CombConfig(dim=3), device='cuda', graphs=graphs)
    out = []
    windows = CombWindows(comb, 8, 0, lambda rgb, words: out.append(rgb))
    for f in frames[:24]:
        windows.push(f)
    out.clear()
    st0 = dict(comb.stats)
    wall, events = profiled(lambda: [windows.push(f)
                                     for f in frames[24:]])
    n = len(out)
    feed = comb.stats['t_feed'] - st0['t_feed']
    print(f'{cfg.system} comb ({_mode(graphs)}): {n} RGB frames, '
          f'{n / wall:.2f} frames/s under the profiler; t_feed '
          f'{feed * 1e3:.3f} ms a window; graphs '
          f'{getattr(comb, "graphs", None) and comb.graphs.counts}')
    report(f'comb window ({_mode(graphs)})', wall, events, n, 'RGB frame')


def stream_windows(cfg, cap, bank, nblocks, start, fr, sample):
    """The two-step path: one field of the sequential decode (a loader over
    the capture, after two fields of warm-up), then one frame of the
    streaming comb (after the ring and the flow carry have filled)."""
    seq = FR.Framer(cfg, bank, loader=make_array_loader(cap), batch=1,
                    nblocks=nblocks, device='cuda')
    _, _, nxt = seq.readfield(None, start)
    _, _, nxt = seq.readfield(None, nxt)
    state = {'next': nxt}

    def field():
        f, _, state['next'] = seq.readfield(None, state['next'])
        if f is None:
            sys.exit('capture ended inside the profiled field')

    wall, events = profiled(field)
    spf = cfg.freq_hz / cfg.sys.fps / 2
    print(f'{cfg.system} sequential field: {spf / wall / 1e6:.2f} MSa/s '
          f'under the profiler')
    report('sequential field', wall, events, 1, 'field')

    frames = []
    for _ in range(5):
        rv = fr.readframe(None, sample, False)
        frames.append(rv[0])
        sample = rv[2]
    comb = PALComb(CombPALConfig(dim=3), device='cuda') if cfg.system == 'PAL' \
        else NTSCComb(CombConfig(dim=3), device='cuda')
    for f in frames[:4]:
        comb.process(f)
    wall, events = profiled(lambda: comb.process(frames[4]))
    print(f'{cfg.system} streaming comb: one RGB frame, {1 / wall:.2f} '
          f'frames/s under the profiler')
    report('streaming comb frame', wall, events, 1, 'RGB frame')


if __name__ == '__main__':
    main()
