#!/usr/bin/env python3
"""Where the time goes on the card: the PyTorch port's main path
(Framer, batch 16, nblocks 52, NTSC at 40 MSa/s) under torch.profiler.

    python3 scripts/profile_torch.py [--frames 16] [--trace out.json]

Prints the card's name and power limit, the sustained rate of the profiled
window, the device's busy and idle share (summed kernel and copy time over
the window's wall time; the port runs on one stream), the number of kernel
launches per batch and the kernels that take the most device time.  Fails
without a CUDA device.
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

from ld_decode_tpu_torch.models import encode as E  # noqa: E402
from ld_decode_tpu_torch.ops import filters as F  # noqa: E402
from ld_decode_tpu_torch.tbc import framer as FR  # noqa: E402
from ld_decode_tpu_torch.utils.params import DecoderConfig  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--frames', type=int, default=16,
                    help='frames decoded inside the profiled window')
    ap.add_argument('--trace', default=None,
                    help='write a Chrome trace of the window here')
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit('no CUDA device: this script profiles the card only')
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0])

    cfg = DecoderConfig(system='NTSC', freq_mhz=40.0)
    nwarm = 16
    cap = E.encode_frames(cfg, nwarm + args.frames + 8,
                          E.EncodeSpec(pattern='ramp', cav_start_frame=900))
    bank = F.make_demod_bank(cfg, np.complex64, device='cuda')
    fr = FR.Framer(cfg, bank, capture=cap, batch=16, nblocks=52,
                   device='cuda')
    rv = fr.readframe(None, 33046, True)
    for _ in range(nwarm):
        rv = fr.readframe(None, rv[2], False)
    torch.cuda.synchronize()

    stats0 = dict(fr.prefetcher.stats)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(args.frames):
            rv = fr.readframe(None, rv[2], False)
            if rv[0] is None:
                sys.exit('capture ended inside the profiled window')
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    batches = fr.prefetcher.stats['batches'] - stats0['batches']

    spf = cfg.freq_hz / cfg.sys.fps
    dev = [e for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in dev)
    launches = sum(e.count for e in dev)
    print(f'{args.frames} frames in {wall:.4f} s: '
          f'{args.frames * spf / wall / 1e6:.2f} MSa/s; {batches} batches '
          f'dispatched in the window')
    print(f'device busy {busy_us / 1e3:.2f} ms of {wall * 1e3:.2f} ms wall: '
          f'idle share {1 - busy_us / 1e6 / wall:.4f}')
    print(f'device ops {launches} ({launches / max(batches, 1):.0f} per '
          f'batch), mean {busy_us / max(launches, 1):.2f} us each')
    print(f'{"kernel":70s} {"count":>7s} {"total ms":>9s} {"share":>6s}')
    for e in sorted(dev, key=lambda e: -e.self_device_time_total)[:20]:
        print(f'{e.key[:70]:70s} {e.count:7d} '
              f'{e.self_device_time_total / 1e3:9.3f} '
              f'{e.self_device_time_total / max(busy_us, 1):6.3f}')
    host = sorted((e for e in prof.key_averages()
                   if e.device_type == DeviceType.CPU),
                  key=lambda e: -e.self_cpu_time_total)[:12]
    print(f'{"host op":70s} {"count":>7s} {"self ms":>9s}')
    for e in host:
        print(f'{e.key[:70]:70s} {e.count:7d} '
              f'{e.self_cpu_time_total / 1e3:9.3f}')
    if args.trace:
        prof.export_chrome_trace(args.trace)


if __name__ == '__main__':
    main()
