#!/usr/bin/env python3
"""Where the picture codec's encode spends its device time on the card:
ld_decode_tpu_torch/tbc/codec.py::encode_picture_payload on a batch of 16
NTSC-like fields (263 x 910, a 4fsc subcarrier over a ramp with mild
noise, from a seed), under torch.profiler.

    python3 scripts/profile_codec_torch.py [--pal] [--reps 5]

Prints the card's name and power limit, the encode's time a batch between
CUDA events (median of the reps), its summed device time a batch from the
profile, and the operations that take the most device time.  Fails
without a CUDA device.
"""

import argparse
import os
import statistics
import subprocess
import sys

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from ld_decode_tpu_torch.tbc import codec as CODEC  # noqa: E402
from ld_decode_tpu_torch.utils.params import DecoderConfig  # noqa: E402


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument('--pal', action='store_true')
    p.add_argument('--reps', type=int, default=5)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print('no CUDA device: this script measures the card only')
        return 1
    print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True).stdout.strip())
    cfg = DecoderConfig(system='PAL' if args.pal else 'NTSC')
    L, W = cfg.sys.frame_lines // 2 + 1, cfg.sys.outlinelen
    rng = np.random.default_rng(0)
    w = np.arange(W)
    line = 0x3C00 + (w * 45) % 9000 \
        + (7000 * np.sin(w * np.pi / 2 + 0.3)).astype(np.int64)
    pic = torch.from_numpy((np.tile(line, (16, L, 1))
                            + rng.integers(-40, 40, (16, L, W))
                            ).astype(np.int32)).cuda()
    for _ in range(3):
        CODEC.encode_picture_payload(pic, cfg)
    torch.cuda.synchronize()
    times = []
    for _ in range(args.reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        CODEC.encode_picture_payload(pic, cfg)
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(args.reps):
            CODEC.encode_picture_payload(pic, cfg)
        torch.cuda.synchronize()
    events = prof.key_averages()
    # the kernels' own time (an aten op's row repeats its kernels')
    device_us = sum(e.self_device_time_total for e in events
                    if e.device_type == DeviceType.CUDA)
    print(f'{cfg.system} batch of 16 ({L} x {W}): encode '
          f'{statistics.median(times):.4f} ms between CUDA events (median '
          f'of {args.reps}); device time {device_us / 1e3 / args.reps:.4f} '
          f'ms a batch')
    print(events.table(sort_by='self_device_time_total', row_limit=15))
    return 0


if __name__ == '__main__':
    sys.exit(main())
