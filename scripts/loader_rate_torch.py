#!/usr/bin/env python3
"""The segmented .lds decode's rate on a capture longer than two of the
Framer's segments (256 M samples each by default), once per .lds unpack
route (the C++ unpack, csrc/unpack.cpp, and the numpy one).

    python3 scripts/loader_rate_torch.py [--samples 600000000]
        [--segment-samples 0] [--batch 16] [--dir build/loader_rate]
        [--device cuda] [--no-graphs]

Encodes 6 NTSC frames of the `ramp` pattern (8,008,000 samples: a whole
number of samples and of colour-subcarrier cycles), packs them 4 samples
in 5 bytes and writes them repeated into an .lds of about --samples
samples (the FM carriers' phase jumps once a repeat, a short glitch the
decode rides through).  Then, for each route, decodes the whole file
with Framer(loader=..., batch 16, nblocks 52) and prints the frames, the
file samples the decode advanced over, its wall time and MSa/s with
every segment load in it, the segment loads, the unpack's calls and
seconds (io/loaders.py's counters) and the prefetcher's t_unpack; and
the rate after the first frame (the steady state, later segment loads
in it).  At each segment load it prints the batch call's graph counts
(warm-ups, captures, replays) and, on the card, the device memory
reserved: the segments share one resident buffer, so after the first
segment neither grows.  The batch calls replay as CUDA graphs (the
Framer's default); --no-graphs runs them eagerly.  Both routes must give
the same .tbc bytes.  A 2-frame decode first builds the kernels and
plans outside the timed runs.  Prints the card's name and power limit
first; the file is removed at the end.
--segment-samples with a small --samples and --batch let the CPU
(--device cpu) run the same path."""

import argparse
import hashlib
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from ld_decode_tpu_torch.io import loaders as L  # noqa: E402
from ld_decode_tpu_torch.io import native_unpack as NU  # noqa: E402
from ld_decode_tpu_torch.models import encode as E  # noqa: E402
from ld_decode_tpu_torch.ops import filters as F  # noqa: E402
from ld_decode_tpu_torch.tbc import framer as FR  # noqa: E402
from ld_decode_tpu_torch.utils.params import DecoderConfig  # noqa: E402

TILE_FRAMES, TILE_SAMPLES = 6, 8_008_000
NBLOCKS = 52                    # the NTSC decode's field window
START = 33046                   # phase 4's first field of the ramp capture


def write_capture(cfg, path: str, samples: int) -> int:
    cap = E.encode_frames(cfg, TILE_FRAMES, E.EncodeSpec(
        pattern='ramp', cav_start_frame=900))[:TILE_SAMPLES]
    tile = L.pack_data_4_40(cap).tobytes()
    reps = max(1, -(-samples // TILE_SAMPLES))
    with open(path, 'wb') as f:
        for _ in range(reps):
            f.write(tile)
    return reps * TILE_SAMPLES


def decode(cfg, bank, path: str, a, sync, limit: int = 0):
    fr = FR.Framer(cfg, bank, loader=L.loader_for_path(path), batch=a.batch,
                   nblocks=NBLOCKS, segment_samples=a.segment_samples,
                   device=a.device, graphs=not a.no_graphs)
    loads = []
    set_capture = fr.prefetcher.set_capture
    cuda = a.device == 'cuda'

    def counted(capture, base, **kw):
        sync()
        loads.append((base, time.perf_counter(),
                      dict(fr.prefetcher.graphs.counts),
                      torch.cuda.memory_reserved() / 2**20 if cuda else 0))
        return set_capture(capture, base, **kw)

    fr.prefetcher.set_capture = counted
    digest = hashlib.sha256()
    marks = []                  # (seconds, file sample) after each frame
    with open(path, 'rb') as fd:
        sync()
        t0 = time.perf_counter()
        rv = fr.readframe(fd, START, True)
        sample = START
        while rv[0] is not None and not (limit and len(marks) >= limit):
            digest.update(np.ascontiguousarray(rv[0]).tobytes())
            sample = rv[2]
            marks.append((time.perf_counter() - t0, sample))
            rv = fr.readframe(fd, sample, False)
        sync()
        t_all = time.perf_counter() - t0
    return dict(frames=len(marks), t=t_all, span=sample - START,
                loads=[(b, t - t0, c, m) for b, t, c, m in loads],
                marks=marks, digest=digest.hexdigest(),
                stats=fr.prefetcher.stats,
                counts=dict(fr.prefetcher.graphs.counts),
                reserved=torch.cuda.memory_reserved() / 2**20 if cuda
                else 0)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--samples', type=float, default=600e6)
    ap.add_argument('--segment-samples', type=int, default=0)
    ap.add_argument('--batch', type=int, default=16)
    ap.add_argument('--dir', default=os.path.join(ROOT, 'build',
                                                  'loader_rate'))
    ap.add_argument('--device', default='cuda')
    ap.add_argument('--no-graphs', action='store_true',
                    help='run the batch calls eagerly (Framer(graphs=False))')
    a = ap.parse_args()
    if a.device == 'cuda':
        if not torch.cuda.is_available():
            sys.exit('no CUDA device (use --device cpu)')
        print(subprocess.run(
            ['nvidia-smi', '--query-gpu=name,power.limit',
             '--format=csv,noheader'], capture_output=True,
            text=True).stdout.strip())
        sync = torch.cuda.synchronize
    else:
        sync = lambda: None                                   # noqa: E731
    if not NU.available():
        sys.exit('the C++ unpack (csrc/unpack.cpp) did not build')
    cfg = DecoderConfig(system='NTSC', freq_mhz=40.0)
    bank = F.make_demod_bank(cfg, np.complex64, device=a.device)
    os.makedirs(a.dir, exist_ok=True)
    path = os.path.join(a.dir, 'long.lds')
    t0 = time.perf_counter()
    n = write_capture(cfg, path, int(a.samples))
    print(f'wrote {n} samples ({os.path.getsize(path) / 2**20:.1f} MiB of '
          f'.lds) in {time.perf_counter() - t0:.1f} s')
    digests = {}
    try:
        # warm-up outside the timed runs: the kernels' build, the
        # transforms' plans
        decode(cfg, bank, path, a, sync, limit=2)
        for route in ('native', 'numpy'):
            L.set_native(route == 'native')
            assert L.unpack_route() == route
            calls, secs = dict(L.unpack_calls), dict(L.unpack_seconds)
            r = decode(cfg, bank, path, a, sync)
            n_unpack = L.unpack_calls[route] - calls[route]
            t_unpack = L.unpack_seconds[route] - secs[route]
            digests[route] = r['digest']
            print(f'{route} unpack: {r["frames"]} frames over {r["span"]} '
                  f'file samples in {r["t"]:.3f} s: '
                  f'{r["span"] / r["t"] / 1e6:.2f} MSa/s with '
                  f'{len(r["loads"])} segment loads; unpack {n_unpack} '
                  f'calls {t_unpack:.3f} s '
                  f'({(n_unpack and r["span"] / t_unpack / 1e6) or 0:.2f} '
                  f'MSa/s); prefetcher t_unpack '
                  f'{r["stats"]["t_unpack"]:.3f} s, t_fetch '
                  f'{r["stats"]["t_fetch"]:.3f} s, batches '
                  f'{r["stats"]["batches"]}')
            print(f'  segment loads (base sample, s after the start, the '
                  f'graph counts and MiB reserved before the load): '
                  + ', '.join(f'{b} at {t:.3f} {c} {m:.1f}'
                              for b, t, c, m in r['loads'])
                  + f'; at the end {r["counts"]} {r["reserved"]:.1f}')
            # steady state: from the end of the first frame (the first
            # segment load, the warm-up and the sequential first field in
            # it) to the end, every later segment load included
            if len(r['marks']) >= 2:
                (ta, sa), (tb, sb) = r['marks'][0], r['marks'][-1]
                print(f'  after the first frame: {len(r["marks"]) - 1} '
                      f'frames, {sb - sa} samples in {tb - ta:.3f} s: '
                      f'{(sb - sa) / (tb - ta) / 1e6:.2f} MSa/s with '
                      f'{len(r["loads"]) - 1} segment loads in it')
    finally:
        L.set_native(True)
        os.remove(path)
    same = len(set(digests.values())) == 1
    print(f'.tbc bytes of both routes equal: {same}')
    if not same:
        sys.exit('the two unpack routes decoded different .tbc bytes')


if __name__ == '__main__':
    main()
