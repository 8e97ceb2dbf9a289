#!/usr/bin/env python3
"""Does the port's stage-2 audio filter (audio/stage2.py) give the same
values for a field whatever the number of fields in the call?

The sharded batch pipeline (parallel/mesh.py) decodes 8 fields a rank
where the single-rank batch decodes 16, so a stage that depends on the
call's batch width moves the sharded audio.  On the card this runs the
stage at the batch pipeline's shapes (NTSC nblocks 52, PAL nblocks 56;
random stage-1 audio: the transforms' plans depend on the shapes only)
and compares, for each step of it (block gather, rfft, the LPF product,
irfft, the assembly), the 16-field call with two 8-field calls on the
same rows.  It then finds the smallest transform batch (rows of one
transform call) at which each transform stops agreeing row for row with
single-row calls, and times `audio_stage2` per batch.

    python3 scripts/audio_batch_probe_torch.py [--device cuda]

Prints the card's name and power limit first.  With --device cpu it runs
the same comparison on the CPU (pocketfft)."""

import argparse
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from ld_decode_tpu_torch.audio import stage2 as S2  # noqa: E402
from ld_decode_tpu_torch.ops import filters as F  # noqa: E402
from ld_decode_tpu_torch.utils.params import DecoderConfig  # noqa: E402

ROWS = (1, 2, 4, 8, 16, 24, 32, 40, 48, 56, 64, 96, 128)


def _diff(a, b) -> str:
    d = (a - b).abs()
    return (f'max|d| {float(d.max()):.3e}, {int((d != 0).sum())} of '
            f'{d.numel()} differ')


def _halves(fn, x):
    h = x.shape[0] // 2
    return torch.cat([fn(x[:h]), fn(x[h:])])


def _row_invariance(name, fn, flat):
    """Rows of fn(flat[:r]) against fn(flat[k:k+1]) one row a call."""
    single = torch.cat([fn(flat[k:k + 1]) for k in range(flat.shape[0])])
    first = None
    for r in ROWS:
        if r > flat.shape[0]:
            break
        d = float((fn(flat[:r]) - single[:r]).abs().max())
        if d and first is None:
            first = r
        print(f'  {name} batch of {r} rows vs one row a call: max|d| {d:.3e}')
    print(f'  {name}: first batch that departs: {first}')


def probe(system: str, nblocks: int, dev: str):
    cfg = DecoderConfig(system=system, freq_mhz=40.0)
    bank = F.make_demod_bank(cfg, np.complex64, device=dev)
    n = nblocks * bank.a_stage1_keep
    blocklen, askip, fdiv2 = 16384, 64, bank.a_fdiv2
    starts, sjump = S2._block_starts(n, blocklen, askip, fdiv2)
    nb = len(starts)
    nbins = blocklen // (fdiv2 * 2) + 1
    outlen = blocklen // fdiv2
    lpf = bank.a_lpf2_os[:nbins]
    print(f'{system}: nblocks {nblocks}, stage-1 audio {n} samples a field, '
          f'{nb} blocks of {blocklen} a field, fdiv2 {fdiv2}')
    gen = torch.Generator(device='cpu').manual_seed(7)
    x = (torch.randn(16, n, generator=gen) * 1e5).to(dev)

    full = S2.audio_stage2(x, x, bank, n)[0]
    print(f'  audio_stage2, 16 fields vs 2 x 8: '
          + _diff(full, _halves(lambda t: S2.audio_stage2(
              t, t, bank, n)[0], x)))
    j = torch.arange(nb, device=dev)
    st = torch.where(j == nb - 1, starts[-1], j * sjump)
    idx = (st[:, None] + torch.arange(blocklen, device=dev)).clamp(0, n - 1)
    blocks = x.index_select(-1, idx.reshape(-1)).reshape(16, nb, blocklen)
    spec_full = torch.fft.rfft(blocks)
    print(f'  rfft n={blocklen} on (16, {nb}) vs 2 x (8, {nb}): '
          + _diff(spec_full, _halves(torch.fft.rfft, blocks)))
    prod = spec_full[..., :nbins] * lpf
    print(f'  LPF product, 16 vs 2 x 8: ' + _diff(
        prod, _halves(lambda t: t[..., :nbins] * lpf, spec_full)))
    out = torch.fft.irfft(prod, outlen)
    print(f'  irfft n={outlen} from {nbins} bins on (16, {nb}) vs 2 x '
          f'(8, {nb}): '
          + _diff(out, _halves(lambda t: torch.fft.irfft(t, outlen), prod)))
    _row_invariance(f'rfft n={blocklen}', torch.fft.rfft,
                    blocks.reshape(-1, blocklen))
    _row_invariance(f'irfft n={outlen}',
                    lambda t: torch.fft.irfft(t, outlen),
                    prod.reshape(-1, nbins).contiguous())

    if dev == 'cuda':
        for B in (16, 8):
            xb = x[:B].contiguous()
            S2.audio_stage2(xb, xb, bank, n)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(20):
                S2.audio_stage2(xb, xb, bank, n)
            torch.cuda.synchronize()
            print(f'  audio_stage2 at {B} fields (both channels): '
                  f'{(time.perf_counter() - t0) / 20 * 1e3:.4f} ms a call')


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--device', default='cuda')
    a = ap.parse_args()
    if a.device == 'cuda':
        if not torch.cuda.is_available():
            sys.exit('no CUDA device (use --device cpu)')
        print(subprocess.run(
            ['nvidia-smi', '--query-gpu=name,power.limit',
             '--format=csv,noheader'], capture_output=True,
            text=True).stdout.strip())
        print(f'torch {torch.__version__}, CUDA {torch.version.cuda}')
    for system, nblocks in (('NTSC', 52), ('PAL', 56)):
        probe(system, nblocks, a.device)


if __name__ == '__main__':
    main()
