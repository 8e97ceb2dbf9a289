#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Phases, in order (any failure exits nonzero; there is no CPU fallback):
  1. device: card name and power limit, torch and CUDA versions;
  2. build: the hand-written CUDA kernel(s) from ld_decode_tpu_torch/csrc;
  3. kernel vs plain PyTorch version on the card, at the main path's
     shapes, with CUDA-event timings of both;
  4. main path: a 48-frame synthetic NTSC capture decoded by the port's
     Framer (batch 16, nblocks 52) from sample 33046 -- >= 32 frames with
     consecutive CAV frame numbers, kernel launches counted;
  5. one field batch on the card vs on the CPU (plain versions) from the
     same locked start, then once more under sync-debug "error" mode;
  6. the CLI (lddecode_torch.py) on a 10-frame .r16 capture.
The line before the last is the kernel JSON; the last line is the result.
"""

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
RNG_SEED = 1234
K1_TOL_MAX = 1e-2      # kernel vs plain: max |d| (tests/test_pallas_resample)
K1_TOL_MEAN = 1e-4     # kernel vs plain: mean |d|


def fail(msg: str):
    print(f'FAIL: {msg}', flush=True)
    sys.exit(1)


def phase(name: str):
    print(f'== {name}', flush=True)


def device_phase(torch):
    phase('1 device')
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, timeout=60)
    if smi.returncode != 0:
        fail(f'nvidia-smi: {smi.stderr.strip()}')
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    print(f'torch {torch.__version__} cuda {torch.version.cuda} '
          f'device {torch.cuda.get_device_name(0)} '
          f'count {torch.cuda.device_count()}')
    return card


def build_phase():
    phase('2 build')
    from ld_decode_tpu_torch.tbc import cuda_resample as CR
    from ld_decode_tpu_torch.utils import cuda_build
    t0 = time.perf_counter()
    CR._lib()
    info = cuda_build.BUILDS['resample_lines']
    print(f'resample_lines.cu: built in {info.seconds:.2f} s '
          f'(load {time.perf_counter() - t0:.2f} s) -> {info.path}')
    for line in info.log.splitlines():
        if 'registers' in line or 'spill' in line:
            print('  ptxas:', line.strip())


def _event_ms(torch, fn, reps: int = 20):
    """Median per-call device time of fn() over `reps` timed calls."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def kernel_phase(torch, np):
    phase('3 kernel vs plain on the card')
    from ld_decode_tpu_torch.tbc import cuda_resample as CR
    rng = np.random.default_rng(RNG_SEED)
    cases = [
        # name, B, nsamp, nlines, W, linelen, col0, ncols
        ('ntsc picture', 16, 52 * 15328, 263, 910, 2542.0, 0, None),
        ('ntsc burst window', 16, 52 * 15328, 263, 910, 2542.0, 16, 48),
        ('pal-width picture', 16, 56 * 15328, 313, 1135, 2560.0, 0, None),
    ]
    results = {}
    for name, B, nsamp, nlines, W, linelen, col0, ncols in cases:
        data = torch.from_numpy(rng.standard_normal(
            (B, nsamp), dtype=np.float32)).cuda()
        ll = (np.arange(nlines + 4) * linelen + 1500.0
              + np.cumsum(rng.uniform(-1, 1, nlines + 4)) * 0.2)
        ll = ll[None] + rng.uniform(0, 200, (B, 1))
        lli = torch.from_numpy(np.floor(ll).astype(np.int32)).cuda()
        llf = torch.from_numpy((ll - np.floor(ll)).astype(np.float32)).cuda()
        args = (data, lli, llf, W, nlines, linelen)
        kw = dict(col0=col0, ncols=ncols)
        got = CR.resample_lines_batch(*args, **kw)
        ref = CR.resample_lines_batch_plain(*args, **kw)
        torch.cuda.synchronize()
        if got.shape != ref.shape:
            fail(f'{name}: shape {tuple(got.shape)} vs {tuple(ref.shape)}')
        d = (got - ref).abs()
        dmax, dmean = float(d.max()), float(d.mean())
        exact = bool(torch.equal(got, ref))
        ms = _event_ms(torch, lambda: CR.resample_lines_batch(*args, **kw))
        plain_ms = _event_ms(
            torch, lambda: CR.resample_lines_batch_plain(*args, **kw))
        print(f'{name}: out {tuple(got.shape)} max|d| {dmax:.3e} '
              f'mean|d| {dmean:.3e} bit-equal {exact} kernel {ms:.4f} ms '
              f'plain {plain_ms:.4f} ms')
        if not (dmax < K1_TOL_MAX and dmean < K1_TOL_MEAN):
            fail(f'{name}: kernel disagrees with the plain version '
                 f'(max {dmax}, mean {dmean})')
        results[name] = dict(max_abs_err=dmax, ms=ms, plain_ms=plain_ms)
    return results


def main_path_phase(torch, np):
    phase('4 main path')
    from ld_decode_tpu_torch.models import encode as E
    from ld_decode_tpu_torch.utils.params import DecoderConfig
    from ld_decode_tpu_torch.ops import filters as F
    from ld_decode_tpu_torch.tbc import cuda_resample as CR
    from ld_decode_tpu_torch.tbc import framer as FR

    cfg = DecoderConfig(system='NTSC', freq_mhz=40.0)
    t0 = time.perf_counter()
    cap = E.encode_frames(cfg, 48, E.EncodeSpec(pattern='ramp',
                                                cav_start_frame=900))
    print(f'synthesized 48 frames ({cap.shape[0]} samples) in '
          f'{time.perf_counter() - t0:.1f} s')
    bank = F.make_demod_bank(cfg, np.complex64, device='cuda')

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    CR.resample_lines_batch.launches = 0
    fr = FR.Framer(cfg, bank, capture=cap, batch=16, nblocks=52,
                   device='cuda')
    t0 = time.perf_counter()
    rv = fr.readframe(None, 33046, True)
    if rv[0] is None:
        fail('warm-up frame did not decode')
    print(f'warm-up frame {fr.vbi.get("framenr")} in '
          f'{time.perf_counter() - t0:.2f} s')
    sample = rv[2]
    frames = []
    spf = cfg.freq_hz / cfg.sys.fps
    t0 = time.perf_counter()
    while len(frames) < 40:
        rv = fr.readframe(None, sample, False)
        if rv[0] is None:
            break
        frames.append(fr.vbi.get('framenr'))
        if rv[0].shape != (525 * 910,) or rv[1] is None or not len(rv[1]):
            fail(f'frame {len(frames)}: picture {rv[0].shape}, no audio')
        sample = rv[2]
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = CR.resample_lines_batch.launches
    st = fr.prefetcher.stats
    print(f'decoded {len(frames)} frames in {dt:.3f} s: '
          f'{len(frames) * spf / dt / 1e6:.2f} MSa/s sustained '
          f'({len(frames) / dt:.2f} frames/s; capture rate 40 MSa/s)')
    print(f'CAV frame numbers {frames[0]}..{frames[-1] if frames else None}')
    print(f'peak device memory {torch.cuda.max_memory_allocated() / 2**20:.1f}'
          f' MiB')
    print('prefetcher stats', json.dumps(
        {k: (round(v, 4) if isinstance(v, float) else v)
         for k, v in st.items()}))
    if len(frames) < 32:
        fail(f'only {len(frames)} frames decoded')
    if any(b != a + 1 for a, b in zip(frames, frames[1:])) \
            or frames[0] is None:
        fail(f'CAV frame numbers not consecutive: {frames}')
    expect = 3 * (st['batches'] + st['seq_decoded'])
    print(f'K1 launches {launches}: 3 per batch x {st["batches"]} batches '
          f'+ 3 per sequential field x {st["seq_decoded"]}')
    if launches != expect or launches == 0:
        fail(f'K1 launches {launches}, expected {expect}')
    return cfg, cap, bank, fr, launches


def parity_phase(torch, np, cfg, cap, bank, fr):
    phase('5 card vs cpu, one batch')
    from ld_decode_tpu_torch.ops import filters as F
    from ld_decode_tpu_torch.tbc import fused as FU

    fr.prefetcher.flush()
    f0, rs0, _ = fr.readfield(None, 33046)
    rs0 = int(f0.readsample if f0.readsample >= 0 else rs0)
    nblk, batch = 52, 4
    n_audio1 = nblk * bank.a_stage1_keep
    pitch = int(round(cfg.freq_hz / cfg.sys.fps / 2))
    cap_gpu = fr.prefetcher.capture
    cap_cpu = cap_gpu.cpu()
    bank_cpu = F.make_demod_bank(cfg, np.complex64, device='cpu')
    outs = {}
    for name, c, b in (('cuda', cap_gpu, bank), ('cpu', cap_cpu, bank_cpu)):
        out, ns, no = FU.field_pipeline_batch(c, rs0, 0.0, 1.0, b, cfg, nblk,
                                              n_audio1, batch, pitch)
        outs[name] = {k: v.cpu().numpy() for k, v in out.items()}
        outs[name]['next'] = (int(ns), float(no))
    g, c = outs['cuda'], outs['cpu']
    for key in ('meta_i', 'audio_count', 'philips_nib', 'philips_ok',
                'next'):
        if not np.array_equal(np.asarray(g[key]), np.asarray(c[key])):
            fail(f'integer decision {key} differs: cuda {g[key]} '
                 f'cpu {c[key]}')
    if not g['meta_i'][:, 0].all():
        fail(f'batch fields not valid: {g["meta_i"][:, 0]}')
    ll = lambda o: o['linelocs_i'].astype(np.float64) + o['linelocs_f']
    dll = float(np.abs(ll(g) - ll(c)).max())
    dpic = np.abs(g['picture'][:, 24:].astype(np.int64)
                  - c['picture'][:, 24:].astype(np.int64))
    p999, pmax = float(np.percentile(dpic, 99.9)), int(dpic.max())
    arms = []
    for b in range(batch):
        n = (int(g['audio_count'][b]) - 1) * 2
        da = g['audio'][b, :n].astype(np.float64) - c['audio'][b, :n]
        arms.append(float(np.sqrt(np.mean(da ** 2))))
    print(f'linelocs max|d| {dll:.2e} px; picture rows>=24 p99.9 {p999} '
          f'max {pmax} LSB; audio rms {max(arms):.3f} LSB; meta, audio '
          f'counts, Philips codes and chain scalars equal')
    if dll > 0.02 or p999 > 2 or pmax > 4 or max(arms) > 0.6:
        fail('card vs cpu outside the budgets (0.02 px, 2/4 LSB, 0.6 LSB)')

    dev = cap_gpu.device
    start0 = torch.full((), rs0, dtype=torch.int32, device=dev)
    off0 = torch.full((), 0.0, dtype=torch.float32, device=dev)
    mtf = torch.full((), 1.0, dtype=torch.float32, device=dev)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode('error')
    try:
        out, ns, no = FU.field_pipeline_batch(cap_gpu, start0, off0, mtf,
                                              bank, cfg, nblk, n_audio1,
                                              batch, pitch)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    if not np.array_equal(out['meta_i'].cpu().numpy(), g['meta_i']):
        fail('sync-debug run gave other meta words')
    print('sync-debug "error" run: no host synchronization inside '
          'field_pipeline_batch')


def cli_phase(np, cap, cfg):
    phase('6 cli')
    spf = int(cfg.freq_hz / cfg.sys.fps) + 1
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, 'build')) as d:
        path = os.path.join(d, 'cap.r16')
        (cap[:10 * spf].astype(np.int32) - 32768).astype('<i2').tofile(path)
        out = os.path.join(d, 'out')
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable,
                               os.path.join(ROOT, 'lddecode_torch.py'),
                               path, out, '-l', '8', '-q'],
                              capture_output=True, text=True, cwd=ROOT,
                              timeout=600)
        dt = time.perf_counter() - t0
        if proc.returncode != 0:
            fail(f'lddecode_torch.py exit {proc.returncode}:\n'
                 f'{proc.stderr[-3000:]}')
        tbc = os.path.getsize(out + '.tbc')
        pcm = os.path.getsize(out + '.pcm')
        print(f'lddecode_torch.py -l 8: {dt:.1f} s, .tbc {tbc} bytes, '
              f'.pcm {pcm} bytes')
        if tbc != 8 * 525 * 910 * 2 or pcm <= 0:
            fail(f'.tbc {tbc} bytes (want {8 * 525 * 910 * 2}), .pcm {pcm}')


def main():
    try:
        import numpy as np
        import torch
    except ImportError as e:
        fail(f'import: {e}')
    if not torch.cuda.is_available():
        fail('no CUDA device: this script runs the port on the card only')
    sys.path.insert(0, ROOT)
    try:
        import ld_decode_tpu_torch  # noqa: F401
    except ImportError as e:
        fail(f'the ld_decode_tpu_torch package is not beside this script: '
             f'{e}')
    if 'jax' in sys.modules:
        fail('jax was imported')
    os.makedirs(os.path.join(ROOT, 'build'), exist_ok=True)

    device_phase(torch)
    build_phase()
    kres = kernel_phase(torch, np)
    cfg, cap, bank, fr, launches = main_path_phase(torch, np)
    parity_phase(torch, np, cfg, cap, bank, fr)
    cli_phase(np, cap, cfg)
    if 'jax' in sys.modules:
        fail('jax was imported')

    pic = kres['ntsc picture']
    print(json.dumps({'kernels': [{
        'name': 'resample_lines_batch', 'route': 'cuda',
        'source': 'ld_decode_tpu_torch/csrc/resample_lines.cu',
        'replaces': 'ld_decode_tpu/tbc/pallas_resample.py:205',
        'launches': launches, 'max_abs_err': pic['max_abs_err'],
        'ms': pic['ms'], 'plain_ms': pic['plain_ms']}]}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    main()
