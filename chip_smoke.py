#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Phases, in order (any failure exits nonzero; there is no CPU fallback):
  1. device: card name and power limit, torch and CUDA versions;
  2. build: the hand-written CUDA kernels from ld_decode_tpu_torch/csrc,
     one nvcc per source, all started together;
  3. each kernel vs its plain PyTorch version on the card, bit for bit,
     at the main paths' shapes and at edge cases (broken line tables,
     lines past the row ends, unaligned views; both of K2's paths), with
     device times at the main shapes (L2 cold, CUDA-graph replay between
     CUDA events: MS_METHOD) of both, of the one PyTorch call that
     computes the same function where there is one, and the bound the
     card sets for this run's inputs;
  4. decode path: a 48-frame synthetic NTSC capture decoded by the port's
     Framer (batch 16, nblocks 52) from sample 33046 -- >= 32 frames with
     consecutive CAV frame numbers, K1 launches counted;
  5. one field batch on the card vs on the CPU (plain versions) from the
     same locked start, then once more under sync-debug "error" mode;
  6. the decode CLI (lddecode_torch.py) on a 10-frame .r16 capture;
  7. chain path: the same capture through Framer(fetch_picture=False) and
     the dim-3 optical-flow comb in windows of 8 with 3 in flight, through
     ldchain_torch.py's loop (comb.batch.CombWindows) -- >= 16 RGB frames
     with consecutive CAV numbers in their line-0 words, K1 and K2
     launches counted, every K2 launch on its row-gather path;
  8. one comb window of 4 device frames (a smooth texture added, so the
     flow is well posed) combed on the card and on the CPU;
  9. the chain CLI (ldchain_torch.py -l 6) on the 10-frame capture: 6
     RGB frames, and the audio of exactly the first 6 decoded frames (a
     Framer as the CLI's counts each frame's samples);
 10. PAL decode path: a 40-frame `palbars` capture through the Framer
     (batch 16, nblocks 56) from sample 2560*14 -- >= 24 frames with
     consecutive CAV numbers, K1 launched once a batch (the picture call at
     (16, 313, 1135); PAL has no burst passes);
 11. one PAL field batch on the card vs on the CPU, then under sync-debug
     "error" mode; every line of every field within 0.02 px, or a wrap
     flip of the pilot pass (tbc/pal.py::wrap_flip_lines, from each
     device's pilot-pass input run again, only where a line is past 0.02
     px: that input, the hsync stage, within 0.02 px card vs CPU) whose
     difference is its prediction to 1e-4 px; the picture rows reading a
     flipped line counted apart (lines, rows, max LSB);
 12. PAL chain path: 32 frames through Framer(fetch_picture=False) and
     the dim-3 PAL comb in CombWindows (8, 3 in flight) -- every decoded
     frame emitted once, in order (each frame is stamped with its index),
     the flush tail included; K1 counted, K2 not launched;
 13. one PAL comb window of 4 device frames on the card vs on the CPU;
 14. both CLIs with -p on a 10-frame PAL .lds capture (the chain CLI's
     audio as in phase 9);
 15. sequential decode path: the NTSC capture of phase 4 as an .lds through
     Framer(loader=..., batch=1) (nblocks 66), 4 frames on the card, 2 of
     them again on the CPU, card vs CPU to the decode budgets, K1 launched
     3 times a decoded field and never its plain version; one read with
     full_decode=False (the JAX package's fourth positional parameter):
     the fields located with the full decode's hsync-stage line locations
     and its VBI, no frame, picture or audio, no K1 launch; then PAL on the
     `palbars` capture (nblocks 56), 1 launch a field; every line of a
     field, the last 10 included, within 0.02 px card vs CPU or a wrap
     flip accounted as in phase 11 (the pilot pass's input kept from each
     decode's hsync stage), the tail rows but those reading a flip within
     4 LSB (NTSC) or PAL_TAIL_MAX (PAL);
 16. streaming comb: NTSCComb(dim=3, flow) over 6 textured frames on the
     card, K2 9 times an emitted frame, all on the row path; one frame
     card vs CPU (phase 8's budgets); the streaming against the batched
     comb with -d 2 (1 LSB); -D, -k and -l on the card vs the CPU;
 17. K3 (the CX envelope followers): the production geometry on a
     700,000-sample programme signal, kernel vs plain version on the CPU
     (bit-equal, same certificate); a decaying envelope the certificate
     refuses, and the one-lane scan that takes over; the device time of a
     1 MB chunk against its bound; CXExpander over the programme in 1 MB
     chunks, K3 counted;
 18. the two-step CLIs in-process: ldexport_torch.py -d 3 (--comb-batch 1
     and 8, -a on phase 6's .pcm repeated past 32,768 samples) on phase
     6's .tbc, ldexport_torch.py --pal -d 3 on phase 14's .tbc, and
     ldview_torch.py seeking CAV frame 902 (a 744 x 480 image);
 19. the NN comb (cuDNN, no hand kernel): TF32 shown off; NNComb() forward
     on a (1, 525, 910, 3) frame card vs CPU within 5e-5 of max|out|;
     train_nn_comb at its defaults (250 steps, batch 8, 64 x 256) below
     the loss bound 80, twice eager and twice graphed (seconds a run);
     the default run through a Trainer eager 5 times (is eager
     repeatable?) and graphed once: losses, parameters and Adam's moments
     within 2x the largest spread between eager runs (bit-equal where
     eager repeats itself), the first loss, Adam's step counts and the
     generator equal, one warm-up and one capture, ms a step both ways;
     3 train steps on identical batches card vs CPU; comb_frame_nn over
     24 frames eager and graphed (bit-equal, frames/s whole and after the
     capture, the host AGC and the graphed comb's device ms a frame) and
     card vs CPU (the comb budget); the training pairs of phase 6's .tbc
     frames card vs CPU; ldexport_torch.py -t -F writing N-2 pairs, then
     write_training_file on its frames eager and graphed (the CLI's .npz,
     seconds), and the pairs of 128 frames both ways; the device time of
     a forward;
 20. the VHS tape decode (cuFFT): a flat-50 tape capture at 8 fsc through
     decode_vhs (eager: phase 29 holds its graphs) in 4 windows of nblocks
     66, card vs CPU (luma 1 LSB, demod
     1e-6 of its scale), the levels and audio carriers, the rate in
     MSa/s; recover_color_under on 2^22 samples (correlation with the
     truth, card vs CPU); the host copies fdls, filtertools, filtermaker
     and iec60857 once each;
 21. the loader path: phase 4's capture written as an .lds, decoded
     segmented (a loader, batch 16, nblocks 52) once with the C++ unpack
     (csrc/unpack.cpp, built with g++) and once with the numpy unpack:
     the rate in MSa/s with the load, the unpack's time, the prefetcher's
     t_unpack; the .tbc frames of both equal to the resident decode's;
     fails unless the native route is the one taken where asked;
 22. the sharded decode (parallel/mesh.py over torch.distributed): worlds
     of 1 rank over NCCL and 2 ranks over gloo on the one card, each rank
     a subprocess of this script (--mesh-rank) with a timeout: the
     sharded NTSC (batch 16, nblocks 52) and PAL (batch 16, nblocks 56)
     pipelines against the single-rank batch, bit for bit except the
     audio (JAX's allowance: 1 LSB on at most 16 ticks), the chained
     scalars exact, K1 launched by every rank (NTSC the picture and 2
     burst windows a call, PAL the picture; told apart by the wrapper's
     window count, each shape held against its plain version in phase
     3); the wall time a call per rank beside the single-rank batch
     (one-card overhead, not scaling) and the peak
     device memory per rank; the sharded demod at the production
     blocklen (dp 1 x sp 2) against the unsharded demod; the sharded 3D
     comb over 16 frames against the sequential chain; three
     data-parallel NN steps against mesh=None at the CPU test's size, and
     one at the trainer's default width (loss and dp-averaged gradients);
     the compile boundary: in the 1-rank NCCL world every sharded call
     (batch call, demod, 3D comb) replays a CUDA graph and equals
     graphs=False bit for bit, K1 counts equal, host ms a call both ways
     (no collective runs in a world of one rank, so NCCL inside a capture
     is not shown on one card); the 2-rank gloo world runs eagerly;
 24. the legacy PAL comb (comb/comb_pal_legacy.py, eager: phase 29 holds
     its graphs): two seeded synthetic 1052x610 frames at dims 1, 2 and 3
     on the card vs the CPU (max 2,
     p99.9 1 LSB: the CPU test's budget against JAX), the dim-3 primer
     frame black; device time a frame;
 25. the compile boundary (utils/graphs.py), graphs vs eager in one call:
     6 chained NTSC and PAL batch calls through a GraphCache, every
     output and chained scalar bit-equal, one call's device operations
     and host launch calls and host time both ways; the NTSC and PAL
     decode paths with Framer(graphs=False) and the default graphs, the .tbc frames, .pcm audio and every
     field's line locations, burst levels and VBI bit-equal, K1 launches
     equal; the NTSC chain with flow over phase 4's capture played twice,
     RGB48 frames and words bit-equal, K1 and K2 launches equal; the
     warm-ups, captures, replays and capture seconds, t_dispatch a batch,
     MSa/s or RGB frames/s (whole runs and steady state) and peak device
     memory both ways;
 26. the sequential paths' graphs, eager then graphed in one call: the
     --batch 1 decode (NTSC and PAL .lds, Framer(loader, batch=1)) and the
     resident sequential decode (Framer(capture, batch=1): field_analyze
     and field_finish), frames, audio and every field's line locations,
     burst levels and VBI bit-equal, K1 launches equal; FieldDecoder's
     process and process_resident called with other window starts,
     mtf_level and audio_offset between calls of one key, each call
     bit-equal to eager's; lddecode_torch.py
     --batch 1 with --no-graphs and the default, .tbc and .pcm equal; the
     streaming NTSC comb (dim 3 with flow over frames of phase 4's
     capture; dim 2 with -D and -l), RGB48, words and extras bit-equal,
     K2 launches equal; ldview_torch.py's main eager (the CLI) and with
     graphs=True, the same image; MSa/s
     (whole runs and after the first frame), RGB frames/s, device
     operations and launch calls a field and a frame, host ms a call,
     capture seconds a key and peak device memory both ways;
     field_finish_batch (eager) on a 16-field NTSC and PAL batch on the
     card against the CPU (phase 5's budgets), its ms a batch and K1
     launches;
 27. the file decode across segment swaps and the last comb paths, eager
     then graphed in one call: phase 4's and phase 10's captures tiled 5
     times into one .lds each and decoded segmented (batch 16, the
     smallest segment, >= 3 swaps and a zero-padded tail), .tbc and .pcm
     bit-equal, the batch call's warm-ups and captures after the first
     segment equal to the end's, K1 launches equal, MSa/s whole and after
     the first frame, capture seconds, peak memory and the memory
     reserved at each load (it must not grow by half a segment); the
     NTSC batch comb at -F and -d 2 and the PAL batch comb at -d 3 and
     -d 2 over the woven frames of phases 7 and 12 played twice, and the
     streaming PAL comb (-d 3) over 12 of them, RGB48 and words bit-equal,
     t_feed a window or ms a frame, RGB frames/s, device ops, launch
     calls and graph launches a window, capture seconds a key;
 28. the repo's bench through the port: bench_torch.py --quick in its own
     process (each of bench.py's eight stages, one visit of one pass, on
     captures encoded for it) -- every stage's rate above 0, its checks
     held (frame numbers consecutive, every RGB frame of its shape and back
     but those the comb holds), K1 launched in every stage, K2 in the two
     flow chains and in no other stage; the rates, warm-up seconds and
     launches printed.
 29. the last compile-boundary keys, eager then graphed (the default) in
     one call: the chain's device weave with its line-0 words over 12
     chain-mode frames of each system (straddling pairs counted, every
     frame kept), field_analyze_batch / field_finish_batch on 4 16-field
     batches a system, decode_vhs over 6 windows of nblocks 66, and the
     legacy PAL comb at dims 2 and 3 over 4 frames: each bit-equal both
     ways, K1's launches equal, the warm-ups, captures, replays and
     capture seconds, host ms a call (the weave's a frame) both ways, and
     decode_vhs's MSa/s against real time (28.64).
 30. K4 (the capture widening, csrc/capture_widen.cu) through
     to_device_capture: for each loader's sample type (.lds uint16,
     .r16/.r30 int16, .raw uint8) at the segmented decode's shape (2^28
     samples into one reused buffer, full and K4_TAIL short), bit-equal to
     its plain version, the tail zeroed, its schedule's launches counted
     and no card memory allocated, even for a moment; at uint16, its device
     time against its bound, its launches' host time, the copy of the
     samples as they are, the host route it replaced (the float32
     conversion and its 4-byte copy) and PyTorch's cast-copy over the same
     ranges.  Phases 4 and 10 count its launches on the whole capture,
     phase 27 on every swap of the segmented file decodes.
 31. the .lds unpack on the host's cores (io/native_unpack.py,
     csrc/unpack_threads.cpp): a 2^28 sample segment (the cells' 512 MB)
     unpacked into a fresh array on one thread and split across the
     threads the loader picks, bit-equal, each the median of UNPACK_REPS
     calls in turns; at the reads around the split's threshold, one
     thread, the powers of two below the loader's count and the count;
     the host's CPU, its usable cores, its CPU quota and the threads.
Every decode and chain phase runs with the default graphs on.
The line before the last is the kernel JSON; the last line is the result.
"""

import concurrent.futures
import hashlib
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
RNG_SEED = 1234
HBM_BYTES_S = 3.35e12  # H100 SXM memory rate (NVIDIA data sheet)
F32_FLOP_S = 67e12     # H100 SXM float32 outside the tensor cores
# comb card vs CPU, dim 3 with flow on textured frames: the JAX package's
# own dim-3 budget (tests/test_comb_batch.py:82-83: p99.9 <= 2 LSB, max <=
# 16 LSB) and the flow within p99 0.01 px (tests/test_torch_optflow.py)
COMB_P999, COMB_MAX, FLOW_P99 = 2, 16, 0.01
# PAL comb card vs CPU (no flow; 1 LSB found against JAX on the CPU)
PAL_COMB_P999, PAL_COMB_MAX = 1, 4
PAL_START = 2560 * 14   # past the first vertical interval
# picture rows that read a line the tail gap sanitizer rewrote: its running
# sum reaches 25,600 samples, where one float32 step is 2^-9 px, and on
# `palbars` (a full-amplitude subcarrier) one step is up to 8 LSB
PAL_TAIL_ROWS, PAL_TAIL_MAX = 11, 16
# audio card vs CPU where the line table differs: ticks that the 48 kHz
# chase maps through a moved line take another stage-2 sample (a jump of up
# to a few hundred LSB) and are counted apart (tests/torch_parity.py)
AUDIO_PICK_LSB, AUDIO_PICK_MAX = 8, 0.005
# the sharded batch's audio against the single-rank batch's: JAX's own
# allowance, 1 LSB on at most 16 ticks (tests/test_parallel.py:140-144)
AUDIO_TICKS = 16
# K3's dependent chain a step: FMUL -> {FMNMX, FFMA} -> FMNMX
# (csrc/cx_envelope.cu), each ~4 cycles on Hopper's FP32 pipes
K3_CHAIN_OPS, K3_OP_CYCLES = 3, 4
# K4 at the main path's shape: the cells' 512 MB segment of .lds samples,
# and K4_TAIL short of it (the tail zeroed); the loaders' sample types
K4_SAMPLES, K4_TAIL, K4_REPS = 1 << 28, 12345, 15
K4_TYPES = (('.lds', 'uint16'), ('.r16/.r30', 'int16'), ('.raw', 'uint8'))
# phase 31: calls of each unpack route, and the read sizes (groups of 5
# bytes) timed around the split's threshold
UNPACK_REPS = 7
UNPACK_SIZES = (1 << 18, 1 << 19, 1 << 20, 1 << 22)
K4_METHOD = ('CUDA events around one widening (its launches and the '
             'tail memset) after a fresh stage of the samples; 1.6 GB of '
             'traffic against the 50 MB L2, so a cold read; median of '
             f'{K4_REPS}')


def fail(msg: str):
    print(f'FAIL: {msg}', flush=True)
    sys.exit(1)


T_START = time.perf_counter()


def phase(name: str):
    print(f'== {name}  [{time.perf_counter() - T_START:.0f} s]', flush=True)


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
    from ld_decode_tpu_torch.audio import cuda_cx as CC
    from ld_decode_tpu_torch.ops import cuda_gather as CG
    from ld_decode_tpu_torch.tbc import cuda_resample as CR
    from ld_decode_tpu_torch.tbc import cuda_widen as CW
    from ld_decode_tpu_torch.utils import cuda_build
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(4) as ex:
        for f in [ex.submit(CR._lib), ex.submit(CG._lib),
                  ex.submit(CC._lib), ex.submit(CW._lib)]:
            f.result()
    print(f'all four kernels loaded in {time.perf_counter() - t0:.2f} s')
    for name in ('resample_lines', 'take_along_axis', 'cx_envelope',
                 'capture_widen'):
        info = cuda_build.BUILDS[name]
        print(f'{name}.cu: nvcc {info.seconds:.2f} s -> {info.path}')
        for line in info.log.splitlines():
            if 'registers' in line or 'spill' in line:
                print('  ptxas:', line.strip())


MS_METHOD = ('device time with a cold L2: 20 calls, each after a read of '
             '3x the L2, in one CUDA graph, less the reads alone in '
             'another; median of 7 replay pairs between CUDA events')
_FLUSH = []


def _l2_flush(torch):
    """Read a buffer of three times the card's 50 MB L2, so that the call
    after it fetches every operand from memory, as the bound assumes."""
    if not _FLUSH:
        _FLUSH.append(torch.ones(3 * 50 * 2**20 // 4, device='cuda'))
    return _FLUSH[0].sum()


def _replay_ms(torch, g) -> float:
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    g.replay()
    b.record()
    b.synchronize()
    return a.elapsed_time(b)


def _times(torch, fn, reps: int = 20) -> dict:
    """Times of one fn() call, in ms:
      ms       -- MS_METHOD: pure device time, no host launch overhead,
                  operands from memory (the kernels line's `ms`);
      warm_ms  -- `reps` calls in one CUDA graph with nothing between
                  them, so operands that fit stay in the L2;
      call_ms  -- the median of `reps` single eager calls between two
                  events, host enqueue included (PR 1's `ms`)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    calls = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        calls.append(a.elapsed_time(b))
    # the flush buffer is made here, not inside a capture, where its fill
    # would join the first graph's work and be charged to the first call
    _l2_flush(torch)
    graphs = [torch.cuda.CUDAGraph() for _ in range(3)]
    bodies = [(fn,), (lambda: _l2_flush(torch), fn),
              (lambda: _l2_flush(torch),)]
    for g, body in zip(graphs, bodies):
        with torch.cuda.graph(g):
            for _ in range(reps):
                for f in body:
                    f()
    warm, cold = [], []
    for g in graphs:
        _replay_ms(torch, g)
    for _ in range(7):
        warm.append(_replay_ms(torch, graphs[0]) / reps)
        cold.append((_replay_ms(torch, graphs[1])
                     - _replay_ms(torch, graphs[2])) / reps)
    del graphs
    return dict(ms=statistics.median(cold), warm_ms=statistics.median(warm),
                call_ms=statistics.median(calls))


def kernel_phase(torch, np):
    phase('3 kernels vs plain on the card')
    return {'K1': k1_cases(torch, np), 'K2': k2_cases(torch, np)}


def _line_table(np, rng, B, nlines, linelen, start):
    """Split line locations (int32 anchor, float32 fraction) of B fields:
    lines linelen apart with a slow random wander, from `start` plus a
    per-field offset in [0, 200)."""
    ll = (np.arange(nlines + 4) * linelen + start
          + np.cumsum(rng.uniform(-1, 1, nlines + 4)) * 0.2)
    ll = ll[None] + rng.uniform(0, 200, (B, 1))
    lli = np.floor(ll).astype(np.int32)
    return lli, (ll - lli).astype(np.float32)


# K1 at the main paths' shapes: name, B, nsamp, nlines, W, linelen, col0,
# ncols.  The decode's field window is 52 blocks of 15328 samples.
K1_CASES = [
    ('ntsc picture', 16, 52 * 15328, 263, 910, 2542.0, 0, None),
    ('ntsc burst window', 16, 52 * 15328, 263, 910, 2542.0, 16, 48),
    ('pal-width picture', 16, 56 * 15328, 313, 1135, 2560.0, 0, None),
    # the sequential decode: one field a call (66 and 56 blocks)
    ('ntsc seq picture', 1, 66 * 15328, 263, 910, 2542.0, 0, None),
    ('ntsc seq burst window', 1, 66 * 15328, 263, 910, 2542.0, 16, 48),
    ('pal seq picture', 1, 56 * 15328, 313, 1135, 2560.0, 0, None),
    # a rank's shard of the sharded batch of 16 fields over 2 ranks
    ('ntsc shard picture', 8, 52 * 15328, 263, 910, 2542.0, 0, None),
    ('ntsc shard burst window', 8, 52 * 15328, 263, 910, 2542.0, 16, 48),
    ('pal shard picture', 8, 56 * 15328, 313, 1135, 2560.0, 0, None),
]


def k1_inputs(torch, np, edge: bool = False):
    """(name, args, kwargs) of K1's calls: the main paths' shapes, and with
    edge=True the cases that leave the staged path for some or all lines
    (broken tables, lines past both row ends, unaligned or odd-length data
    rows) or read the tables through views, as the picture call does."""
    rng = np.random.default_rng(RNG_SEED)
    dev = 'cuda'
    for name, B, nsamp, nlines, W, linelen, col0, ncols in K1_CASES:
        data = torch.from_numpy(rng.standard_normal(
            (B, nsamp), dtype=np.float32)).to(dev)
        lli, llf = _line_table(np, rng, B, nlines, linelen, 1500.0)
        yield name, (data, torch.from_numpy(lli).to(dev),
                     torch.from_numpy(llf).to(dev), W, nlines,
                     linelen), dict(col0=col0, ncols=ncols)
    if not edge:
        return
    B, nlines, linelen, W = 4, 263, 2542.0, 910
    nsamp = 52 * 15328
    data = torch.from_numpy(rng.standard_normal(
        (B, nsamp), dtype=np.float32)).to(dev)
    lli, llf = _line_table(np, rng, B, nlines, linelen, 1500.0)
    # broken tables: steplen < 0 (lines 5, 6 swapped), spans far over the
    # staging buffer (line 20 three lines long), a stray fraction
    bad_i, bad_f = lli.copy(), llf.copy()
    bad_i[:, [5, 6]] = bad_i[:, [6, 5]]
    bad_i[:, 21:] += int(2 * linelen)
    bad_f[:, 40] = 7.5
    # lines past both ends of the row: the first starts before sample 0,
    # the last end past nsamp, so the clamp [1, nsamp-3] bites
    end_i, end_f = _line_table(np, rng, B, nlines, linelen,
                               -1.5 * linelen - 200.0)
    end_i[:, nlines // 2:] += nsamp - int(nlines * linelen) + 6000
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    for win in ((0, None), (16, 48)):
        kw = dict(col0=win[0], ncols=win[1])
        tag = 'picture' if win[1] is None else 'burst window'
        yield f'edge {tag}: broken lines', (data, t(bad_i), t(bad_f), W,
                                            nlines, linelen), kw
        yield f'edge {tag}: lines past both row ends', (
            data, t(end_i), t(end_f), W, nlines, linelen), kw
    big_i, big_f = t(lli), t(llf)
    yield 'edge picture: table views [:, 1:]', (
        data, big_i[:, 1:], big_f[:, 1:], W, nlines, linelen), {}
    flat = torch.from_numpy(rng.standard_normal(
        B * nsamp + 1, dtype=np.float32)).to(dev)
    yield 'edge picture: data 4 bytes off 16-byte alignment', (
        flat[1:].view(B, nsamp), big_i, big_f, W, nlines, linelen), {}
    yield 'edge picture: odd row length', (
        flat[:B * (nsamp - 1)].view(B, nsamp - 1), big_i, big_f, W, nlines,
        linelen), {}


def _k1_bytes(torch, got, lli, nlines: int, W: int) -> int:
    """Bytes a K1 call must move: the demod samples under the output
    columns of each line (with the 4 taps), the line tables, the output
    once."""
    steplen = (lli[:, 1:nlines + 1] - lli[:, :nlines]).double()
    span = float((steplen * got.shape[-1] / W + 4).sum())
    return int(4 * (span + 2 * lli.numel() + got.numel()))


def k1_cases(torch, np):
    from ld_decode_tpu_torch.tbc import cuda_resample as CR
    results = {}
    for name, args, kw in k1_inputs(torch, np, edge=True):
        got = CR.resample_lines_batch(*args, **kw)
        ref = CR.resample_lines_batch_plain(*args, **kw)
        torch.cuda.synchronize()
        if got.shape != ref.shape:
            fail(f'{name}: shape {tuple(got.shape)} vs {tuple(ref.shape)}')
        d = (got - ref).abs()
        dmax, dmean = float(d.max()), float(d.mean())
        exact = bool(torch.equal(got, ref))
        if name.startswith('edge'):
            print(f'K1 {name}: out {tuple(got.shape)} bit-equal {exact}')
            if not exact:
                fail(f'K1 {name}: kernel is not bit-equal to the plain '
                     f'version (max|d| {dmax})')
            continue
        t = _times(torch, lambda: CR.resample_lines_batch(*args, **kw))
        plain_ms = _times(
            torch, lambda: CR.resample_lines_batch_plain(*args, **kw))['ms']
        nbytes = _k1_bytes(torch, got, args[1], args[4], args[3])
        flops = 30 * got.numel()         # weights, 4 taps, wow scale
        bound_ms, bound_by = _bound(nbytes, flops)
        print(f'K1 {name}: out {tuple(got.shape)} max|d| {dmax:.3e} '
              f'mean|d| {dmean:.3e} bit-equal {exact} kernel '
              f'{t["ms"]:.4f} ms (L2 warm {t["warm_ms"]:.4f} ms, one eager '
              f'call {t["call_ms"]:.4f} ms) plain {plain_ms:.4f} ms '
              f'bound {bound_ms:.4f} ms ({nbytes / 1e6:.1f} MB, '
              f'{bound_by}; {bound_ms / t["ms"]:.3f} of it)')
        if not exact:
            fail(f'K1 {name}: kernel is not bit-equal to the plain version '
                 f'(max {dmax}, mean {dmean})')
        results[name] = dict(max_abs_err=dmax, ms=t['ms'],
                             call_ms=t['call_ms'], plain_ms=plain_ms,
                             bound_ms=bound_ms, bound_by=bound_by,
                             library_ms=None)
    return results


def _bound(nbytes: int, flops: int):
    """Least time for the work on this card: bytes at the memory rate or
    operations at the float32 rate, whichever is longer."""
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = flops / F32_FLOP_S * 1e3
    return (t_bytes, 'bytes') if t_bytes >= t_ops else (t_ops, 'operations')


def _distinct_read(torch, op, idx, axis: int) -> int:
    """Elements of `op` that the gather must read: each distinct one once
    (this run's indices, clamped as the kernel clamps them)."""
    k = idx.long().clamp(0, op.shape[axis] - 1)
    if axis == 0:
        flat = k * op.shape[1] + torch.arange(idx.shape[1], device=k.device)
    else:
        flat = (torch.arange(idx.shape[0], device=k.device)[:, None]
                * op.shape[1] + k)
    return int(torch.unique(flat).numel())


WARP_LEVELS = ((252, 840), (126, 420), (63, 210))


def _warp_rows(np, rng, h: int, w: int):
    """Both fields' row indices of a warp at level h x w, from a smooth
    flow of sd 2 px per field (the warp's flow is a box-blurred solve),
    field b's rows offset by b*h*w: (2*h*w, 1) int32."""
    from scipy.ndimage import gaussian_filter
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    rows = []
    for b in range(2):
        d = [gaussian_filter(rng.normal(0, 1, (h, w)), 8) for _ in range(2)]
        fx = np.clip(xx + d[0] * (2 / d[0].std()), 0, w - 1.001)
        fy = np.clip(yy + d[1] * (2 / d[1].std()), 0, h - 1.001)
        rows.append(np.floor(fy).astype(np.int32) * w
                    + np.floor(fx).astype(np.int32) + b * h * w)
    return np.concatenate([r.ravel() for r in rows])[:, None]


def k2_inputs(torch, np, edge: bool = False):
    """(name, op, idx, axis, path) of K2's calls: the probe's shapes
    (scripts/probe_warp.py:112-116) and the Farneback warp's three pyramid
    levels as the flow calls it (both fields' rows of 20 in one gather on
    axis 0, one index per row broadcast with stride 0); with edge=True the
    cases at the row path's edges.  `path` is the path the wrapper must
    take: 'rows' or 'general'."""
    rng = np.random.default_rng(RNG_SEED + 2)
    dev = 'cuda'
    for shape, axis in (((8, 128), 1), ((64, 128), 1), ((256, 128), 1),
                        ((8, 128), 0), ((128, 128), 0), ((512, 512), 1)):
        op = torch.from_numpy(rng.standard_normal(
            shape, dtype=np.float32)).to(dev)
        idx = torch.from_numpy(rng.integers(
            0, min(shape[axis], 128), shape).astype(np.int32)).to(dev)
        yield f'probe {shape} axis {axis}', op, idx, axis, 'general'
    for h, w in WARP_LEVELS:
        rows = torch.from_numpy(_warp_rows(np, rng, h, w)).to(dev)
        op = torch.from_numpy(rng.standard_normal(
            (2 * h * w, 20), dtype=np.float32)).to(dev)
        yield (f'warp 2 fields x {h}x{w}', op, rows.expand(2 * h * w, 20),
               0, 'rows')
    if not edge:
        return
    n = 4099                 # 20,495 chunks: not a whole number of tiles
    rows = rng.integers(-3, n + 3, (n, 1)).astype(np.int32)   # stray too
    idx = torch.from_numpy(rows).to(dev)
    big = torch.from_numpy(rng.standard_normal(
        (n + 3) * 20 + 1, dtype=np.float32)).to(dev)
    yield ('edge rows: 4099 rows, stray indices', big[:n * 20].view(n, 20),
           idx.expand(n, 20), 0, 'rows')
    yield ('edge rows: width 20 on a view 3 rows in',
           big[:(n + 3) * 20].view(n + 3, 20)[3:], idx.expand(n, 20), 0,
           'rows')
    yield ('edge general: width 20 on a view 4 bytes off alignment',
           big[1:].view(n + 3, 20)[:n], idx.expand(n, 20), 0, 'general')
    yield ('edge general: width 18, stride-0 index',
           big[:n * 18].view(n, 18), idx.expand(n, 18), 0, 'general')


def k2_cases(torch, np):
    """K2 against its plain version and torch.take_along_dim at every
    shape of k2_inputs, on the path the wrapper must take.  The bound
    counts the distinct operand elements read."""
    from ld_decode_tpu_torch.ops import cuda_gather as CG
    from ld_decode_tpu_torch.ops import gather as G
    results = {}
    for name, op, idx, axis, path in k2_inputs(torch, np, edge=True):
        rows0 = CG.take_along_axis.row_launches
        got = CG.take_along_axis(op, idx, axis)
        took = 'rows' if CG.take_along_axis.row_launches > rows0 \
            else 'general'
        ref = G.take_along_axis_plain(op, idx, axis)
        lib = torch.take_along_dim(op, idx.long().clamp(
            0, op.shape[axis] - 1), axis)
        torch.cuda.synchronize()
        dmax = float((got - ref).abs().max())
        exact, lib_exact = bool(torch.equal(got, ref)), bool(
            torch.equal(got, lib))
        if took != path:
            fail(f'K2 {name}: took the {took} path, not {path}')
        if not (exact and lib_exact):
            fail(f'K2 {name}: kernel is not bit-equal (max|d| {dmax})')
        if name.startswith('edge'):
            print(f'K2 {name}: out {tuple(got.shape)} {took} path, '
                  f'bit-equal to plain {exact}, to take_along_dim '
                  f'{lib_exact}')
            continue
        t = _times(torch, lambda: CG.take_along_axis(op, idx, axis))
        plain_ms = _times(
            torch, lambda: G.take_along_axis_plain(op, idx, axis))['ms']
        lidx = idx.long()
        library_ms = _times(
            torch, lambda: torch.take_along_dim(op, lidx, axis))['ms']
        bound_ms, bound_by = _bound(_k2_bytes(torch, op, idx, axis, got), 0)
        print(f'K2 {name}: out {tuple(got.shape)} {took} path, bit-equal '
              f'to plain {exact}, to take_along_dim {lib_exact}; kernel '
              f'{t["ms"]:.4f} ms (L2 warm {t["warm_ms"]:.4f} ms, one eager '
              f'call {t["call_ms"]:.4f} ms) plain {plain_ms:.4f} ms '
              f'take_along_dim {library_ms:.4f} ms bound {bound_ms:.4f} ms '
              f'({bound_ms / t["ms"]:.3f} of it; '
              f'{_distinct_read(torch, op, idx, axis) / op.numel():.4f} of '
              f'the operand read)')
        results[name] = dict(max_abs_err=dmax, ms=t['ms'],
                             call_ms=t['call_ms'], plain_ms=plain_ms,
                             bound_ms=bound_ms, bound_by=bound_by,
                             library_ms=library_ms)
    return results


def _k2_bytes(torch, op, idx, axis: int, got) -> int:
    """Bytes a K2 call must move: each distinct operand element read
    once, the index as stored (one int32 a row for a stride-0 view), the
    output once."""
    idx_elems = idx.shape[0] if idx.stride(1) == 0 else idx.numel()
    return 4 * (_distinct_read(torch, op, idx, axis) + idx_elems
                + got.numel())


# the decode paths: capture frames and pattern, nblocks, first sample,
# frames to decode (and the least that must), K1 launches a batch (NTSC:
# two burst windows and the picture; PAL: the picture)
DECODE_PATHS = {
    'NTSC': dict(title='4 decode path', ncap=48, pattern='ramp', nblocks=52,
                 start=33046, want=40, least=32, k1_per_batch=3),
    'PAL': dict(title='10 PAL decode path', ncap=40, pattern='palbars',
                nblocks=56, start=PAL_START, want=32, least=24,
                k1_per_batch=1),
}


def main_path_phase(torch, np, system='NTSC'):
    p = DECODE_PATHS[system]
    phase(p['title'])
    from ld_decode_tpu_torch.models import encode as E
    from ld_decode_tpu_torch.utils.params import DecoderConfig
    from ld_decode_tpu_torch.ops import filters as F
    from ld_decode_tpu_torch.tbc import cuda_resample as CR
    from ld_decode_tpu_torch.tbc import cuda_widen as CW
    from ld_decode_tpu_torch.tbc import framer as FR

    cfg = DecoderConfig(system=system, freq_mhz=40.0)
    t0 = time.perf_counter()
    cap = E.encode_frames(cfg, p['ncap'], E.EncodeSpec(
        pattern=p['pattern'], cav_start_frame=900))
    print(f'synthesized {p["ncap"]} {system} frames ({cap.shape[0]} samples) '
          f'in {time.perf_counter() - t0:.1f} s')
    bank = F.make_demod_bank(cfg, np.complex64, device='cuda')

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    CR.resample_lines_batch.launches = 0
    CW.widen.launches, routes = 0, dict(CW.routes)
    fr = FR.Framer(cfg, bank, capture=cap, batch=16, nblocks=p['nblocks'],
                   device='cuda')
    k4 = CW.widen.launches
    k4_want = len(CW.widen_schedule(cap.shape[0], cap.dtype.itemsize)) - 1
    print(f'K4 widened the whole capture ({cap.dtype}) on the card: '
          f'{k4} launches, routes {CW.routes} (before {routes})')
    if k4 != k4_want or CW.routes != {'card': routes['card'] + 1,
                                      'host': routes['host']}:
        fail(f'K4 launches {k4}, expected {k4_want}, one widening on the '
             f'card')
    t0 = time.perf_counter()
    rv = fr.readframe(None, p['start'], True)
    if rv[0] is None:
        fail('warm-up frame did not decode')
    print(f'warm-up frame {fr.vbi.get("framenr")} in '
          f'{time.perf_counter() - t0:.2f} s')
    sample = rv[2]
    frames = []
    spf = cfg.freq_hz / cfg.sys.fps
    shape = (cfg.sys.frame_lines * cfg.sys.outlinelen,)
    t0 = time.perf_counter()
    while len(frames) < p['want']:
        rv = fr.readframe(None, sample, False)
        if rv[0] is None:
            break
        frames.append(fr.vbi.get('framenr'))
        if rv[0].shape != shape or rv[1] is None or not len(rv[1]):
            fail(f'frame {len(frames)}: picture {rv[0].shape}, no audio')
        sample = rv[2]
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = CR.resample_lines_batch.launches
    st = fr.prefetcher.stats
    print(f'decoded {len(frames)} {system} frames in {dt:.3f} s: '
          f'{len(frames) * spf / dt / 1e6:.2f} MSa/s sustained '
          f'({len(frames) / dt:.2f} frames/s; capture rate 40 MSa/s)')
    print(f'CAV frame numbers {frames[0]}..{frames[-1] if frames else None}')
    print(f'peak device memory {torch.cuda.max_memory_allocated() / 2**20:.1f}'
          f' MiB')
    print('prefetcher stats', json.dumps(
        {k: (round(v, 4) if isinstance(v, float) else v)
         for k, v in st.items()}))
    if len(frames) < p['least']:
        fail(f'only {len(frames)} frames decoded')
    if any(b != a + 1 for a, b in zip(frames, frames[1:])) \
            or frames[0] is None:
        fail(f'CAV frame numbers not consecutive: {frames}')
    per = p['k1_per_batch']
    expect = per * (st['batches'] + st['seq_decoded'])
    print(f'K1 launches {launches}: {per} per batch x {st["batches"]} '
          f'batches + {per} per sequential field x {st["seq_decoded"]}')
    if launches != expect or launches == 0:
        fail(f'K1 launches {launches}, expected {expect}')
    return cfg, cap, bank, fr, launches, k4


def parity_phase(torch, np, cfg, bank, fr, title='5 card vs cpu, one batch',
                 start=33046, nblk=52, tail_rows=0):
    """One field batch on the card and on the CPU from the same locked
    start.  tail_rows > 0 (PAL) holds the picture rows that read a
    tail-sanitized line to PAL_TAIL_MAX and the rest to the usual budget."""
    phase(title)
    from ld_decode_tpu_torch.ops import filters as F
    from ld_decode_tpu_torch.tbc import fused as FU

    fr.prefetcher.flush()
    f0, rs0, _ = fr.readfield(None, start)
    rs0 = int(f0.readsample if f0.readsample >= 0 else rs0)
    batch = 4
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
    dloc = ll(c) - ll(g)
    dpic = np.abs(g['picture'].astype(np.int64)
                  - c['picture'].astype(np.int64))
    # PAL: every line of every field within 0.02 px, or a wrap flip its
    # prediction accounts for (F3); the picture rows reading a flipped
    # line (rows line - 4 and line - 3 of the field) apart
    nflip, flip_rows, flip_lsb = 0, 0, 0
    if cfg.system == 'PAL' and np.abs(dloc).max() > 0.02:
        pred = _batch_wrap_flips(torch, np, cfg, {'cuda': (cap_gpu, bank),
                                                  'cpu': (cap_cpu, bank_cpu)},
                                 rs0, nblk, batch, pitch)
        for b in range(batch):
            flips = _flipped_lines(np, dloc[b], *pred[b],
                                   f'{cfg.system} batch field {b}')
            dloc[b, flips] = 0.0
            rows = sorted({j for l in flips for j in (l - 4, l - 3)
                           if 0 <= j < dpic.shape[1]})
            nflip += len(flips)
            flip_rows += len(rows)
            if rows:
                flip_lsb = max(flip_lsb, int(dpic[b, rows].max()))
                dpic[b, rows] = 0
    dll = float(np.abs(dloc).max())
    cut = cfg.sys.frame_lines // 2 - tail_rows
    dtail = dpic[:, cut:cfg.sys.frame_lines // 2]
    dpic = dpic[:, 24:cut] if tail_rows else dpic[:, 24:]
    p999, pmax = float(np.percentile(dpic, 99.9)), int(dpic.max())
    arms = []
    for b in range(batch):
        n = (int(g['audio_count'][b]) - 1) * 2
        da = g['audio'][b, :n].astype(np.float64) - c['audio'][b, :n]
        arms.append(float(np.sqrt(np.mean(da ** 2))))
    print(f'linelocs max|d| {dll:.2e} px; picture rows>=24 p99.9 {p999} '
          f'max {pmax} LSB; audio rms {max(arms):.3f} LSB; meta, audio '
          f'counts, Philips codes and chain scalars equal')
    if cfg.system == 'PAL':
        print(f'wrap flips: {nflip} lines, {flip_rows} picture rows reading '
              f'them, max {flip_lsb} LSB (held apart from the budgets)')
    if dll > 0.02 or p999 > 2 or pmax > 4 or max(arms) > 0.6:
        fail('card vs cpu outside the budgets (0.02 px, 2/4 LSB, 0.6 LSB)')
    if tail_rows:
        print(f'the {tail_rows} tail-sanitized rows: max {int(dtail.max())} '
              f'LSB (budget {PAL_TAIL_MAX}); columns 0/1 of rows 24+ hold '
              f'no burst words')
        if dtail.max() > PAL_TAIL_MAX:
            fail('PAL tail rows outside their budget')
        if np.isin(g['picture'][:, 24:cut, 0], (16384, 32768)).all():
            fail('PAL picture carries burst flag words in column 0')

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


def _batch_wrap_flips(torch, np, cfg, runs, rs0, nblk, batch, pitch):
    """tbc/pal.py::wrap_flip_lines for each field of a PAL batch decoded on
    the card and on the CPU (`runs`: device -> (capture, bank)), from each
    decode's pilot-pass input: the batch call's analysis and hsync stage
    run again from the same starts, whose line locations must agree card
    vs CPU within 0.02 px (bad-line flags equal), as phase 15 holds its
    hsync stage.  Returns [(lines, predicted, anchored, detail)] a
    field."""
    from ld_decode_tpu_torch.tbc import fused as FU
    from ld_decode_tpu_torch.tbc import pal as PAL
    got = []
    for cap, bank in (runs['cuda'], runs['cpu']):
        starts = FU.pipeline_starts(rs0, 0, batch, pitch, cap.shape[0], cfg,
                                    nblk, device=cap.device)
        video, _a, lld, lc, *_ = FU.pipeline_analyze(cap, starts, 1.0, bank,
                                                     cfg, nblk)
        lli, llf, bad = FU._hsync_refine(video, lld.lli, lld.llf, lld.bad,
                                         lc, cfg)
        frac, cross = PAL.pilot_offsets(video['demod'], video['demod_05'],
                                        lli, llf, cfg.linelen, cfg.freq_mhz)
        got.append((frac.cpu().numpy(), cross.cpu().numpy(),
                    lli.cpu().numpy(), llf.cpu().numpy(),
                    bad.cpu().numpy()))
    (fa, ca, ia, la, ba), (fb, cb, ib, lb, bb) = got
    dhs = float(np.abs((ib.astype(np.float64) + lb)
                       - (ia.astype(np.float64) + la)).max())
    print(f'{cfg.system} batch hsync stage, run again: max|d| {dhs:.2e} '
          f'px card vs CPU')
    if dhs > 0.02 or not np.array_equal(ba, bb):
        fail(f'{cfg.system} batch hsync stage card vs CPU: max|d| {dhs} px '
             f'(budget 0.02), bad-line flags '
             f'{"equal" if np.array_equal(ba, bb) else "differ"}')
    got = [g[:4] for g in got]
    return [PAL.wrap_flip_lines(fa[b], ca[b], fb[b], cb[b], (ia[b], ib[b]),
                                (la[b], lb[b]), cfg.freq_mhz)
            + (_pilot_detail(np, [[x[b] for x in g] for g in got]),)
            for b in range(batch)]


def _write_capture(np, cap, cfg, d: str) -> str:
    """The first 10 frames of `cap`: NTSC as .r16, PAL as .lds."""
    spf = int(cfg.freq_hz / cfg.sys.fps) + 1
    if cfg.system == 'PAL':
        from ld_decode_tpu_torch.io.loaders import pack_data_4_40
        path = os.path.join(d, 'cap.lds')
        pack_data_4_40(cap[:10 * spf]).tofile(path)
    else:
        path = os.path.join(d, 'cap.r16')
        (cap[:10 * spf].astype(np.int32) - 32768).astype('<i2').tofile(path)
    return path


def _run_cli(script: str, argv):
    """Run one of the repo's scripts; returns (seconds, its stdout)."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, os.path.join(ROOT, script)] + argv,
                          capture_output=True, text=True, cwd=ROOT,
                          timeout=600)
    if proc.returncode != 0:
        fail(f'{script} exit {proc.returncode}:\n{proc.stderr[-3000:]}')
    return time.perf_counter() - t0, proc.stdout


def cli_phase(np, cap, cfg, d: str, title='6 cli'):
    """The decode CLI on a 10-frame capture written into `d`; its capture,
    .tbc and .pcm stay there for phase 18."""
    phase(title)
    flags = ['-p'] if cfg.system == 'PAL' else []
    want = 8 * cfg.sys.frame_lines * cfg.sys.outlinelen * 2
    path = _write_capture(np, cap, cfg, d)
    out = os.path.join(d, 'out')
    dt, _ = _run_cli('lddecode_torch.py',
                     [path, out, '-l', '8', '-q'] + flags)
    tbc = os.path.getsize(out + '.tbc')
    pcm = os.path.getsize(out + '.pcm')
    print(f'lddecode_torch.py {" ".join(flags + ["-l", "8"])}: {dt:.1f} '
          f's, .tbc {tbc} bytes, .pcm {pcm} bytes')
    if tbc != want or pcm <= 0:
        fail(f'.tbc {tbc} bytes (want {want}), .pcm {pcm}')
    return path, out


def chain_phase(torch, np, cfg, cap, bank):
    phase('7 chain path')
    from ld_decode_tpu_torch.audio.cx import CXExpander
    from ld_decode_tpu_torch.comb.batch import CombWindows, NTSCCombBatch
    from ld_decode_tpu_torch.comb.comb_ntsc import CombConfig
    from ld_decode_tpu_torch.ops import cuda_gather as CG
    from ld_decode_tpu_torch.tbc import cuda_resample as CR
    from ld_decode_tpu_torch.tbc import framer as FR

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fr = FR.Framer(cfg, bank, capture=cap, batch=16, nblocks=52,
                   device='cuda', fetch_picture=False)
    comb = NTSCCombBatch(CombConfig(dim=3), device='cuda')
    cx = CXExpander()
    rgbs, words, dev_frames, woven = [], [], [], []
    nframes, naudio = 0, 0

    def emit(rgb, w):
        rgbs.append(rgb)
        words.append(w)

    # ldchain_torch.py's defaults: windows of 8 frames, 3 in flight
    windows = CombWindows(comb, 8, 3, emit)
    CR.resample_lines_batch.launches = 0
    CG.take_along_axis.launches = 0
    CG.take_along_axis.row_launches = 0
    t0 = time.perf_counter()
    sample = 33046
    for i in range(24):
        rv = fr.readframe(None, sample, i == 0)
        if rv[0] is None:
            break
        frame = rv[0].reshape(525, 910)
        if isinstance(frame, torch.Tensor) and len(dev_frames) < 4:
            dev_frames.append(frame.clone())
        # phase 27's comb input, held on the host until then
        woven.append(frame.cpu() if isinstance(frame, torch.Tensor)
                     else torch.from_numpy(frame.astype(np.int32)))
        windows.push(frame)
        nframes += 1
        if rv[1] is not None:
            naudio += cx.process(np.asarray(rv[1]).ravel()).size
        sample = rv[2]
    windows.drain()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    k1, k2 = CR.resample_lines_batch.launches, CG.take_along_axis.launches
    k2_rows = CG.take_along_axis.row_launches
    st = fr.prefetcher.stats
    spf = cfg.freq_hz / cfg.sys.fps
    cav = [(int(w[14]) << 16) | int(w[15]) for w in words]
    print(f'chain: {nframes} frames decoded, {len(rgbs)} RGB frames '
          f'emitted in {dt:.3f} s: {len(rgbs) / dt:.2f} RGB frames/s, '
          f'{nframes * spf / dt / 1e6:.2f} MSa/s of capture; '
          f'{naudio} CX audio samples')
    print(f'CAV frame numbers of the emitted frames {cav[0]}..{cav[-1]}')
    print(f'peak device memory {torch.cuda.max_memory_allocated() / 2**20:.1f}'
          f' MiB')
    print('comb stats', json.dumps(
        {k: (round(v, 4) if isinstance(v, float) else v)
         for k, v in comb.stats.items()}))
    if len(rgbs) < 16 or len(rgbs) != nframes - 2:
        fail(f'{len(rgbs)} RGB frames from {nframes} (want nframes - 2 '
             f'>= 16: frame 0 never emits, one stays pending)')
    if any(r.shape != (480, 744, 3) or r.dtype != np.uint16 for r in rgbs):
        fail('an RGB frame is not (480, 744, 3) uint16')
    if any(b != a + 1 for a, b in zip(cav, cav[1:])) or not cav[0]:
        fail(f'CAV frame numbers not consecutive: {cav}')
    expect1 = 3 * (st['batches'] + st['seq_decoded'])
    print(f'K1 launches {k1} (3 per batch x {st["batches"]} + 3 per '
          f'sequential field x {st["seq_decoded"]}); K2 launches {k2} '
          f'(9 per RGB frame: 3 warps x 3 levels, both fields in each), '
          f'{k2_rows} of them on the row-gather path')
    if k1 != expect1 or k1 == 0:
        fail(f'K1 launches {k1}, expected {expect1}')
    if k2 != 9 * len(rgbs):
        fail(f'K2 launches {k2}, expected {9 * len(rgbs)}')
    if k2_rows != k2:
        fail(f'only {k2_rows} of {k2} warp launches took the row path')
    if not naudio:
        fail('no CX audio')
    return k1, k2, dev_frames, woven


def comb_parity_phase(torch, np, dev_frames):
    phase('8 comb: card vs cpu, one window')
    from scipy.ndimage import gaussian_filter
    from ld_decode_tpu_torch.comb.batch import NTSCCombBatch
    from ld_decode_tpu_torch.comb.comb_ntsc import CombConfig
    if len(dev_frames) < 4:
        fail(f'only {len(dev_frames)} device frames from the chain')
    rng = np.random.default_rng(RNG_SEED + 8)
    tex = gaussian_filter(rng.normal(0, 1, (560, 960)), 2.0)
    tex = tex / np.abs(tex).max() * 4000
    frames = torch.stack(dev_frames)
    for k in range(4):
        t = np.roll(tex, (k // 2, k), axis=(0, 1))[20:525, 60:910]
        frames[k, 20:, 60:] = (frames[k, 20:, 60:] + torch.from_numpy(
            t.astype(np.int32)).cuda()).clamp(0, 65535)
    outs = {}
    for dev in ('cuda', 'cpu'):
        comb = NTSCCombBatch(CombConfig(dim=3), device=dev)
        t0 = time.perf_counter()
        r, w = comb.collect(comb.feed(frames.to(dev)))
        outs[dev] = (r, w, comb._flow.cpu().numpy(),
                     time.perf_counter() - t0)
    (rg, wg, fg, tg), (rc, wc, fc, tc) = outs['cuda'], outs['cpu']
    if len(rg) != len(rc) or len(rg) != 2:
        fail(f'emissions: cuda {len(rg)}, cpu {len(rc)} (want 2)')
    if not all(np.array_equal(a, b) for a, b in zip(wg, wc)):
        fail('line-0 words differ')
    df = np.abs(fg - fc)
    print(f'window of 4: cuda {tg:.3f} s, cpu {tc:.3f} s; flow |d| median '
          f'{np.median(df):.3e} p99 {np.percentile(df, 99):.3e} max '
          f'{df.max():.3e} px')
    for k, (a, b) in enumerate(zip(rg, rc)):
        d = np.abs(a.astype(np.int64) - b.astype(np.int64))
        frac2, p999 = float((d > 2).mean()), float(np.percentile(d, 99.9))
        print(f'RGB frame {k}: |d| > 2 LSB on {frac2:.5f} of values, '
              f'p99.9 {p999} max {int(d.max())} LSB')
        if p999 > COMB_P999 or d.max() > COMB_MAX:
            fail(f'comb card vs cpu outside the budgets (p99.9 {COMB_P999}, '
                 f'max {COMB_MAX} LSB)')
    if np.percentile(df, 99) > FLOW_P99:
        fail(f'flow card vs cpu: p99 {np.percentile(df, 99)} px')


def chain_cli_phase(torch, np, cap, cfg, title='9 chain cli'):
    """ldchain_torch.py -l 6 on a 10-frame capture: 6 RGB frames, and the
    audio of exactly the first 6 decoded frames (the chain decodes past
    them for the comb's lookahead; ldchain_tpu.py writes the audio of all
    it decoded: ROADMAP.md Queue 3, fixed in the port)."""
    phase(title)
    pal = cfg.system == 'PAL'
    flags = ['-p'] if pal else []
    want = 6 * (576 * 1135 if pal else 480 * 744) * 3 * 2
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, 'build')) as d:
        path = _write_capture(np, cap, cfg, d)
        out = os.path.join(d, 'out')
        dt, _ = _run_cli('ldchain_torch.py', [path, out, '-l', '6', '--raw',
                                              '-q'] + flags)
        rgb = os.path.getsize(out + '.rgb')
        pcm = os.path.getsize(out + '.audio.pcm')
        counts = _chain_audio_counts(torch, np, cfg, path)
        want_pcm = 2 * sum(counts[:6])
        print(f'ldchain_torch.py {" ".join(flags + ["-l", "6"])}: {dt:.1f} '
              f's, .rgb {rgb} bytes, .audio.pcm {pcm} bytes: the first 6 '
              f'of the {len(counts)} frames the capture decodes to hold '
              f'{want_pcm} bytes of audio, all of them '
              f'{2 * sum(counts)}')
        if rgb != want or pcm != want_pcm or want_pcm <= 0:
            fail(f'.rgb {rgb} bytes (want {want}), .audio.pcm {pcm} (want '
                 f'{want_pcm})')


def _chain_audio_counts(torch, np, cfg, path: str) -> list:
    """The audio samples of each frame ldchain_torch.py decodes from
    `path` (its Framer: a loader, batch 16, the default segment, chain
    mode, from sample 0; eager, which phase 25 holds bit-equal to the
    CLI's graphs), to the end of the capture."""
    from ld_decode_tpu_torch.io import loaders as L
    from ld_decode_tpu_torch.ops import filters as F
    from ld_decode_tpu_torch.tbc import framer as FR
    bank = F.make_demod_bank(cfg, np.complex64, device='cuda')
    fr = FR.Framer(cfg, bank, L.loader_for_path(path), batch=16,
                   segment_samples=512 * (1 << 20) // 2, device='cuda',
                   fetch_picture=False, graphs=False)
    counts, sample = [], 0
    with open(path, 'rb') as fd:
        while True:
            frame, audio, sample, _ = fr.readframe(fd, sample, not counts)
            if frame is None:
                break
            counts.append(0 if audio is None else int(np.asarray(audio).size))
    del fr
    torch.cuda.empty_cache()
    return counts


def pal_chain_phase(torch, np, cfg, cap, bank):
    phase('12 PAL chain path')
    from ld_decode_tpu_torch.audio.cx import CXExpander
    from ld_decode_tpu_torch.comb.batch import CombWindows, PALCombBatch
    from ld_decode_tpu_torch.comb.comb_pal import CombPALConfig
    from ld_decode_tpu_torch.ops import cuda_gather as CG
    from ld_decode_tpu_torch.tbc import cuda_resample as CR
    from ld_decode_tpu_torch.tbc import framer as FR

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fr = FR.Framer(cfg, bank, capture=cap, batch=16, nblocks=56,
                   device='cuda', fetch_picture=False)
    comb = PALCombBatch(CombPALConfig(dim=3), device='cuda')
    cx = CXExpander()
    rgbs, words, dev_frames, woven = [], [], [], []
    nframes, naudio = 0, 0

    def emit(rgb, w):
        rgbs.append(rgb)
        words.append(w)

    windows = CombWindows(comb, 8, 3, emit)
    CR.resample_lines_batch.launches = 0
    CG.take_along_axis.launches = 0
    t0 = time.perf_counter()
    t_half = t0
    sample = PAL_START
    for i in range(32):
        if i == 16:
            # two windows in: the plans, buffers and the prefetcher's first
            # flushes are behind
            torch.cuda.synchronize()
            t_half = time.perf_counter()
        rv = fr.readframe(None, sample, i == 0)
        if rv[0] is None:
            break
        frame = rv[0].reshape(625, 1135)
        if not isinstance(frame, torch.Tensor):
            frame = torch.from_numpy(frame.astype(np.int32)).cuda()
        elif len(dev_frames) < 4:
            dev_frames.append(frame.clone())
        # a PAL RGB frame carries no line-0 words, and the bars are the
        # same in every frame: stamp the frame's index as the luma of a
        # patch, so that the order of the emitted frames can be read
        frame[200:216, 560:600] = 18000 + 1100 * i      # 4..95 IRE
        woven.append(frame.cpu())            # phase 27's, on the host
        windows.push(frame)
        nframes += 1
        if rv[1] is not None:
            naudio += cx.process(np.asarray(rv[1]).ravel()).size
        sample = rv[2]
    windows.drain()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    k1, k2 = CR.resample_lines_batch.launches, CG.take_along_axis.launches
    st = fr.prefetcher.stats
    spf = cfg.freq_hz / cfg.sys.fps
    print(f'PAL chain: {nframes} frames decoded, {len(rgbs)} RGB frames '
          f'emitted in {dt:.3f} s: {len(rgbs) / dt:.2f} RGB frames/s, '
          f'{nframes * spf / dt / 1e6:.2f} MSa/s of capture; '
          f'{naudio} CX audio samples')
    t_rest = t0 + dt - t_half
    print(f'the last {nframes - 16} frames (decode, comb, and the drain of '
          f'every window still in flight): {t_rest:.3f} s, '
          f'{(nframes - 16) / t_rest:.2f} frames/s')
    print(f'peak device memory {torch.cuda.max_memory_allocated() / 2**20:.1f}'
          f' MiB')
    print('comb stats', json.dumps(
        {k: (round(v, 4) if isinstance(v, float) else v)
         for k, v in comb.stats.items()}))
    if nframes < 16 or len(rgbs) != nframes:
        fail(f'{len(rgbs)} RGB frames from {nframes} decoded (want every '
             f'frame once, the flush tail included, >= 16)')
    if any(r.shape != (576, 1135, 3) or r.dtype != np.uint16 for r in rgbs):
        fail('an RGB frame is not (576, 1135, 3) uint16')
    if any(w is not None for w in words):
        fail('a PAL frame came with line-0 words')
    # the stamped patch (frame rows 200.. -> RGB rows 176..): its green
    # level rises by about the same step from each frame to the next (the
    # darkest patches clip a little of their ringing at black)
    level = [float(r[180:188, 568:590, 1].mean()) for r in rgbs]
    steps = np.diff(level)
    mid = float(np.median(steps))
    print(f'order stamp: green {level[0]:.0f}..{level[-1]:.0f}, steps '
          f'{steps.min():.0f}..{steps.max():.0f} (median {mid:.0f})')
    if steps.min() < 0.5 * mid or steps.max() > 1.5 * mid:
        fail(f'emitted frames out of order: patch levels {level}')
    expect1 = st['batches'] + st['seq_decoded']
    print(f'K1 launches {k1} (1 per batch x {st["batches"]} + 1 per '
          f'sequential field x {st["seq_decoded"]}); K2 launches {k2} '
          f'(the PAL comb has no flow)')
    if k1 != expect1 or k1 == 0:
        fail(f'K1 launches {k1}, expected {expect1}')
    if k2 != 0:
        fail(f'K2 launched {k2} times on the PAL chain')
    if not naudio:
        fail('no CX audio')
    return k1, dev_frames, woven


def pal_comb_parity_phase(torch, np, dev_frames):
    phase('13 PAL comb: card vs cpu, one window')
    from ld_decode_tpu_torch.comb.batch import PALCombBatch
    from ld_decode_tpu_torch.comb.comb_pal import CombPALConfig
    if len(dev_frames) < 4:
        fail(f'only {len(dev_frames)} device frames from the PAL chain')
    frames = torch.stack(dev_frames)
    outs = {}
    for dev in ('cuda', 'cpu'):
        comb = PALCombBatch(CombPALConfig(dim=3), device=dev)
        t0 = time.perf_counter()
        r, _ = comb.collect(comb.feed(frames.to(dev)))
        r.append(comb.flush())
        outs[dev] = (r, time.perf_counter() - t0)
    (rg, tg), (rc, tc) = outs['cuda'], outs['cpu']
    if len(rg) != len(rc) or len(rg) != 4:
        fail(f'emissions: cuda {len(rg)}, cpu {len(rc)} (want 4: frame 0 2D, '
             f'two 3D, the flush tail)')
    print(f'window of 4: cuda {tg:.3f} s, cpu {tc:.3f} s')
    for k, (a, b) in enumerate(zip(rg, rc)):
        d = np.abs(a.astype(np.int64) - b.astype(np.int64))
        p999 = float(np.percentile(d, 99.9))
        print(f'PAL RGB frame {k}: |d| > 1 LSB on {float((d > 1).mean()):.6f}'
              f' of values, p99.9 {p999} max {int(d.max())} LSB')
        if p999 > PAL_COMB_P999 or d.max() > PAL_COMB_MAX:
            fail(f'PAL comb card vs cpu outside the budgets (p99.9 '
                 f'{PAL_COMB_P999}, max {PAL_COMB_MAX} LSB)')

SEQ_PATHS = {
    'NTSC': dict(title='15 sequential decode path (NTSC)', nblocks=66,
                 start=33046, k1_per_field=3),
    'PAL': dict(title='15 sequential decode path (PAL)', nblocks=56,
                start=PAL_START, k1_per_field=1),
}


def seq_decode_phase(torch, np, cfg, cap, bank, d: str):
    """The --batch 1 decode through the user's entry point, a loader over
    an .lds file: 4 frames on the card, then 2 of them on the CPU."""
    p = SEQ_PATHS[cfg.system]
    phase(p['title'])
    from ld_decode_tpu_torch.io import loaders as L
    from ld_decode_tpu_torch.ops import filters as F
    from ld_decode_tpu_torch.tbc import cuda_resample as CR
    from ld_decode_tpu_torch.tbc import framer as FR
    spf = int(cfg.freq_hz / cfg.sys.fps) + 1
    path = os.path.join(d, f'seq_{cfg.system}.lds')
    L.pack_data_4_40(cap[:8 * spf]).tofile(path)
    loader = L.loader_for_path(path)

    def decode(device, b, nframes):
        fr = FR.Framer(cfg, b, loader, batch=1, nblocks=p['nblocks'],
                       device=device)
        valid = [0]
        process = fr.decoder.process

        def counted(*a, **k):
            n0 = len(steps)
            r = process(*a, **k)
            valid[0] += int(r.valid)
            if r.valid and len(steps) > n0:
                pilot_in[id(r)] = steps[-1]
            return r

        fr.decoder.process = counted
        hsync = fr.decoder.refine_linelocs_hsync

        def kept(*a, **k):
            r = hsync(*a, **k)
            # PAL: the pilot pass's input, its two demod taps cloned (a
            # replay overwrites them) for the wrap-flip accounting
            taps = {t: a[0][t].clone() for t in ('demod', 'demod_05')} \
                if cfg.system == 'PAL' else None
            steps.append((device, r[0].copy(), r[1].copy(), taps))
            return r

        fr.decoder.refine_linelocs_hsync = kept
        frames, sample = [], p['start']
        with open(path, 'rb') as fd:
            for i in range(nframes):
                rv = fr.readframe(fd, sample, i == 0)
                if rv[0] is None:
                    break
                frames.append(rv)
                sample = rv[2]
        return frames, valid[0]

    def refuse(*_a, **_k):
        fail('a line resample on the card reached the plain version')

    steps, pilot_in = [], {}

    plain = CR.resample_lines_batch_plain
    CR.resample_lines_batch_plain = refuse
    try:
        CR.resample_lines_batch.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        gpu, nvalid = decode('cuda', bank, 4)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = CR.resample_lines_batch.launches
    finally:
        CR.resample_lines_batch_plain = plain
    cav = [(int(rv[0][14]) << 16) | int(rv[0][15]) for rv in gpu]
    sps = cfg.freq_hz / cfg.sys.fps
    print(f'{cfg.system} batch 1 on the card: {len(gpu)} frames in '
          f'{dt:.3f} s ({len(gpu) * sps / dt / 1e6:.2f} MSa/s, the warm-up '
          f'frame included), CAV {cav}')
    per = p['k1_per_field']
    print(f'K1 launches {launches}: {per} per decoded field x {nvalid}; '
          f'the plain version never called')
    if len(gpu) < 4 or any(b != a + 1 for a, b in zip(cav, cav[1:])):
        fail(f'sequential decode: {len(gpu)} frames, CAV {cav}')
    if launches != per * nvalid or launches == 0:
        fail(f'K1 launches {launches}, expected {per * nvalid}')
    locate_only_check(np, FR, CR, cfg, bank, loader, path, p, gpu,
                      [x[1] for x in steps if x[0] == 'cuda'])

    bank_cpu = F.make_demod_bank(cfg, np.complex64, device='cpu')
    t0 = time.perf_counter()
    cpu, _ = decode('cpu', bank_cpu, 2)
    print(f'2 frames on the CPU in {time.perf_counter() - t0:.1f} s')
    # the hsync stage of every field both decoded, in order
    hs = [[x for x in steps if x[0] == dev] for dev in ('cuda', 'cpu')]
    dhs = 0.0
    for (_, gl, gb, _), (_, cl, cb, _) in zip(*hs):
        if len(gl) != len(cl) or not np.array_equal(gb, cb):
            fail('hsync stage: line counts or bad-line flags differ')
        dhs = max(dhs, float(np.abs(gl - cl).max()))
    # the final locations: every line of a field, the last 10 (the tail,
    # in the vertical interval: its picture rows are PAL_TAIL_ROWS)
    # included, within 0.02 px or a PAL wrap flip its prediction accounts
    # for (F3); the picture rows that read a flipped line apart
    Y, W = cfg.sys.frame_lines, cfg.sys.outlinelen
    cut = 2 * (cfg.sys.frame_lines // 2 - PAL_TAIL_ROWS)
    dll, dtail, p999, pmax, tmax = 0.0, 0.0, 0.0, 0, 0
    nflip, flip_rows, flip_lsb = 0, 0, 0
    audio_g, audio_c = [], []
    for a, b in zip(gpu, cpu):
        if a[2] != b[2] or not np.array_equal(a[0][:16], b[0][:16]):
            fail('next sample or line-0 words differ, card vs CPU')
        rows = set()
        half = min(f.linecount for f in a[3])
        lf = int(np.argmax([f.linecount for f in a[3]]))
        for fi, (fa, fb) in enumerate(zip(a[3], b[3])):
            da = (fa.valid, fa.istop, fa.linecount, fa.nextfieldoffset,
                  fa.peak_count, fa.vsync_count, fa.linecode)
            db = (fb.valid, fb.istop, fb.linecount, fb.nextfieldoffset,
                  fb.peak_count, fb.vsync_count, fb.linecode)
            if da != db:
                fail(f'field decisions differ, card vs CPU: {da} / {db}')
            d = fb.linelocs - fa.linelocs
            flips = []
            if np.abs(d).max() > 0.02 and cfg.system == 'PAL':
                flips = _flipped_lines(
                    np, d, *_wrap_flips(torch, np, cfg, pilot_in[id(fa)],
                                        pilot_in[id(fb)]),
                    f'{cfg.system} sequential field {fi}')
            rest = np.abs(d)
            rest[flips] = 0.0
            dll = max(dll, float(rest[:-10].max()))
            dtail = max(dtail, float(rest[-10:].max()))
            nflip += len(flips)
            # frame rows whose field rows (line - lineoffset - 1 and line -
            # lineoffset) read a flipped line
            for l in flips:
                for j in (l - 4, l - 3):
                    if 0 <= j < half:
                        rows.add(2 * j + fi)
                    elif j == half and fi == lf:
                        rows.add(2 * half)
        dp = np.abs(a[0].astype(np.int64) - b[0].astype(np.int64)).reshape(
            Y, W)
        if rows:
            rows = sorted(rows)
            flip_rows += len(rows)
            flip_lsb = max(flip_lsb, int(dp[rows].max()))
            dp[rows] = 0
        p999 = max(p999, float(np.percentile(dp[24:cut], 99.9)))
        pmax = max(pmax, int(dp[24:cut].max()))
        tmax = max(tmax, int(dp[cut:].max()))
        if a[1].shape != b[1].shape:
            fail('audio lengths differ, card vs CPU')
        audio_g.append(a[1])
        audio_c.append(b[1])
    da = np.abs(np.concatenate(audio_g).astype(np.float64)
                - np.concatenate(audio_c))
    picks = da > AUDIO_PICK_LSB
    arms = float(np.sqrt(np.mean(da[~picks] ** 2)))
    tail_max = PAL_TAIL_MAX if cfg.system == 'PAL' else 4
    print(f'card vs CPU, 2 frames: decisions, Philips codes and line-0 '
          f'words equal; hsync stage max|d| {dhs:.2e} px, bad-line flags '
          f'equal; final linelocs max|d| {dll:.2e} px before the last 10 '
          f'lines of a field, {dtail:.2e} px on them, wrap flips apart; '
          f'wrap flips: {nflip} lines, {flip_rows} picture rows reading '
          f'them, max {flip_lsb} LSB; picture p99.9 {p999} max {pmax} LSB '
          f'before the tail rows, tail rows max {tmax} (budget {tail_max}); '
          f'audio rms {arms:.3f} LSB with {int(picks.sum())} of {da.size} '
          f'values over {AUDIO_PICK_LSB} LSB')
    if dhs > 0.02 or dll > 0.02 or p999 > 2 or pmax > 4 or arms > 0.6 \
            or picks.mean() > AUDIO_PICK_MAX:
        fail('sequential card vs CPU outside the budgets')
    if dtail > 0.02 or tmax > tail_max:
        fail(f'{cfg.system} sequential tail lines outside the budgets')
    return launches, gpu[0][0]


def _wrap_flips(torch, np, cfg, step_a, step_b):
    """tbc/pal.py::wrap_flip_lines for one field decoded twice (card a,
    CPU b), from each decode's pilot-pass input: the hsync-stage line
    locations, split as the decoder splits them, and the two demod taps
    `pilot_offsets` reads.  Returns (lines, predicted, anchored,
    detail)."""
    from ld_decode_tpu_torch.tbc import pal as PAL
    got = []
    for _dev, ll, _bad, taps in (step_a, step_b):
        lli = np.floor(ll).astype(np.int32)
        llf = (ll - lli).astype(np.float32)
        dev = taps['demod'].device
        frac, cross = PAL.pilot_offsets(
            taps['demod'], taps['demod_05'],
            torch.from_numpy(lli)[None].to(dev),
            torch.from_numpy(llf)[None].to(dev), cfg.linelen, cfg.freq_mhz)
        got.append((frac[0].cpu().numpy(), cross[0].cpu().numpy(), lli,
                    llf))
    (fa, ca, ia, la), (fb, cb, ib, lb) = got
    return PAL.wrap_flip_lines(fa, ca, fb, cb, (ia, ib), (la, lb),
                               cfg.freq_mhz) + (_pilot_detail(np, got),)


def _pilot_detail(np, got):
    """A function of a line: each decode's pilot crossings on it (sample
    index: phase) and its hsync-stage location, for a failure's message."""
    def detail(l):
        return '; '.join(
            f'{name} loc {int(lli[l])} + {float(llf[l]):.6f}, crossings '
            + ', '.join(f'{i}:{frac[l, i]:.5f}'
                        for i in np.nonzero(cross[l])[0])
            for name, (frac, cross, lli, llf) in zip(('card', 'cpu'), got))
    return detail


def _flipped_lines(np, d, lines, predicted, anchored, detail,
                   what: str) -> list:
    """The lines of d (CPU - card, px) past 0.02 px, each of which must be
    a wrap flip whose difference is its prediction to 1e-4 px (F3,
    ROADMAP.md Queue 3); fails on any other.  Returns those lines."""
    pred = dict(zip(lines.tolist(), predicted.tolist()))
    kind = dict(zip(lines.tolist(), ['anchor' if a else 'phase'
                                     for a in anchored.tolist()]))
    far = [int(l) for l in np.nonzero(np.abs(d) > 0.02)[0]]
    for l in far:
        if l not in pred:
            fail(f'{what}: line {l} differs by {d[l]:.4f} px card vs CPU '
                 f'and is no wrap flip ({detail(l)})')
        if abs(d[l] - pred[l]) > 1e-4:
            fail(f'{what}: wrap flip at line {l}: {d[l]:.6f} px card vs '
                 f'CPU, {pred[l]:.6f} predicted ({detail(l)})')
    if far:
        print(f'{what}: wrap flips at lines {far}: '
              + ', '.join(f'{d[l]:+.6f} px (predicted {pred[l]:+.6f}, '
                          f'{kind[l]})' for l in far))
    return far


def locate_only_check(np, FR, CR, cfg, bank, loader, path, p, full,
                      hsync_stage):
    """Framer(cfg, bank, loader, False), the JAX package's positional
    full_decode=False: the first frame's fields located on the card with
    the line locations of the full decode's hsync stage (bit for bit: the
    same code on the same card) and its VBI, no frame, no picture, no audio
    and no line resample."""
    loc = FR.Framer(cfg, bank, loader, False, batch=1, nblocks=p['nblocks'],
                    device='cuda')
    CR.resample_lines_batch.launches = 0
    with open(path, 'rb') as fd:
        frame, audio, nxt, fields = loc.readframe(fd, p['start'], True)
    k1 = CR.resample_lines_batch.launches
    ok = frame is None and audio is None and nxt == full[0][2] and k1 == 0
    for f, ff in zip(fields, full[0][3]):
        ok &= any(h.shape == f.linelocs.shape
                  and np.array_equal(h, f.linelocs) for h in hsync_stage)
        ok &= (f.vbi, f.linecode, f.istop, f.linecount) \
            == (ff.vbi, ff.linecode, ff.istop, ff.linecount)
        ok &= f.dspicture is None and f.dsaudio is None \
            and f.burstlevel is None
    print(f'full_decode=False: frame {frame is not None}, audio '
          f'{audio is not None}, next sample {nxt} (full decode '
          f'{full[0][2]}), line locations = the hsync stage, VBI '
          f'{loc.vbi.get("framenr")} as the full decode; K1 launches {k1}')
    if not ok:
        fail('full_decode=False does not locate as the full decode does')


def _textured(np, base, n: int, seed: int):
    """n frames of `base` (525 x 910) under a smooth texture (up to +-4000
    counts from line 20 and column 60) moving 1 px a frame sideways and a
    line every other frame: content on which the flow is well posed
    (tests/test_torch_comb.py's textured frames)."""
    from scipy.ndimage import gaussian_filter
    rng = np.random.default_rng(seed)
    tex = gaussian_filter(rng.normal(0, 1, (560, 960)), 2.0)
    tex = tex / np.abs(tex).max() * 4000
    out = []
    for k in range(n):
        f = np.asarray(base).reshape(525, 910).astype(np.int64)
        t = np.roll(tex, (k // 2, k), axis=(0, 1))[:525, :910]
        f[20:, 60:] = np.clip(f[20:, 60:] + t[20:, 60:], 0, 65535)
        out.append(f.astype(np.uint16).reshape(-1))
    return out


def stream_comb_phase(torch, np, base):
    phase('16 streaming comb')
    from ld_decode_tpu_torch.comb.batch import NTSCCombBatch
    from ld_decode_tpu_torch.comb.comb_ntsc import CombConfig, NTSCComb
    from ld_decode_tpu_torch.ops import cuda_gather as CG
    frames = _textured(np, base, 6, RNG_SEED + 16)

    def stream(cfg, device, fr):
        comb = NTSCComb(cfg, device=device)
        out = []
        for f in fr:
            rgb = comb.process(f)
            if rgb is not None:
                out.append((rgb, comb.last_frame_words.copy()))
        return comb, out

    CG.take_along_axis.launches = 0
    CG.take_along_axis.row_launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, gpu = stream(CombConfig(dim=3), 'cuda', frames)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    k2, rows = CG.take_along_axis.launches, CG.take_along_axis.row_launches
    print(f'NTSCComb dim 3 with flow: {len(frames)} frames -> {len(gpu)} RGB '
          f'frames in {dt:.3f} s ({len(gpu) / dt:.2f} RGB frames/s, the '
          f'first frames included); K2 {k2} launches (9 per emitted frame: '
          f'frames 0 and 1 only seed the flow), {rows} on the row path')
    if len(gpu) != len(frames) - 2:
        fail(f'{len(gpu)} RGB frames from {len(frames)} (want n - 2)')
    if k2 != 9 * len(gpu) or rows != k2:
        fail(f'K2 launches {k2} ({rows} rows), expected {9 * len(gpu)}')

    # one frame, card vs CPU (phase 8's budgets), with the flows beside
    gcomb, g3 = stream(CombConfig(dim=3), 'cuda', frames[:3])
    ccomb, c3 = stream(CombConfig(dim=3), 'cpu', frames[:3])
    (g, gw), (c, cw) = g3[0], c3[0]
    if not np.array_equal(gw, cw) or not np.array_equal(g, gpu[0][0]):
        fail('card vs CPU: words differ, or the stream is not repeatable')
    dv = np.abs(g.astype(np.int64) - c.astype(np.int64))
    df = np.abs(torch.stack([gcomb._of_flows[0], gcomb._of_flows[1]]).cpu()
                .numpy() - torch.stack([ccomb._of_flows[0],
                                        ccomb._of_flows[1]]).numpy())
    print(f'one frame card vs CPU: p99.9 {float(np.percentile(dv, 99.9))} '
          f'max {int(dv.max())} LSB; flow p99 {np.percentile(df, 99):.3e} px')
    if np.percentile(dv, 99.9) > COMB_P999 or dv.max() > COMB_MAX \
            or np.percentile(df, 99) > FLOW_P99:
        fail('streaming comb card vs CPU outside the budgets')

    # the streaming against the batched comb on the card, -d 2
    _, s2 = stream(CombConfig(dim=2), 'cuda', frames)
    b2 = NTSCCombBatch(CombConfig(dim=2), device='cuda')
    r2, w2 = b2.collect(b2.feed(np.stack(frames)))
    d2 = max(int(np.abs(a.astype(np.int64) - b.astype(np.int64)).max())
             for (a, _), b in zip(s2, r2))
    print(f'streaming vs batched comb, -d 2: {len(s2)} frames, max {d2} LSB')
    if len(s2) != len(r2) or d2 > 1 or not all(
            np.array_equal(w, x) for (_, w), x in zip(s2, w2)):
        fail('streaming and batched comb disagree')

    # the debug surfaces, card vs CPU
    for name, cfg, n in (
            ('-D', CombConfig(dim=3, opticalflow=False, debug2d=True), 3),
            ('-k', CombConfig(dim=3, opticalflow=False, showk=True), 3),
            ('-l', CombConfig(dim=2, debugline=100), 1)):
        gc, go = stream(cfg, 'cuda', frames[:n])
        cc, co = stream(cfg, 'cpu', frames[:n])
        dd = int(np.abs(go[0][0].astype(np.int64)
                        - co[0][0].astype(np.int64)).max())
        msg = f'{name}: one frame, max {dd} LSB'
        bad = dd > 1
        if cfg.debug2d:
            gd, cd = gc.last_debug2d, cc.last_debug2d
            rel = max(abs(gd[k] - cd[k]) / abs(cd[k]) for k in ('mse', 'me'))
            msg += f'; totals MSE {gd["mse"]:.6g} ME {gd["me"]:.6g}, rel ' \
                   f'diff {rel:.2e}'
            bad |= rel > 1e-4
        print(msg)
        if bad:
            fail(f'debug surface {name}: card vs CPU outside the budgets')
    return k2


def _programme(np, n: int, seed: int):
    """tests/test_cx.py:64-81: tone bursts, level steps and silences, as
    offset-32768 uint16 stereo."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 48000.0
    env = np.zeros(n)
    pos = 0
    while pos < n:
        seg = int(rng.integers(12000, 60000))
        env[pos:pos + seg] = float(rng.choice([0.0, 0.05, 0.2, 0.5, 0.9]))
        pos += seg
    pcm = np.empty(n * 2, np.uint16)
    pcm[0::2] = np.clip(24000.0 * env * np.sin(2 * np.pi * 997 * t) + 32768,
                        0, 65535).astype(np.uint16)
    pcm[1::2] = np.clip(18000.0 * env * np.sin(2 * np.pi * 1501 * t)
                        + 32768, 0, 65535).astype(np.uint16)
    return pcm


def _event_ms(torch, fn, reps: int = 5) -> float:
    """Median device time of single eager calls between CUDA events, after
    two warm-up calls: for a kernel of milliseconds, the launch overhead is
    a fraction of a percent."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        ts.append(a.elapsed_time(b))
    return statistics.median(ts)


def k3_phase(torch, np):
    phase('17 K3: the CX envelope followers')
    import scipy.signal as sps
    from ld_decode_tpu_torch.audio import cuda_cx as CC
    from ld_decode_tpu_torch.audio import cx as CX
    pcm = _programme(np, 700_000, RNG_SEED + 17)
    zi = sps.lfilter_zi(*CX.F500) * 0.0
    fl, _ = sps.lfilter(*CX.F500, pcm[0::2].astype(np.float64) - 32768,
                        zi=zi)
    fr, _ = sps.lfilter(*CX.F500, pcm[1::2].astype(np.float64) - 32768,
                        zi=zi.copy())
    menv = np.maximum(np.abs(fl), np.abs(fr))
    core, warm = CX.CX_BLOCK_CORE, CX.CX_BLOCK_WARM
    nb = -(-len(menv) // core)
    mt = torch.from_numpy(menv.astype(np.float32))
    res = {}
    for dev in ('cuda', 'cpu'):
        t0 = time.perf_counter()
        out = CX._blocked_envelopes(mt.to(dev), np.float32(0), np.float32(0),
                                    core, warm, nb)
        res[dev] = [o.cpu().numpy() for o in out]
        print(f'blocked envelopes on the {dev}: {2 * nb} lanes of '
              f'{core + warm} steps, {time.perf_counter() - t0:.2f} s')
    (gf, gs, gd, ge), (cf, cs, cd, ce) = res['cuda'], res['cpu']
    err = max(float(np.abs(gf - cf).max()), float(np.abs(gs - cs).max()))
    exact = (np.array_equal(gf, cf) and np.array_equal(gs, cs)
             and gd == cd and ge == ce)
    ok_g, ok_c = bool(gd <= 0.05 and ge <= 1e-3), bool(cd <= 0.05
                                                       and ce <= 1e-3)
    print(f'K3 vs plain, 700,000 samples at core {core} / warm {warm}: '
          f'bit-equal {exact} (max|d| {err}); certificate gain gap '
          f'{float(gd)} / end gap {float(ge)}: ok {ok_g} on the card, '
          f'{ok_c} on the CPU')
    if not exact or ok_g != ok_c or not ok_g:
        fail('K3 disagrees with its plain version, or the certificate '
             'failed on programme audio')

    # the decaying envelope of tests/test_cx.py:141-145: the certificate
    # refuses and the one-lane scan takes over
    dec = 20000.0 * np.exp(-1.5e-5 * np.arange(400_000))
    CC.envelope_lanes.launches = 0
    _, _, ok = CX.envelope_followers_blocked(dec, 20000.0, 20000.0,
                                             device='cuda')
    f2, s2 = CX.envelope_followers(dec, 20000.0, 20000.0, device='cuda')
    n_dec = CC.envelope_lanes.launches
    pf, ps = CX._envelope_scan(dec[:65536], 20000.0, 20000.0, device='cpu')
    same = np.array_equal(f2[:65536], pf) and np.array_equal(s2[:65536], ps)
    print(f'decaying envelope: certificate ok {ok}; envelope_followers fell '
          f'back to the scan ({n_dec} launches: blocked twice, the scan '
          f'once); scan vs plain over the first 65,536 steps bit-equal '
          f'{same}')
    if ok or n_dec != 3 or not same:
        fail('the certificate fallback did not behave')

    # device time of one 1 MB chunk of 16-bit stereo: 262,144 samples, two
    # blocks, four lanes of core + warm steps
    chunk = mt[:262144]
    starts = [k * core - warm for k in range(2) for _ in range(2)]
    st0 = [(0.0, 0.0), (0.0, 0.0), (0.0, 0.0), (CX._ENV_CEIL, CX._ENV_CEIL)]
    gchunk = chunk.cuda()
    ms = _event_ms(torch, lambda: CC.envelope_lanes(gchunk, starts, st0,
                                                    warm, core))
    t0 = time.perf_counter()
    CC.envelope_lanes_plain(chunk, starts, st0, warm, core)
    plain_ms = (time.perf_counter() - t0) * 1e3
    smi = subprocess.run(['nvidia-smi', '--query-gpu=clocks.max.sm',
                          '--format=csv,noheader,nounits'],
                         capture_output=True, text=True, timeout=60)
    mhz = float(smi.stdout.strip().splitlines()[0])
    chain_ms = (core + warm) * K3_CHAIN_OPS * K3_OP_CYCLES / (mhz * 1e3)
    nbytes = 4 * (chunk.numel() + 4 * 2 * core)
    bytes_ms = nbytes / HBM_BYTES_S * 1e3
    bound_ms, bound_by = max((chain_ms, 'operations'), (bytes_ms, 'bytes'))
    print(f'K3, one 1 MB chunk (4 lanes x {core + warm} steps): {ms:.4f} ms '
          f'on the card (one eager call between CUDA events, median of 5); '
          f'plain version {plain_ms:.1f} ms on the CPU; bound {bound_ms:.4f} '
          f'ms by the dependent chain ({K3_CHAIN_OPS} ops x {K3_OP_CYCLES} '
          f'cycles a step at the {mhz:.0f} MHz maximum SM clock; the bytes '
          f'{bytes_ms * 1e3:.2f} us); {bound_ms / ms:.3f} of it')

    # the file-level path: CXExpander over the programme in 1 MB chunks
    CC.envelope_lanes.launches = 0
    cx = CX.CXExpander(device='cuda')
    s16 = (pcm.astype(np.int32) - 32768).astype('<i2')
    t0 = time.perf_counter()
    nout = 0
    for k in range(0, s16.size, 1 << 19):
        nout += cx.process(s16[k:k + (1 << 19)]).size
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = CC.envelope_lanes.launches
    print(f'CXExpander on the card, 700,000 samples in 1 MB chunks: '
          f'{dt:.3f} s, {nout} values out; K3 launches {launches}')
    if launches == 0 or nout != s16.size:
        fail('file-level CX did not run through K3')
    return dict(launches=launches, max_abs_err=err, ms=ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=None)


def _k4_library(torch, CW, out, n: int, last: float):
    """The same widening by PyTorch's own cast-copy over K4's ranges:
    out[a:b].copy_ from the uint16 view of the staged samples for every
    range but the last sample's (its input and output overlap, which
    copy_ refuses), that sample from the host, then the tail's zeroing."""
    u = out.view(torch.uint16)
    b = CW.widen_schedule(n, 2)
    for lo, hi in zip(b[:-2], b[1:-1]):
        out[lo:hi].copy_(u[n + lo:n + hi])
    out[n - 1:n].fill_(last)
    out[n:].zero_()


def k4_phase(torch, np):
    """K4 through to_device_capture, against its plain version, on the
    card; then its times at the .lds route's uint16 (module docstring,
    phase 30).  Returns the kernels line's numbers."""
    phase('30 K4: the capture widening')
    from ld_decode_tpu_torch.tbc import cuda_widen as CW
    from ld_decode_tpu_torch.tbc import framer as FR
    n = K4_SAMPLES
    rng = np.random.default_rng(RNG_SEED + 30)
    out = torch.full((n,), float('nan'), device='cuda')
    for label, name in K4_TYPES:
        dt = np.dtype(name)
        info = np.iinfo(dt)
        for m in (n, n - K4_TAIL):
            arr = rng.integers(info.min, info.max + 1, m, dtype=dt)
            launches, routes = CW.widen.launches, dict(CW.routes)
            torch.cuda.synchronize()
            held = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            FR.to_device_capture(arr, 'cuda', out=out)
            torch.cuda.synchronize()
            grew = (torch.cuda.memory_allocated() - held,
                    torch.cuda.max_memory_allocated() - held)
            nl = CW.widen.launches - launches
            want_nl = len(CW.widen_schedule(m, dt.itemsize)) - 1
            card = CW.routes['card'] - routes['card']
            want = torch.from_numpy(CW.widen_plain(arr)).cuda()
            exact = bool(torch.equal(out[:m].view(torch.int32),
                                     want.view(torch.int32))) \
                and not bool(out[m:].any())
            del want
            print(f'K4 {label} {name}, {m} samples into {n}: bit-equal '
                  f'{exact}, {nl} launches (schedule {want_nl}), card '
                  f'widenings {card}, allocated +{grew[0]} B (peak '
                  f'+{grew[1]} B)')
            if not exact or nl != want_nl or card != 1 or grew != (0, 0):
                fail(f'K4 {label} {name} at {m} samples: bit-equal {exact}, '
                     f'launches {nl} of {want_nl}, card widenings {card}, '
                     f'allocated +{grew}')
    launches = len(CW.widen_schedule(n, 2)) - 1

    # times at the .lds route's uint16 (10-bit values)
    arr = rng.integers(0, 1024, n, dtype=np.uint16)
    dev_ms, host_ms = [], []
    for _ in range(K4_REPS):
        CW.stage(arr, out)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        a.record()
        t0 = time.perf_counter()
        CW.widen(out, n, 2)
        host_ms.append((time.perf_counter() - t0) * 1e3)
        b.record()
        b.synchronize()
        dev_ms.append(a.elapsed_time(b))
    ms = statistics.median(dev_ms)
    bound_ms, bound_by = _bound(6 * n, 0)
    stage_ms = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        CW.stage(arr, out)
        torch.cuda.synchronize()
        stage_ms.append((time.perf_counter() - t0) * 1e3)
    plain_ms = []
    for _ in range(3):
        t0 = time.perf_counter()
        host = CW.widen_plain(arr)
        plain_ms.append((time.perf_counter() - t0) * 1e3)
    host_t, copy4_ms = torch.from_numpy(host), []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out.copy_(host_t)
        torch.cuda.synchronize()
        copy4_ms.append((time.perf_counter() - t0) * 1e3)

    # PyTorch's cast-copy over the same ranges, on the same staged samples
    library_ms, lib_note = None, ''
    want = host_t.cuda()
    try:
        lib = []
        for _ in range(K4_REPS):
            CW.stage(arr, out)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            a.record()
            _k4_library(torch, CW, out, n, float(arr[-1]))
            b.record()
            b.synchronize()
            lib.append(a.elapsed_time(b))
        same = bool(torch.equal(out.view(torch.int32), want.view(torch.int32)))
        library_ms = statistics.median(lib)
        lib_note = (f'{library_ms:.4f} ms ({min(lib):.4f}-{max(lib):.4f}), '
                    f'{launches + 1} calls, bit-equal {same}')
    except RuntimeError as e:
        lib_note = f'refused: {str(e).splitlines()[0]}'
    del want
    print(f'K4 .lds uint16, {n} samples: {ms:.4f} ms on the card '
          f'({min(dev_ms):.4f}-{max(dev_ms):.4f}; {K4_METHOD}), {launches} '
          f'launches, their host time {statistics.median(host_ms):.4f} ms; '
          f'bound {bound_ms:.4f} ms ({6 * n / 1e9:.2f} GB, {bound_by}; '
          f'{bound_ms / ms:.3f} of it)')
    print(f'K4 swap route: the copy of the samples as they are '
          f'{statistics.median(stage_ms):.3f} ms, then the kernel; the host '
          f'route it replaced: the float32 conversion '
          f'{statistics.median(plain_ms):.3f} ms, its 4-byte copy '
          f'{statistics.median(copy4_ms):.3f} ms; PyTorch cast-copy over '
          f'the same ranges {lib_note}')
    return dict(launches=launches, max_abs_err=0.0, ms=ms,
                call_ms=statistics.median(host_ms),
                plain_ms=statistics.median(plain_ms), plain_on='cpu',
                plain_copy_ms=statistics.median(copy4_ms),
                stage_ms=statistics.median(stage_ms), bound_ms=bound_ms,
                bound_by=bound_by, library_ms=library_ms,
                library=lib_note)


def _host_cpu() -> str:
    """The host CPU's model name, or its family and model where the name
    reads unknown."""
    fields = {}
    with open('/proc/cpuinfo') as f:
        for line in f:
            key, _, value = line.partition(':')
            fields.setdefault(key.strip(), value.strip())
            if not line.strip():
                break
    name = fields.get('model name', 'unknown')
    return (name if name != 'unknown' else
            f'{fields.get("vendor_id")} family {fields.get("cpu family")} '
            f'model {fields.get("model")}')


def unpack_phase(np):
    """The .lds unpack, one thread against the split the loader picks, on
    the card's host (module docstring, phase 31)."""
    phase('31 the .lds unpack on the host cores')
    from ld_decode_tpu_torch.io import native_unpack as NU
    cores = len(os.sched_getaffinity(0))
    rng = np.random.default_rng(RNG_SEED + 31)
    groups = K4_SAMPLES // 4
    raw = rng.integers(0, 256, groups * 5, dtype=np.uint8)
    lib = NU._load_threads()

    def unpack(g: int, threads: int):
        """g groups of raw on `threads` threads into a fresh array, as the
        loader's."""
        out = np.empty(g * 4, dtype=np.uint16)
        lib.unpack_4_40_threads(raw.ctypes.data, g, out.ctypes.data, threads)
        return out

    threads = NU.threads_for(groups)
    one = unpack(groups, 1)
    exact = bool(np.array_equal(unpack(groups, threads), one))
    exact &= bool(np.array_equal(NU.unpack_4_40(raw, groups * 4, 0), one))
    del one
    print(f'host {_host_cpu()}, {os.cpu_count()} CPUs, {cores} usable, CPU '
          f'quota {NU.quota_cpus()}; a {groups * 4} sample segment unpacks '
          f'on {threads} threads (MIN_GROUPS_PER_THREAD '
          f'{NU.MIN_GROUPS_PER_THREAD}), bit-equal to one thread {exact}')
    if not exact or threads < 2:
        fail(f'unpack: bit-equal {exact}, {threads} threads of {cores} cores')

    for g in UNPACK_SIZES + (groups,):
        # one thread, the powers of two below the loader's count and the
        # count, in turns
        most = NU.threads_for(g)
        ms = {t: [] for t in sorted({1, most} | {
            1 << k for k in range(most.bit_length()) if 1 << k < most})}
        for k in range(UNPACK_REPS if g == groups else 4 * UNPACK_REPS):
            for t in (list(ms) if k % 2 == 0 else list(ms)[::-1]):
                t0 = time.perf_counter()
                unpack(g, t)
                ms[t].append((time.perf_counter() - t0) * 1e3)
        print(f'unpack {g * 4} samples ({most} by the rule): ' + ', '.join(
            f'{t} thread{"s" * (t > 1)} {statistics.median(v):.3f} ms '
            f'({min(v):.3f}-{max(v):.3f})' for t, v in ms.items()))


def two_step_phase(torch, np, ntsc_cli, pal_cli, d: str):
    """ldexport and ldview in-process (their counters are this process's),
    on the files phases 6 and 14 wrote."""
    phase('18 two-step CLIs')
    import ldexport_torch
    import ldview_torch
    from ld_decode_tpu_torch.audio import cuda_cx as CC
    from ld_decode_tpu_torch.ops import cuda_gather as CG
    from ld_decode_tpu_torch.tbc import cuda_resample as CR
    cap_path, out = ntsc_cli
    pcm = np.fromfile(out + '.pcm', '<i2')
    longpcm = np.tile(pcm, -(-2 * 32768 // pcm.size) + 1)
    apath = os.path.join(d, 'long.pcm')
    longpcm.tofile(apath)
    CG.take_along_axis.launches = 0
    CG.take_along_axis.row_launches = 0
    CC.envelope_lanes.launches = 0
    counts = []
    for cb in ('1', '8'):
        o = os.path.join(d, f'export{cb}')
        t0 = time.perf_counter()
        rc = ldexport_torch.main([out + '.tbc', o, '-d', '3', '--comb-batch',
                                  cb, '-a', apath, '--write-images'])
        imgs = [f for f in os.listdir(d) if f.startswith(f'export{cb}_')]
        sizes = {os.path.getsize(os.path.join(d, f)) for f in imgs}
        apcm = os.path.getsize(o + '.audio.pcm')
        print(f'ldexport_torch.py -d 3 --comb-batch {cb} -a '
              f'({longpcm.size // 2} stereo samples): exit {rc}, '
              f'{time.perf_counter() - t0:.1f} s, {len(imgs)} images of '
              f'{sizes} bytes, .audio.pcm {apcm} bytes')
        if rc != 0 or sizes != {480 * 744 * 3 * 2} \
                or apcm != longpcm.size * 2:
            fail('ldexport -d 3 wrote the wrong outputs')
        counts.append(len(imgs))
    k2, rows = CG.take_along_axis.launches, CG.take_along_axis.row_launches
    k3 = CC.envelope_lanes.launches
    print(f'ldexport launches: K2 {k2} ({rows} on the row path), K3 {k3}')
    if counts[0] != counts[1] or counts[0] < 6 or k2 == 0 or rows != k2 \
            or k3 == 0:
        fail('ldexport: image counts differ or a kernel did not launch')

    pcap, pout = pal_cli
    o = os.path.join(d, 'export_pal')
    rc = ldexport_torch.main([pout + '.tbc', o, '--pal', '-d', '3',
                              '--write-images'])
    imgs = [f for f in os.listdir(d) if f.startswith('export_pal_')]
    sizes = {os.path.getsize(os.path.join(d, f)) for f in imgs}
    print(f'ldexport_torch.py --pal -d 3: exit {rc}, {len(imgs)} images of '
          f'{sizes} bytes')
    if rc != 0 or len(imgs) != 8 or sizes != {576 * 1135 * 3 * 2}:
        fail('ldexport --pal wrote the wrong outputs')

    CR.resample_lines_batch.launches = 0
    img = os.path.join(d, 'view.png')
    t0 = time.perf_counter()
    rc = ldview_torch.main([cap_path, '902', img])
    k1 = CR.resample_lines_batch.launches
    if os.path.exists(img):
        from PIL import Image
        shape = np.asarray(Image.open(img)).shape
        what = f'{img} {shape}'
        good = shape == (480, 744, 3)
    else:
        size = os.path.getsize(img + '.rgb')
        what = f'{img}.rgb (no pillow) {size} bytes'
        good = size == 744 * 480 * 3 * 2
    print(f'ldview_torch.py, CAV 902: exit {rc}, '
          f'{time.perf_counter() - t0:.1f} s, {what}; K1 launches {k1}')
    if rc != 0 or not good or k1 == 0:
        fail('ldview did not write a 744 x 480 image')
    return dict(k2=k2, k3=k3, k1_view=k1)


# NN comb card vs CPU: the forward pass within 5e-5 of max|out| (TF32 would
# show as ~5e-4), and the comb's card vs CPU RGB budget (phase 8)
NN_FWD_TOL = 5e-5
NN_TRAIN_LOSS = 80.0    # IRE^2, tests/test_nn_comb.py's bound
NN_STEPS = 250          # train_nn_comb's default run
NN_DRAWS = 6            # batch draws through a graph vs eager
# graphed vs eager training where eager does not repeat itself (cuDNN's
# weight gradients): the losses (relative), parameters and each of Adam's
# moments within NN_SPREAD times their largest spread among NN_EAGER_RUNS
# eager runs of the default run (with 3 eager runs, graphed read 0.90-1.70
# times eager's largest spread, PERF.md; 5 runs give 10 eager pairs
# against graphed's 5, so one wide eager pair less often decides)
NN_SPREAD = 2
NN_EAGER_RUNS = 5
NN_FRAMES = 24          # comb_frame_nn frames, eager then graphed
NN_T_FRAMES = 11        # .tbc frames of the -t runs: pair windows 8 and 1


def _state_close(a, b) -> float:
    return max(float((a[k].cpu() - b[k].cpu()).abs().max()) for k in a)


def nn_comb_phase(torch, np, ntsc_cli, d: str):
    """The NN comb at full width: TF32 off, the forward pass, the default
    training run, three train steps, comb_frame_nn and the training pairs,
    each on the card against the CPU, and ldexport_torch.py -t."""
    phase('19 NN comb')
    import ldexport_torch
    from ld_decode_tpu_torch.comb import comb_ntsc as CN
    from ld_decode_tpu_torch.models import nn_comb as NC
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    print(f'cudnn.allow_tf32 {tf32[0]}, cuda.matmul.allow_tf32 {tf32[1]}')
    if any(tf32):
        fail('TF32 is on: the convolutions would not run in full float32')
    _, out = ntsc_cli
    frames = np.fromfile(out + '.tbc', '<u2').reshape(-1, CN.IN_Y, CN.IN_X)

    # the forward pass on one full frame, the same weights on both
    model = NC.NNComb().cuda()
    cpu_model = NC.NNComb()
    cpu_model.load_state_dict({k: v.cpu() for k, v in
                               model.state_dict().items()})
    raw = torch.from_numpy(frames[1].astype(np.int32))
    flip = torch.where(raw[:, 0] == 16384, 1.0, -1.0)
    x = NC.model_inputs(raw, flip)[None]
    with torch.no_grad():
        g = model(x.cuda())
        c = cpu_model(x)
    err = float((g.cpu() - c).abs().max()) / float(c.abs().max())
    with torch.no_grad():
        xg = x.cuda()
        fwd_ms = _event_ms(torch, lambda: model(xg))
    print(f'NNComb() forward on {tuple(x.shape)}: output on '
          f'{g.device.type}, card vs CPU max|d| {err:.2e} of max|out| '
          f'(budget {NN_FWD_TOL:g}); {fwd_ms:.3f} ms a forward (CUDA '
          f'events, median of 5)')
    if g.device.type != 'cuda' or err > NN_FWD_TOL:
        fail('NN forward: card vs CPU outside the budget')

    # the default training run on the card, eager then graphed, twice
    # each: the first run in the process also pays cuDNN's first use of
    # each convolution shape (the graphed one its warm-up and capture)
    runs = {}
    for graphs in (False, True):
        for _ in range(2):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            trained, loss = NC.train_nn_comb(device='cuda', graphs=graphs)
            torch.cuda.synchronize()
            runs.setdefault(graphs, []).append(
                (loss, time.perf_counter() - t0,
                 torch.cuda.max_memory_allocated() / 2**20))
    for graphs, rr in runs.items():
        print(f'train_nn_comb() at its defaults (250 steps, batch 8, 64 x '
              f'256), {"graphed" if graphs else "eager"}: '
              + ', '.join(f'loss {l:.3f} IRE^2 in {s:.3f} s (peak {m:.1f} '
                          f'MiB)' for l, s, m in rr)
              + f' (first and second run; bound {NN_TRAIN_LOSS})')
    if not all(l < NN_TRAIN_LOSS for rr in runs.values() for l, _, _ in rr) \
            or next(trained.parameters()).device.type != 'cuda':
        fail('NN training did not reach the loss bound on the card')
    res = {'train_s': {('graphed' if g else 'eager'): [r[1] for r in rr]
                       for g, rr in runs.items()}}
    res.update(_nn_graphs_check(torch, NC))

    # three train steps on identical batches, card vs CPU
    gen = torch.Generator().manual_seed(RNG_SEED)
    batches = [NC.synth_batch(gen, 8, 64, 256)[:2] for _ in range(3)]
    a, b = NC.NNComb().cuda(), NC.NNComb()
    b.load_state_dict({k: v.cpu() for k, v in a.state_dict().items()})
    oa, ob = NC.make_optimizer(a, 3e-3), NC.make_optimizer(b, 3e-3)
    la, lb = [], []
    for inp, clp in batches:
        la.append(float(NC.train_step(a, oa, inp.cuda(), clp.cuda())))
        lb.append(float(NC.train_step(b, ob, inp, clp)))
    dparam = _state_close(a.state_dict(), b.state_dict())
    dloss = max(abs(p - q) / abs(q) for p, q in zip(la, lb))
    inp, clp = batches[0][0].cuda(), batches[0][1].cuda()
    step_ms = _event_ms(torch, lambda: NC.train_step(a, oa, inp, clp))
    print(f'3 train steps, card vs CPU: losses {la} / {lb} (max rel '
          f'{dloss:.2e}), parameters max|d| {dparam:.2e} (budget 0.01 * lr '
          f'= 3e-5); {step_ms:.3f} ms a train step at batch 8 x 64 x 256 '
          f'(CUDA events, median of 5)')
    if dloss > 1e-5 or dparam > 3e-5:
        fail('train steps: card vs CPU outside the budget')

    res['comb_frame_nn'] = _nn_comb_frames(torch, np, NC, CN, trained,
                                           frames)

    # comb_frame_nn on one frame, the trained weights on both
    cfg = CN.CombConfig(dim=2)
    cpu_trained = NC.NNComb()
    cpu_trained.load_state_dict({k: v.cpu() for k, v in
                                 trained.state_dict().items()})
    rg, abg = NC.comb_frame_nn(raw.cuda(), trained, -1.0, cfg)
    rc, abc = NC.comb_frame_nn(raw, cpu_trained, -1.0, cfg)
    dv = np.abs(rg.cpu().numpy().astype(np.int64) - rc.numpy())
    p999 = float(np.percentile(dv, 99.9))
    print(f'comb_frame_nn {tuple(rg.shape)} on {rg.device.type}: card vs '
          f'CPU p99.9 {p999} max {int(dv.max())} LSB (budget {COMB_P999} / '
          f'{COMB_MAX}), AGC carry {abg:.6f} / {abc:.6f}')
    if rg.device.type != 'cuda' or p999 > COMB_P999 or dv.max() > COMB_MAX \
            or abs(abg - abc) > 1e-5 * abs(abc):
        fail('comb_frame_nn: card vs CPU outside the budget')

    # the training pairs of the decoded .tbc frames
    gi, gc = NC.training_pairs_from_frames(frames, device='cuda')
    ci, cc = NC.training_pairs_from_frames(frames, device='cpu')
    dclp = float(np.abs(gc - cc).max()) / float(np.abs(cc).max())
    print(f'training_pairs_from_frames on {len(frames)} .tbc frames: '
          f'{gi.shape[0]} pairs, inputs equal {np.array_equal(gi, ci)}, clp '
          f'max|d| {dclp:.2e} of its peak')
    if gi.shape != (len(frames) - 2, CN.IN_Y, CN.IN_X, 3) \
            or not np.array_equal(gi, ci) or dclp > 1e-5:
        fail('training pairs: card vs CPU outside the budget')

    # ldexport_torch.py -t (eager pair windows, as the CLI runs them) on
    # the .tbc frames cycled to NN_T_FRAMES, then the step of -t that
    # graphs change, write_training_file on the same frames, eager and
    # graphed: the same .npz as the CLI's; and the pairs alone of
    # ldexport's most frames (TRAIN_FRAMES) both ways, twice
    tiled = np.stack([frames[k % len(frames)] for k in range(NN_T_FRAMES)])
    tiled.astype('<u2').tofile(os.path.join(d, 'tiled.tbc'))
    o = os.path.join(d, 'train')
    t0 = time.perf_counter()
    rc_ = ldexport_torch.main([os.path.join(d, 'tiled.tbc'), o, '-t', '-F'])
    cli_s = time.perf_counter() - t0
    cli = dict(np.load(o + '.train.npz'))
    imgs = [f for f in os.listdir(d) if f.startswith('train_')]
    print(f'ldexport_torch.py -t -F on {NN_T_FRAMES} frames: exit {rc_}, '
          f'{cli_s:.3f} s, train.npz inputs {cli["inputs"].shape} clp '
          f'{cli["clp"].shape}, {len(imgs)} images')
    if rc_ != 0 or cli['inputs'].shape != (
            NN_T_FRAMES - 2, CN.IN_Y, CN.IN_X, 3) or not imgs:
        fail('ldexport -t did not write the training pairs')
    res['ldexport_t_s'] = cli_s
    res['write_training_file_s'] = {}
    for graphs in (False, True):
        name = 'graphed' if graphs else 'eager'
        path = os.path.join(d, f'pairs_{name}.npz')
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        NC.write_training_file(tiled, path, device='cuda', graphs=graphs)
        res['write_training_file_s'][name] = time.perf_counter() - t0
        npz = np.load(path)
        if any(not np.array_equal(npz[k], cli[k]) for k in ('inputs', 'clp')):
            fail(f'write_training_file ({name}) differs from ldexport -t')
    print('write_training_file, -t\'s pairs step, on the same frames: '
          + ', '.join(f'{k} {v:.3f} s' for k, v in
                      res['write_training_file_s'].items())
          + '; both equal to the CLI\'s .npz')
    many = np.stack([frames[k % len(frames)]
                     for k in range(ldexport_torch.TRAIN_FRAMES)])
    pair_s, pairs = {}, {}
    for graphs in (False, True, False, True):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pairs[graphs] = NC.training_pairs_from_frames(many, device='cuda',
                                                      graphs=graphs)
        pair_s.setdefault('graphed' if graphs else 'eager', []).append(
            time.perf_counter() - t0)
    res['pairs_s'] = pair_s
    same = all(np.array_equal(a, b) for a, b in zip(pairs[False],
                                                     pairs[True]))
    print(f'training_pairs_from_frames on {len(many)} frames (eager, '
          f'graphed, eager, graphed): '
          + ', '.join(f'{k} {v[0]:.3f} / {v[1]:.3f} s'
                      for k, v in pair_s.items())
          + f'; graphed == eager {same}')
    if not same:
        fail('training pairs: graphed differ from eager')
    return res


def _nn_trainer(torch, NC, graphs, steps: int = NN_STEPS):
    """The default training run as train_nn_comb builds it, through a
    Trainer: (its losses step by step, the trainer)."""
    gen = torch.Generator(device='cuda').manual_seed(0)
    model = NC.NNComb().cuda()
    model.reset_parameters(gen)
    t = NC.Trainer(model, NC.make_optimizer(model, 3e-3), gen, 8, 64, 256,
                   graphs=graphs)
    return torch.stack([t.step().clone() for _ in range(steps)]), t


def _nn_spreads(torch, run_a, run_b) -> dict:
    """Largest differences of two runs (losses, trainer): losses relative,
    parameters and each Adam moment absolute, and whether Adam's step
    counts and the generators' states are equal."""
    (la, ta), (lb, tb) = run_a, run_b
    sa, sb = list(ta.opt.state.values()), list(tb.opt.state.values())
    out = {'loss': float(((la - lb).abs() / la.abs()).max()),
           'param': max(float((a - b).abs().max()) for a, b in zip(
               ta.model.parameters(), tb.model.parameters()))}
    for k in ('exp_avg', 'exp_avg_sq'):
        out[k] = max(float((x[k] - y[k]).abs().max())
                     for x, y in zip(sa, sb))
    out['steps_equal'] = len(sa) == len(sb) and all(
        torch.equal(x['step'], y['step']) for x, y in zip(sa, sb))
    out['generator_equal'] = torch.equal(ta.generator.get_state(),
                                         tb.generator.get_state())
    return out


def _nn_draws_check(torch, NC) -> bool:
    """The trainer's batch draws (synthetic scenes and file crops) through
    a GraphCache against eager from the same seed, over NN_DRAWS calls (a
    warm-up, a capture, replays): the registered generator must advance
    on each replay as an eager call advances it."""
    from ld_decode_tpu_torch.utils.graphs import GraphCache
    data = tuple(torch.randn(s, generator=torch.Generator('cuda').manual_seed(
        1), device='cuda') for s in ((3, 96, 320, 3), (3, 96, 320)))
    outs = []
    for cache in (GraphCache('cuda', 'eager'), GraphCache('cuda')):
        gen = torch.Generator('cuda').manual_seed(RNG_SEED)
        draws = []
        for _ in range(NN_DRAWS):
            got = cache('draw', lambda: (NC.synth_batch(gen, 8, 64, 256)
                                         + NC._file_batch(gen, data, 8, 64,
                                                          256)), (),
                        generators=(gen,))
            draws.append([x.clone() for x in got])
        outs.append((draws, gen.get_state()))
    (de, ge), (dg, gg) = outs
    return torch.equal(ge, gg) and all(
        torch.equal(a, b) for x, y in zip(de, dg) for a, b in zip(x, y))


def _nn_graphs_check(torch, NC) -> dict:
    """The default run eager NN_EAGER_RUNS times and graphed once.  Eager
    against itself first (cuDNN's weight gradients need not be
    deterministic): graphed must differ from each eager run by at most
    NN_SPREAD times the largest difference between two eager runs, in the
    losses, the parameters and each of Adam's moments, so that where
    eager repeats itself graphed equals it bit for bit.  Always equal:
    the first step's loss (a forward of the same weights on the same
    draws), Adam's step counts, the generator's state.  One warm-up and
    one capture; ms a step both ways."""
    eager = [_nn_trainer(torch, NC, False) for _ in range(NN_EAGER_RUNS)]
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_reserved()
    graphed = _nn_trainer(torch, NC, True)
    peak = torch.cuda.max_memory_allocated() / 2**20
    grown = (torch.cuda.memory_reserved() - base) / 2**20
    g = graphed[1]

    def first_difference(a, b) -> int:
        d = (a != b).nonzero()
        return int(d[0]) + 1 if len(d) else 0

    own = [_nn_spreads(torch, a, b) for i, a in enumerate(eager)
           for b in eager[i + 1:]]
    got = [_nn_spreads(torch, e, graphed) for e in eager]
    groups = ('loss', 'param', 'exp_avg', 'exp_avg_sq')
    ee = {k: max(x[k] for x in own) for k in groups}
    ge = {k: max(x[k] for x in got) for k in groups}
    repeat = not any(ee.values())
    exact = not any(ge.values())
    first = max(first_difference(eager[0][0], l) for l, _ in eager[1:])
    first_g = first_difference(eager[0][0], graphed[0])
    first_equal = all(torch.equal(l[0], graphed[0][0]) for l, _ in eager)
    same = all(x['steps_equal'] and x['generator_equal'] for x in got)
    draws = _nn_draws_check(torch, NC)
    counts = dict(g.graphs.counts)
    cap_s = list(g.graphs.capture_seconds.values())
    ms = {}
    for name, t in (('eager', eager[0][1]), ('graphed', g)):
        ev = _event_ms(torch, t.step)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(50):
            t.step()
        torch.cuda.synchronize()
        ms[name] = dict(event_ms=ev,
                        wall_ms=(time.perf_counter() - t0) / 50 * 1e3)

    def fmt(d):
        return ', '.join(f'{k} {d[k]:.2e}' for k in groups)

    print(f'NN train step, the default run ({NN_STEPS} steps): '
          f'{NN_EAGER_RUNS} eager runs '
          f'{"bit-equal" if repeat else "NOT repeatable"} (first loss '
          f'difference by step {first}; largest spread: {fmt(ee)}); '
          f'graphed vs each eager run '
          f'{"bit-equal" if exact else "not bit-equal"} (first loss '
          f'difference from the first at step {first_g}; largest: '
          f'{fmt(ge)};'
          f' budget {NN_SPREAD} x eager\'s, ratios '
          + ', '.join(f'{k} {ge[k] / ee[k]:.2f}' if ee[k] else f'{k} -'
                      for k in groups)
          + f'); Adam step counts and generator equal {same}; draws through'
          f' a graph == eager over {NN_DRAWS} calls {draws}; cache {counts}, '
          f'capture {cap_s} s; ms a step eager '
          f'{ms["eager"]["event_ms"]:.3f} (CUDA events, median of 5) / '
          f'{ms["eager"]["wall_ms"]:.3f} (wall, 50 steps), graphed '
          f'{ms["graphed"]["event_ms"]:.3f} / '
          f'{ms["graphed"]["wall_ms"]:.3f}; graphed run peak '
          f'{peak:.1f} MiB, reserved +{grown:.1f} MiB')
    if counts['eager_warmups'] != 1 or counts['captures'] != 1 \
            or counts['replays'] != NN_STEPS - 2:
        fail(f'NN train step: {counts}, not one warm-up and one capture')
    if not draws or not same:
        fail('NN train step: the graphed draws, step counts or generator '
             'differ from eager')
    if not first_equal or any(ge[k] > NN_SPREAD * ee[k] for k in groups):
        fail('NN train step: graphed outside eager\'s own spread')
    return dict(step_ms=ms, eager_repeatable=repeat, graphed_exact=exact,
                first_eager_difference=first,
                first_graphed_difference=first_g, eager_spread=ee,
                graphed_spread=ge, draws_equal=draws, capture_s=cap_s,
                peak_mib=peak, reserved_grown_mib=grown)


def _nn_comb_frames(torch, np, NC, CN, model, frames) -> dict:
    """comb_frame_nn over NN_FRAMES frames of the .tbc (cycled), eager then
    through one GraphCache: RGB and carries bit-equal; frames/s whole and
    after the capture (the third frame on), each frame's RGB copied to the
    host."""
    from ld_decode_tpu_torch.utils.graphs import GraphCache
    cfg = CN.CombConfig(dim=2)
    dev = [torch.from_numpy(frames[k % len(frames)].astype(np.int32)).cuda()
           for k in range(NN_FRAMES)]
    outs, rates = {}, {}
    for name, cache in (('eager', None), ('graphed', GraphCache('cuda'))):
        ab, rgb, ts = -1.0, [], []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for f in dev:
            r, ab = NC.comb_frame_nn(f, model, ab, cfg, graphs=cache)
            rgb.append((r.cpu(), ab))
            ts.append(time.perf_counter())
        outs[name] = rgb
        rates[name] = dict(whole=NN_FRAMES / (ts[-1] - t0),
                           after_capture=(NN_FRAMES - 2) / (ts[-1] - ts[1]))
        if cache is not None:
            rates[name]['counts'] = dict(cache.counts)
            rates[name]['capture_s'] = list(cache.capture_seconds.values())
    same = all(torch.equal(a[0], b[0]) and a[1] == b[1]
               for a, b in zip(outs['eager'], outs['graphed']))
    # where a graphed frame's time goes, on the last frame: the host AGC
    # (burst_levels, its read-back included; wall, median of 5), the comb
    # after it replayed through a cache of its own (CUDA events, median of
    # 5 replays) and the RGB's copy to the host (wall, median of 5)
    f = dev[-1]
    levels, _ = CN.burst_levels(f[None], -1.0, cfg)
    timing = GraphCache('cuda')

    def core(raw, lv):
        return NC._comb_nn_core(raw, lv, model, cfg)

    def replay():
        return timing('comb_nn', core, (f, levels[0]),
                      reads=tuple(model.parameters()))

    def wall_ms(fn):
        ts = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            ts.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(ts)

    comb_ms = _event_ms(torch, replay)
    rgb = replay()
    parts = dict(agc_host_ms=wall_ms(lambda: CN.burst_levels(
                     f[None], -1.0, cfg)),
                 comb_device_ms=comb_ms,
                 rgb_copy_ms=wall_ms(lambda: rgb.cpu()))
    rates['graphed']['breakdown'] = parts
    print(f'comb_frame_nn over {NN_FRAMES} frames: graphed == eager {same} '
          f'(RGB48 and AGC carry); RGB frames/s whole, from frame 3: eager '
          f'{rates["eager"]["whole"]:.2f}, '
          f'{rates["eager"]["after_capture"]:.2f}; graphed '
          f'{rates["graphed"]["whole"]:.2f}, '
          f'{rates["graphed"]["after_capture"]:.2f}; cache '
          f'{rates["graphed"]["counts"]}, capture '
          f'{rates["graphed"]["capture_s"]} s; a graphed frame: host AGC '
          f'{parts["agc_host_ms"]:.3f} ms, the comb replayed '
          f'{parts["comb_device_ms"]:.3f} ms (CUDA events), RGB copy '
          f'{parts["rgb_copy_ms"]:.3f} ms')
    if not same or rates['graphed']['counts']['captures'] != 1:
        fail('comb_frame_nn: graphed differs from eager')
    return rates


def vhs_phase(torch, np):
    """The VHS tape decode window by window on the card against the CPU,
    its levels and audio carriers, the color-under recovery, and the host
    copies that ride with the slice."""
    phase('20 VHS tape decode')
    from ld_decode_tpu_torch.models import encode as E
    from ld_decode_tpu_torch.ops import demod as D
    from ld_decode_tpu_torch.tape import vhs as V
    from ld_decode_tpu_torch.utils import fdls, filtermaker, filtertools
    from ld_decode_tpu_torch.vbi import iec60857
    cfg = V.vhs_config()
    nblocks, nwin = 66, 4
    n = D.stream_len(cfg, nblocks)
    step = nblocks * cfg.block_keep
    need = n + (nwin - 1) * step
    nframes = int(np.ceil(need / (cfg.freq_hz / cfg.sys.fps))) + 1
    t0 = time.perf_counter()
    cap = E.encode_frames(cfg, nframes, E.EncodeSpec(pattern='flat50'))
    cap = cap[:need].astype(np.float32)
    print(f'tape capture: {nframes} frames at {cfg.freq_mhz:.4f} MSa/s, '
          f'{need} samples ({nwin} windows of nblocks {nblocks}), made in '
          f'{time.perf_counter() - t0:.1f} s')
    gbank = V.make_vhs_bank(cfg, device='cuda')
    cbank = V.make_vhs_bank(cfg, device='cpu')
    dcap = torch.from_numpy(cap).cuda()
    wins = [(k * step) for k in range(nwin)]
    dluma, dhz, gvid, gaud = 0, 0.0, [], []
    for w0 in wins:
        gv, ga = V.decode_vhs(dcap[w0:w0 + n], gbank, cfg, nblocks,
                              graphs=False)
        cv, ca = V.decode_vhs(torch.from_numpy(cap[w0:w0 + n]), cbank, cfg,
                              nblocks)
        if gv['luma'].device.type != 'cuda':
            fail('decode_vhs did not run on the card')
        dluma = max(dluma, int((gv['luma'].cpu() - cv['luma']).abs().max()))
        scale = float(cv['demod'].abs().max())
        dhz = max(dhz, float((gv['demod'].cpu() - cv['demod']).abs().max())
                  / scale)
        gvid.append({k: v.cpu().numpy() for k, v in gv.items()})
        gaud.append({k: v.cpu().numpy() for k, v in ga.items()})
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for w0 in wins:
        V.decode_vhs(dcap[w0:w0 + n], gbank, cfg, nblocks, graphs=False)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    msa = nwin * step / dt / 1e6
    print(f'decode_vhs, {nwin} windows card vs CPU: luma max|d| {dluma} LSB '
          f'(budget 1), demod max|d| {dhz:.2e} of its scale (budget 1e-6); '
          f'{msa:.2f} MSa/s on the card ({nwin} windows in {dt * 1e3:.1f} '
          f'ms)')
    if dluma > 1 or dhz > 1e-6:
        fail('decode_vhs: card vs CPU outside the budget')

    ire = cfg.hztoire(np.concatenate([v['demod'] for v in gvid])
                      .astype(np.float64))
    tips = ire[ire < -25]
    flat = ire[(ire > 25) & (ire < 75)]
    luma = np.concatenate([v['luma'] for v in gvid]).astype(np.float64)
    m = (ire > 25) & (ire < 75)
    dl = float(np.abs(luma[m] / V.OUT_SCALE + V.MIN_IRE - ire[m]).max())
    left = float(np.median(np.concatenate([a['audio_left'] for a in gaud])))
    right = float(np.median(np.concatenate([a['audio_right']
                                            for a in gaud])))
    print(f'levels: flat {np.median(flat):.3f} IRE, sync tips p10 '
          f'{np.percentile(tips, 10):.3f} / median {np.median(tips):.3f} '
          f'IRE, luma scale max|d| {dl:.4f} IRE; audio carriers '
          f'{left:.0f} / {right:.0f} Hz (want {cfg.sys.audio_lfreq:.0f} / '
          f'{cfg.sys.audio_rfreq:.0f})')
    if abs(np.median(flat) - 50) > 1 \
            or abs(np.percentile(tips, 10) + 40) > 1 \
            or not -40.5 < np.median(tips) < -30 or dl > 0.01 \
            or abs(left - cfg.sys.audio_lfreq) > 1e4 \
            or abs(right - cfg.sys.audio_rfreq) > 1e4:
        fail('VHS levels or audio carriers off')

    # color-under chroma on a 2^22-sample tape signal
    fs, fsc, nc = cfg.freq_hz, cfg.sys.fsc_mhz * 1e6, 1 << 22
    tt = np.arange(nc, dtype=np.float64) / fs
    chroma = (1.0 + 0.3 * np.sin(2 * np.pi * 500.0 * tt)) * np.cos(
        2 * np.pi * fsc * tt + 0.6 * np.sin(2 * np.pi * 300.0 * tt))
    rf = np.cos(np.cumsum(np.full(nc, cfg.iretohz(50.0))) * (2 * np.pi / fs))
    tape = (rf * 350.0 + 0.25 * 350.0 * V.encode_color_under(cfg, chroma)
            + 512.0).astype(np.float32)
    g = V.recover_color_under(torch.from_numpy(tape).cuda(), cfg)
    c = V.recover_color_under(torch.from_numpy(tape), cfg).numpy()
    gn = g.cpu().numpy()
    dcu = float(np.abs(gn - c).max()) / float(np.abs(c).max())
    sl = slice(nc // 8, -nc // 8)
    out = gn[sl].astype(np.float64) / (0.25 * 350.0)
    ref = chroma[sl]
    corr = float(np.dot(ref, out) / np.sqrt(np.dot(ref, ref)
                                            * np.dot(out, out)))
    print(f'recover_color_under on {nc} samples ({g.device.type}): '
          f'correlation {corr:.5f} with the truth, card vs CPU max|d| '
          f'{dcu:.2e} of its peak')
    if g.device.type != 'cuda' or corr <= 0.98 or dcu > 1e-4:
        fail('color-under recovery off')

    # the host copies this slice added, once each
    inv = filtermaker.design_inventory()
    text, _ = filtermaker.render_header()
    v = iec60857.interpret_iec60857(0, 0xF80123, 0xF80123)
    b, a_ = fdls.fdls_from_filter(*inv['deemp_vhs'], 1, 1)
    rep = filtertools.response_report(b, a_)
    print(f'host copies: {len(inv)} designs, ldd_filters.h {len(text)} '
          f'chars, IEC 60857 {v.disc_type} picture {v.picture_number}, '
          f'VHS deemp FDLS refit peak {rep["peak_db"]:.2f} dB')
    if v.picture_number != 0x80123 or len(inv) < 17:
        fail('host copies')


def loader_phase(torch, np, cfg, cap, d: str):
    """The segmented decode (a loader over an .lds file, batch 16) of the
    NTSC capture of phase 4, once per .lds unpack route, against the
    resident decode of the same capture.  The file is shorter than two
    chain horizons, so one segment holds all of it: its one unpack is
    inside the first frame's time.  (scripts/loader_rate_torch.py times a
    file of several segments.)"""
    phase('21 loader: segmented .lds decode, native and numpy unpack')
    from ld_decode_tpu_torch.io import loaders as L
    from ld_decode_tpu_torch.io import native_unpack as NU
    from ld_decode_tpu_torch.ops import filters as F
    from ld_decode_tpu_torch.tbc import framer as FR
    if not NU.available():
        fail('the C++ unpack (csrc/unpack.cpp) did not build with g++')
    p = DECODE_PATHS['NTSC']
    path = os.path.join(d, 'ramp.lds')
    NU.pack_4_40(cap).tofile(path)
    bank = F.make_demod_bank(cfg, np.complex64, device='cuda')
    spf = cfg.freq_hz / cfg.sys.fps

    def decode(**source):
        fr = FR.Framer(cfg, bank, batch=16, nblocks=p['nblocks'],
                       device='cuda', **source)
        with open(path, 'rb') as fd:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rv = fr.readframe(fd, p['start'], True)
            pics, nums, sample = [rv[0]], [fr.vbi.get('framenr')], rv[2]
            t1 = time.perf_counter()
            while len(pics) <= p['want']:
                rv = fr.readframe(fd, sample, False)
                if rv[0] is None:
                    break
                pics.append(rv[0])
                nums.append(fr.vbi.get('framenr'))
                sample = rv[2]
            torch.cuda.synchronize()
            t2 = time.perf_counter()
        return pics, nums, t1 - t0, t2 - t1, fr.prefetcher.stats

    resident = decode(capture=cap)         # the reference; warms up
    out = {}
    for route in ('native', 'numpy'):
        L.set_native(route == 'native')
        if L.unpack_route() != route:
            fail(f'the .lds unpack does not take the {route} route')
        calls, secs = dict(L.unpack_calls), dict(L.unpack_seconds)
        pics, nums, t_first, t_rest, st = decode(
            loader=L.loader_for_path(path))
        n_unpack = {k: L.unpack_calls[k] - calls[k] for k in calls}
        t_unpack = L.unpack_seconds[route] - secs[route]
        n, ns = len(pics), cap.shape[0]
        print(f'{route} unpack: {n_unpack[route]} call(s), {t_unpack:.4f} s '
              f'for {ns} samples ({ns / t_unpack / 1e6:.2f} MSa/s); decoded '
              f'{n} frames in {t_first + t_rest:.3f} s: '
              f'{n * spf / (t_first + t_rest) / 1e6:.2f} MSa/s with the load '
              f'(first frame {t_first:.3f} s), '
              f'{(n - 1) * spf / t_rest / 1e6:.2f} MSa/s after it; '
              f'prefetcher t_unpack {st["t_unpack"]:.4f} s, t_fetch '
              f'{st["t_fetch"]:.4f} s, batches {st["batches"]}')
        if n_unpack[route] == 0 or sum(n_unpack.values()) != n_unpack[route]:
            fail(f'unpack calls by route {n_unpack}: the {route} route '
                 f'was not the one taken')
        out[route] = (pics, nums)
    L.set_native(True)
    again = decode(capture=cap)
    n = len(again[0])
    print(f'resident decode: {n} frames in {again[2] + again[3]:.3f} s, '
          f'{n * spf / (again[2] + again[3]) / 1e6:.2f} MSa/s (first frame '
          f'{again[2]:.3f} s), {(n - 1) * spf / again[3] / 1e6:.2f} MSa/s '
          f'after it')
    for route, (pics, nums) in out.items():
        if nums != resident[1] or len(pics) < p['least'] or any(
                not np.array_equal(a, b) for a, b in zip(pics, resident[0])):
            fail(f'the {route}-unpack segmented .tbc differs from the '
                 f'resident decode\'s (CAV {nums[:3]}.. vs '
                 f'{resident[1][:3]}..)')
    print(f'.tbc bytes of both routes equal to the resident decode\'s '
          f'({len(resident[0])} frames, CAV {resident[1][0]}..'
          f'{resident[1][-1]})')


# phase 22: one rank a process, each world on the backend
# mesh.default_backend picks for it on one card (1 rank: NCCL; 2 ranks
# share the card: gloo).  World 1 is also where the single-rank
# references run.
MESH_WORLDS = (1, 2)
MESH_TIMEOUT_S = 300
MESH_REPS = 3
MESH_PIPELINES = {
    'NTSC': dict(nblocks=52, batch=16, start=33046, frames=12, k1=1,
                 k1_window=2),
    'PAL': dict(nblocks=56, batch=16, start=PAL_START, frames=12, k1=1,
                k1_window=0),
}
MESH_DEMOD_NBLOCKS, MESH_DEMOD_FIELDS = 52, 2
MESH_COMB_FRAMES = 16
# the CPU test's NN run (tests/torch_mesh_worker.py), and JAX's tolerances;
# its parameters are compared after Adam's first step, lr * sign(g), so
# only where no gradient component lies within rounding of zero, which
# holds at this size.  One more step at the trainer's default width
# compares the loss and the dp-averaged gradients (no sign step).
MESH_NN = dict(steps=3, batch=4, h=16, w=64, features=(8, 8), seed=5,
               lr=3e-3)
MESH_NN_FULL = dict(batch=8, h=64, w=256, features=(24, 24), seed=5,
                    lr=3e-3)
NN_LOSS_RTOL, NN_PARAM_ATOL = 1e-4, 1e-5
NN_GRAD_RTOL = 1e-4    # of each gradient tensor's largest component
DEMOD_TOL = 1e-3       # of the tap's peak-to-peak (the port's demod budget)


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


def _comb_frames(np):
    """Smooth-ish frames with a moving feature and burst levels that vary
    from frame to frame, so the AGC carry matters."""
    rng = np.random.default_rng(4)
    base = rng.integers(12000, 40000, (525, 910)).astype(np.uint16)
    frames = np.stack([base] * MESH_COMB_FRAMES).astype(np.int32)
    for k in range(MESH_COMB_FRAMES):
        frames[k, 100:200, 100 + 8 * k:200 + 8 * k] += 4000
    frames[:, :, 1] = ((6 + 10 * (np.arange(MESH_COMB_FRAMES)[:, None] % 4))
                       * 358.4).astype(np.int32)
    return frames


def _nn_first_step(torch, NC, dev, mesh, size):
    """The gradients (dp-averaged with a mesh) and the loss of one train
    step at `size` from the seeded weights and batch."""
    gen = torch.Generator(device=dev).manual_seed(size['seed'])
    model = NC.NNComb(size['features']).to(dev)
    model.reset_parameters(gen)
    opt = NC.make_optimizer(model, size['lr'])
    inp, clp_t, *_ = NC.synth_batch(gen, size['batch'], size['h'],
                                    size['w'])
    loss = NC.train_step(model, opt, inp, clp_t, mesh)
    return ({k: p.grad.cpu().numpy() for k, p in model.named_parameters()},
            float(loss))


def mesh_rank(argv):
    """One rank of phase 22: python3 chip_smoke.py --mesh-rank RANK WORLD
    PORT BACKEND DIR.  Writes DIR/rank<RANK>.npz and prints one
    MESH_RESULT line."""
    import datetime
    import numpy as np
    import torch
    import torch.distributed as dist
    rank, world, port, backend, d = (int(argv[0]), int(argv[1]),
                                     int(argv[2]), argv[3], argv[4])
    sys.path.insert(0, ROOT)
    from ld_decode_tpu_torch.comb import comb_ntsc as CN
    from ld_decode_tpu_torch.models import nn_comb as NC
    from ld_decode_tpu_torch.ops import demod as D
    from ld_decode_tpu_torch.ops import filters as F
    from ld_decode_tpu_torch.parallel import mesh as M
    from ld_decode_tpu_torch.tbc import cuda_resample as CR
    from ld_decode_tpu_torch.tbc import fused as FU
    from ld_decode_tpu_torch.tbc import sync as S
    from ld_decode_tpu_torch.utils.graphs import as_cache
    from ld_decode_tpu_torch.utils.params import DecoderConfig
    torch.cuda.set_device(0)
    dist.init_process_group(backend, init_method=f'tcp://127.0.0.1:{port}',
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=120))
    with open(os.path.join(d, 'spec.json')) as f:
        spec = json.load(f)
    mesh = M.make_mesh(device='cuda')
    dev = mesh.device
    info = dict(rank=rank, world=world, backend=mesh.backend,
                device=str(dev), staged=mesh.staged, dp=mesh.dp, sp=mesh.sp)
    res = {}

    def timed(fn, *args, reps=MESH_REPS):
        """fn(*args) `reps` times (warmed up by the caller); its last
        result and the wall ms a call."""
        torch.cuda.synchronize()
        dist.barrier()
        t0 = time.perf_counter()
        for _ in range(reps):
            r = fn(*args)
        torch.cuda.synchronize()
        return r, (time.perf_counter() - t0) / reps * 1e3

    graphed = world == 1         # NCCL: the sharded calls capture

    def both_ways(name, build, call, n=3):
        """build(graphs) -> fn: with the default route's cache (a CUDA
        graph a rank on NCCL, eager on the host-staged gloo mesh) and, in
        the 1-rank world, eagerly too; each called with call(fn, k) for k
        in range(n) (a warm-up, a capture, replays), on inputs that change
        with k, the last the reference's; the last outputs must match bit
        for bit, and each earlier call's differ from them.  Returns the
        default's last outputs on the host."""
        cache = as_cache(None, mesh.device, mesh.staged)
        fn = build(cache)
        info[f'{name}_graphs'] = cache.mode
        outs = [[x.cpu().numpy() for x in _leaves(call(fn, k))]
                for k in range(n)]
        got = outs[-1]
        info[f'{name}_varied'] = all(
            any(not np.array_equal(a, b) for a, b in zip(o, got))
            for o in outs[:-1])
        if cache.mode == 'graph':
            info[f'{name}_counts'] = dict(cache.counts)
            fe = build(False)
            want = [[x.cpu().numpy() for x in _leaves(call(fe, k))]
                    for k in range(n)][-1]
            info[f'{name}_equal_eager'] = len(got) == len(want) and all(
                np.array_equal(a, b) for a, b in zip(got, want))
        return got

    for system, p in spec['pipeline'].items():
        cfg = DecoderConfig(system=system, freq_mhz=40.0)
        bank = F.make_demod_bank(cfg, np.complex64, device=dev)
        n_audio1 = p['nblocks'] * bank.a_stage1_keep if bank.has_audio else 0
        cap = torch.from_numpy(np.load(os.path.join(
            d, f'cap_{system}.npy')).astype(np.float32)).to(dev)
        args = (cap, p['start'], 0.0, 1.0)
        # the warm-up and the capture on other start0, audio_offset0,
        # mtf_level and valid_len (the first clamps the last fields'
        # windows); the timed calls on args
        n_stream = D.stream_len(cfg, p['nblocks'])
        s0, pitch = p['start'], p['pitch']
        others = ((cap, s0 + pitch // 2, 0.0, 0.8, s0 + pitch + n_stream),
                  (cap, s0 - pitch // 3, 0.5, 0.9, cap.shape[0] - 1))
        runs = {}
        for graphs in ((None, False) if graphed else (None,)):
            cache = as_cache(graphs, mesh.device, mesh.staged)
            fn = M.build_pipeline_batch_sharded(
                cfg, bank, mesh, p['nblocks'], n_audio1, p['batch'],
                p['pitch'], graphs=cache)
            warm = [[x.cpu().numpy() for x in _leaves(fn(*a))]
                    for a in others]
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            CR.resample_lines_batch.launches = 0
            CR.resample_lines_batch.window_launches = 0
            (out, ns, no), ms = timed(fn, *args)
            window = CR.resample_lines_batch.window_launches
            last = [x.cpu().numpy() for x in _leaves((out, ns, no))]
            runs[graphs] = dict(
                varied=all(any(not np.array_equal(a, b)
                               for a, b in zip(w, last)) for w in warm),
                ms=ms, k1=CR.resample_lines_batch.launches - window,
                k1_window=window, next=[int(ns), float(no)],
                peak_mib=torch.cuda.max_memory_allocated() / 2**20,
                mode=cache.mode, counts=dict(cache.counts),
                capture_s=list(cache.capture_seconds.values()),
                out={k: v.cpu().numpy() for k, v in out.items()})
        info[system] = {k: v for k, v in runs[None].items() if k != 'out'}
        res.update({f'{system}_{k}': v for k, v in runs[None]['out'].items()})
        if graphed:
            e = runs[False]
            info[system]['eager'] = dict(
                ms=e['ms'], k1=e['k1'], k1_window=e['k1_window'],
                next=e['next'], peak_mib=e['peak_mib'],
                equal=all(np.array_equal(v, e['out'][k])
                          for k, v in runs[None]['out'].items()))
        del runs
        if world == 1:
            single = (cap, p['start'], 0.0, 1.0, bank, cfg, p['nblocks'],
                      n_audio1, p['batch'], p['pitch'])
            FU.field_pipeline_batch(*single)
            (ref, rns, rno), info[system]['single_ms'] = timed(
                FU.field_pipeline_batch, *single)
            info[system]['single_next'] = [int(rns), float(rno)]
            res.update({f'{system}_ref_{k}': v.cpu().numpy()
                        for k, v in ref.items()})
        del cap, out

    # sharded demod at the production blocklen, dp 1 x sp (world)
    dmesh = M.make_mesh(dp=1, device='cuda')
    cfg = DecoderConfig(system='NTSC', freq_mhz=40.0)
    bank = F.make_demod_bank(cfg, np.complex64, device=dev)
    streams = torch.from_numpy(np.load(os.path.join(d, 'streams.npy'))).to(dev)
    nb, keep = MESH_DEMOD_NBLOCKS, cfg.block_keep
    cols = nb // dmesh.sp * keep
    lo = dmesh.sp_index * cols
    body = streams[:, lo:lo + cols].contiguous()
    demod, pidx, _pval = (torch.from_numpy(x).to(dev) for x in both_ways(
        'demod', lambda g: M.build_sharded_demod(
            cfg, bank, dmesh, nb, streams.shape[0], graphs=g),
        lambda fn, k: fn(body if k == 2 else body.roll(k + 1, dims=1),
                         (0.8, 0.9, 1.0)[k])))
    video, _ = D.demod_blocks(streams, bank, cfg, nb, 1.0)
    ref = video['demod'][:, lo:lo + cols]
    n = cols - (keep if dmesh.sp_index == dmesh.sp - 1 else 0)
    window = max(int(cfg.linelen * 0.4), 2)
    ridx, _ = S.find_sync_peaks(video['demod_sync'], window)
    lim = (nb - 1) * keep - window
    sets = [[set(int(i) for i in row if 0 <= i < lim) for row in x.cpu()]
            for x in (pidx, ridx)]
    info['demod'] = dict(
        rel_err=float((demod[:, :n] - ref[:, :n]).abs().max()
                      / (ref.max() - ref.min())),
        peaks=sum(len(s) for s in sets[1]),
        peak_mismatch=sum(len(a ^ b) for a, b in zip(*sets)))

    # the 3D comb over 16 frames, sharded over the flat axis
    frames = torch.from_numpy(np.load(os.path.join(d, 'frames.npy'))).to(dev)
    ccfg = CN.CombConfig(dim=3, opticalflow=False)
    f_l = MESH_COMB_FRAMES // mesh.size
    mine = frames[rank * f_l:(rank + 1) * f_l]
    rgb, = both_ways('comb', lambda g: M.build_sharded_comb3d(
        ccfg, mesh, MESH_COMB_FRAMES, graphs=g),
        lambda fn, k: fn(mine.roll(2 - k, dims=2)))
    res['comb'] = rgb.astype(np.uint16)
    for graphs in ((None, False) if graphed else (None,)):
        comb = M.build_sharded_comb3d(ccfg, mesh, MESH_COMB_FRAMES,
                                      graphs=graphs)
        for _ in range(2):
            comb(mine)
        _, info['comb_ms' if graphs is None else 'comb_eager_ms'] = timed(
            comb, mine)
    if world == 1:
        ab, seq = -1.0, []
        for k in range(MESH_COMB_FRAMES):
            o, ab, _ = CN.comb_frame(frames[k],
                                     frames[(k + 1) % MESH_COMB_FRAMES],
                                     frames[k - 1], ab, ccfg)
            seq.append(o.cpu().numpy().astype(np.uint16))
        res['comb_ref'] = np.stack(seq)

    # three data-parallel NN train steps (world 1: mesh=None)
    nn_mesh = mesh if world > 1 else None
    for tag, size in (('', MESH_NN), ('full_', MESH_NN_FULL)):
        grads, info[f'{tag}step_loss'] = _nn_first_step(torch, NC, dev,
                                                        nn_mesh, size)
        res.update({f'{tag}grad_{k}': g for k, g in grads.items()})
    model, loss = NC.train_nn_comb(
        torch.Generator(device=dev).manual_seed(MESH_NN['seed']),
        steps=MESH_NN['steps'], batch=MESH_NN['batch'], h=MESH_NN['h'],
        w=MESH_NN['w'], lr=MESH_NN['lr'], features=MESH_NN['features'],
        device=dev, mesh=nn_mesh)
    res.update({f'nn_{k}': v.cpu().numpy()
                for k, v in model.state_dict().items()})
    info['nn_loss'] = loss
    # the data-parallel trainer's route (train_nn_comb: as_cache's rule)
    info['nn_graphs'] = (as_cache(None, dev, nn_mesh.staged).mode
                         if nn_mesh else 'graph')

    np.savez(os.path.join(d, f'rank{rank}.npz'), **res)
    dist.barrier()
    dist.destroy_process_group()
    print('MESH_RESULT ' + json.dumps(info), flush=True)


def _leaves(x) -> list:
    """The tensors of a sharded call's result (a tensor, a tuple, a dict
    of tensors), in order."""
    if isinstance(x, dict):
        return [v for k in sorted(x) for v in _leaves(x[k])]
    if isinstance(x, (tuple, list)):
        return [v for y in x for v in _leaves(y)]
    return [x]


def _run_world(np, world: int, backend: str, d: str):
    """Start the ranks of one world; wait for all of them.  A rank that
    fails or outlives MESH_TIMEOUT_S fails the phase (the rest are
    killed)."""
    port = _free_port()
    procs = []
    for r in range(world):
        log = open(os.path.join(d, f'rank{r}.log'), 'w')
        procs.append((subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), '--mesh-rank',
             str(r), str(world), str(port), backend, d],
            stdout=log, stderr=subprocess.STDOUT, cwd=ROOT), log))
    deadline = time.perf_counter() + MESH_TIMEOUT_S
    for p, _ in procs:
        try:
            p.wait(timeout=max(deadline - time.perf_counter(), 1))
        except subprocess.TimeoutExpired:
            break
    infos, bad = [], []
    for r, (p, log) in enumerate(procs):
        if p.poll() is None:
            p.kill()
            p.wait()
        log.close()
        with open(os.path.join(d, f'rank{r}.log')) as f:
            text = f.read()
        lines = [l for l in text.splitlines() if l.startswith('MESH_RESULT ')]
        if p.returncode != 0 or not lines:
            bad.append(f'rank {r} of {world} ({backend}) rc {p.returncode}:'
                       f'\n{text[-3000:]}')
        else:
            infos.append(json.loads(lines[-1][len('MESH_RESULT '):]))
    if bad:
        fail('\n'.join(bad))
    return infos, [dict(np.load(os.path.join(d, f'rank{r}.npz')))
                   for r in range(world)]


def _equal_but_audio(np, got, want, what: str):
    """Bit for bit, except the audio: JAX's allowance, values may move by
    1 LSB on at most AUDIO_TICKS of them.  (A field's stage-2 audio does
    not depend on the number of fields in the call: audio/stage2.py keeps
    cuFFT's irfft to calls of at most IRFFT_ROWS rows.)"""
    bad = []
    for k, w in want.items():
        g = got[k]
        if g.shape != w.shape:
            bad.append(f'{k} shape {g.shape} vs {w.shape}')
            continue
        dd = np.abs(g.astype(np.float64) - w.astype(np.float64))
        if k == 'audio':
            ticks = int((dd != 0).sum())
            print(f'{what}: audio differs by up to {dd.max():.0f} LSB on '
                  f'{ticks} of {dd.size} values (budget 1 LSB on '
                  f'{AUDIO_TICKS})')
            if dd.max() > 1 or ticks > AUDIO_TICKS:
                bad.append('audio')
        elif not np.array_equal(g, w):
            bad.append(f'{k} (max|d| {dd.max():.3g} on {int((dd != 0).sum())}'
                       f' of {dd.size})')
    if bad:
        fail(f'{what}: ' + '; '.join(bad))


def mesh_phase(torch, np, cfg, cap, pcfg, pcap, d: str):
    """The sharded decode over torch.distributed: worlds of 1 rank (NCCL)
    and 2 ranks (gloo, host-staged collectives) on the one card, each rank
    a subprocess; the sharded NTSC and PAL batch pipelines at full width
    against the single-rank batch, the sharded demod at the production
    blocklen, the sharded 3D comb, three data-parallel NN steps."""
    phase('22 mesh: the sharded decode over torch.distributed')
    from ld_decode_tpu_torch.ops import filters as F
    from ld_decode_tpu_torch.parallel.mesh import default_backend
    from ld_decode_tpu_torch.tbc import framer as FR
    spec = {'pipeline': {}}
    for system, c, cf in (('NTSC', cap, cfg), ('PAL', pcap, pcfg)):
        p = MESH_PIPELINES[system]
        fr = FR.Framer(cf, F.make_demod_bank(cf, np.complex64,
                                             device='cuda'),
                       capture=c, batch=1, nblocks=p['nblocks'],
                       device='cuda')
        f0, rs0, _ = fr.readfield(None, p['start'])
        np.save(os.path.join(d, f'cap_{system}.npy'),
                c[:int(p['frames'] * cf.freq_hz / cf.sys.fps)])
        spec['pipeline'][system] = dict(
            nblocks=p['nblocks'], batch=p['batch'],
            start=int(f0.readsample if f0.readsample >= 0 else rs0),
            pitch=int(round(cf.freq_hz / cf.sys.fps / 2)))
    total = MESH_DEMOD_NBLOCKS * cfg.block_keep + cfg.blocklen \
        - cfg.block_keep
    np.save(os.path.join(d, 'streams.npy'), np.stack([
        cap[33046 + f * 700000:33046 + f * 700000 + total]
        for f in range(MESH_DEMOD_FIELDS)]).astype(np.float32))
    np.save(os.path.join(d, 'frames.npy'), _comb_frames(np))
    with open(os.path.join(d, 'spec.json'), 'w') as f:
        json.dump(spec, f)

    worlds = {}
    for world in MESH_WORLDS:
        backend = default_backend(world)
        t0 = time.perf_counter()
        worlds[world] = _run_world(np, world, backend, d)
        print(f'world {world} ({backend}): {time.perf_counter() - t0:.1f} s, '
              f'ranks on ' + ', '.join(
                  f'{i["device"]} ({i["backend"]}, dp {i["dp"]} sp {i["sp"]}'
                  f'{", host-staged" if i["staged"] else ""})'
                  for i in worlds[world][0]))
    (one,), (ref,) = worlds[1]
    infos2, ranks2 = worlds[2]

    launches = {}
    for system, p in MESH_PIPELINES.items():
        keys = [k[len(system) + 5:] for k in ref
                if k.startswith(system + '_ref_')]
        want = {k: ref[f'{system}_ref_{k}'] for k in keys}
        _equal_but_audio(np, {k: ref[f'{system}_{k}'] for k in keys}, want,
                         f'{system} 1-rank sharded vs single-rank batch')
        got = {k: np.concatenate([r[f'{system}_{k}'] for r in ranks2])
               for k in keys}
        _equal_but_audio(np, got, want,
                         f'{system} 2-rank sharded vs single-rank batch')
        if not want['meta_i'][:, 0].all():
            fail(f'{system}: fields not valid {want["meta_i"][:, 0]}')
        single = one[system]['single_next']
        for i in [one] + infos2:
            if i[system]['next'] != single:
                fail(f'{system} rank {i["rank"]} of {i["world"]}: chained '
                     f'scalars {i[system]["next"]} vs {single}')
        expect = (p['k1'] * MESH_REPS, p['k1_window'] * MESH_REPS)
        for i in [one] + infos2:
            got = (i[system]['k1'], i[system]['k1_window'])
            if got != expect:
                fail(f'{system} rank {i["rank"]} of {i["world"]}: K1 '
                     f'launched {got} times (picture, burst window), '
                     f'expected {expect}')
        launches[system] = {w: sum(i[system]['k1'] for i in infos)
                            for w, (infos, _) in worlds.items()}
        if p['k1_window']:
            launches[system + ' burst window'] = {
                w: sum(i[system]['k1_window'] for i in infos)
                for w, (infos, _) in worlds.items()}
        print(f'{system} batch {p["batch"]} (nblocks {p["nblocks"]}), one '
              f'call: single-rank field_pipeline_batch '
              f'{one[system]["single_ms"]:.2f} ms; sharded, 1 rank '
              f'({one["backend"]}) {one[system]["ms"]:.2f} ms; sharded, 2 '
              f'ranks on the one card ({infos2[0]["backend"]}), per rank: '
              + ', '.join(f'{i[system]["ms"]:.2f} ms' for i in infos2)
              + ' (one-card overhead, not scaling); peak device memory '
              f'per rank {one[system]["peak_mib"]:.1f} MiB (1 rank), '
              + ', '.join(f'{i[system]["peak_mib"]:.1f}' for i in infos2)
              + ' MiB (2 ranks); K1 launches in ' f'{MESH_REPS} calls '
              '(picture + burst window): '
              + ', '.join(f'rank {i["rank"]} of {i["world"]} '
                          f'{i[system]["k1"]} + {i[system]["k1_window"]}'
                          for i in [one] + infos2)
              + '; outputs equal to the single-rank batch (audio within '
              'JAX\'s allowance), chained scalars exact')

    # the compile boundary: the 1-rank NCCL world's calls replay CUDA
    # graphs (no collective runs in a world of one rank), the 2-rank gloo
    # world's run eagerly (host-staged)
    for system in MESH_PIPELINES:
        g, e = one[system], one[system]['eager']
        same = e['equal'] and e['next'] == g['next']
        print(f'{system} sharded call, 1 rank ({one["backend"]}), graphs '
              f'{g["mode"]} vs eager: outputs and chained scalars '
              f'{"bit-equal" if same else "DIFFER"} (warm-up and capture '
              f'on other start0, offset, mtf_level, valid_len: outputs '
              f'differ from the replay\'s {g["varied"]}); '
              f'K1 {g["k1"]} + {g["k1_window"]} vs {e["k1"]} + '
              f'{e["k1_window"]}; host ms a call {g["ms"]:.3f} vs '
              f'{e["ms"]:.3f}; capture {g["capture_s"]} s, cache '
              f'{g["counts"]}; peak {g["peak_mib"]:.1f} vs '
              f'{e["peak_mib"]:.1f} MiB')
        if g['mode'] != 'graph' or not same or not g['varied'] \
                or (e['k1'], e['k1_window']) != (g['k1'], g['k1_window']):
            fail(f'{system}: the graphed sharded call differs from eager')
    for name in ('demod', 'comb'):
        print(f'sharded {name}, 1 rank: graphs {one[name + "_graphs"]}, '
              f'equal to eager {one.get(name + "_equal_eager")} (earlier '
              f'calls on other inputs differ {one[name + "_varied"]}), '
              f'cache {one.get(name + "_counts")}')
        if one[name + '_graphs'] != 'graph' or not one[name + '_varied'] \
                or not one.get(name + '_equal_eager'):
            fail(f'sharded {name}: the graphed call differs from eager')
    modes = {(i['rank'], k): v for i in infos2 for k, v in i.items()
             if k.endswith('_graphs')}
    modes.update({(i['rank'], s_): i[s_]['mode'] for i in infos2
                  for s_ in MESH_PIPELINES})
    print(f'2 ranks ({infos2[0]["backend"]}, host-staged): every sharded '
          f'call ran eagerly: {sorted(set(modes.values()))}')
    if set(modes.values()) != {'eager'}:
        fail(f'the host-staged world captured: {modes}')

    for i in [one] + infos2:
        dm = i['demod']
        print(f'demod rank {i["rank"]} of {i["world"]} (dp 1 x sp '
              f'{i["world"]}, blocklen {cfg.blocklen}): max|d| '
              f'{dm["rel_err"]:.2e} of the tap\'s peak-to-peak against the '
              f'unsharded demod; {dm["peaks"]} sync peaks, '
              f'{dm["peak_mismatch"]} differ')
        if dm['rel_err'] > DEMOD_TOL or dm['peak_mismatch'] or not dm['peaks']:
            fail('sharded demod outside its budget')

    comb = np.concatenate([r['comb'] for r in ranks2])
    if not np.array_equal(comb, ref['comb_ref']) \
            or not np.array_equal(ref['comb'], ref['comb_ref']):
        fail('the sharded 3D comb differs from the sequential comb_frame '
             'chain')
    print(f'comb3d: {MESH_COMB_FRAMES} frames of 525 x 910 equal to the '
          f'sequential chain; {one["comb_ms"]:.1f} ms graphed, '
          f'{one["comb_eager_ms"]:.1f} ms eager (1 rank), '
          + ', '.join(f'{i["comb_ms"]:.1f}' for i in infos2)
          + ' ms per rank (2 ranks, eager)')

    gkeys = [k for k in ref if k.startswith('grad_')]
    gnoise = dparam = 0.0
    for r in ranks2:
        for k in gkeys:
            noise = float(np.abs(r[k] - ref[k]).max())
            gnoise = max(gnoise, noise)
            if float(np.abs(ref[k]).min()) <= 10 * noise:
                fail(f'NN {k}: a first-step gradient component lies within '
                     f'10x the runs\' difference ({noise:.2e}) of zero')
        for k in [k for k in ref if k.startswith('nn_')]:
            dparam = max(dparam, float(np.abs(r[k] - ref[k]).max()))
    dloss = max(abs(i['nn_loss'] - one['nn_loss']) / abs(one['nn_loss'])
                for i in infos2)
    print(f'NN: {MESH_NN["steps"]} data-parallel steps (dp 2) vs mesh=None: '
          f'loss {one["nn_loss"]:.6f}, relative difference {dloss:.2e}; '
          f'first-step gradients max|d| {gnoise:.2e}; parameters max|d| '
          f'{dparam:.2e} (budget {NN_PARAM_ATOL})')
    if dparam > NN_PARAM_ATOL:
        fail('NN data-parallel parameters differ')
    if dloss > NN_LOSS_RTOL:
        fail('NN data-parallel loss differs')

    fkeys = [k for k in ref if k.startswith('full_grad_')]
    grel = max(float(np.abs(r[k] - ref[k]).max() / np.abs(ref[k]).max())
               for r in ranks2 for k in fkeys)
    floss = max(abs(i['full_step_loss'] - one['full_step_loss'])
                / abs(one['full_step_loss']) for i in infos2)
    print(f'NN at the trainer\'s default width (features '
          f'{MESH_NN_FULL["features"]}, batch {MESH_NN_FULL["batch"]}, '
          f'{MESH_NN_FULL["h"]} x {MESH_NN_FULL["w"]}), one data-parallel '
          f'step (dp 2) vs mesh=None: loss {one["full_step_loss"]:.6f}, '
          f'relative difference {floss:.2e} (budget {NN_LOSS_RTOL}); '
          f'dp-averaged gradients max|d| {grel:.2e} of each tensor\'s '
          f'largest component (budget {NN_GRAD_RTOL})')
    if floss > NN_LOSS_RTOL or grel > NN_GRAD_RTOL:
        fail('NN data-parallel step at the default width differs')
    return launches


# the device time of a call: the median of EVENT_REPS calls timed by CUDA
# events, after one warm-up call
EVENT_REPS = 5


def _event_median_ms(torch, fn, reps: int = EVENT_REPS) -> float:
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


# phase 24: the legacy PAL comb, card vs CPU: the CPU test's budget against
# JAX (tests/test_torch_comb_pal_legacy.py)
LEGACY_MAX, LEGACY_P999 = 2, 1


def _legacy_pal_frame(np, seed: int):
    """A 1052x610 legacy PAL rawbuffer with a swinging burst and colour
    bars (the generator of tests/test_comb_pal_legacy.py::synth_frame)."""
    from ld_decode_tpu_torch.comb.comb_pal_legacy import IRESCALE, L_X, L_Y
    rng = np.random.default_rng(seed)
    h = np.arange(L_X, dtype=np.float64)[None, :]
    l = np.arange(L_Y, dtype=np.float64)[:, None]
    li = np.arange(L_Y)[:, None]
    s = np.where((li % 4 == 1) | (li % 4 == 2), 1.0, -1.0)
    theta = np.pi / 2 * h + np.radians(45.0) * l
    burst = (10.0 * IRESCALE / np.sqrt(2)) * (-np.cos(theta)
                                              + s * np.sin(theta))
    bars = [(80, 0, 0), (50, 15, 0), (50, 0, 15), (50, -12, 8),
            (45, 0, 0), (50, 10, -12), (20, 0, 0)]
    y, u, v = (np.zeros((L_Y, L_X)) for _ in range(3))
    bw = (1040 - 70) / len(bars)
    for k, (yy, uu, vv) in enumerate(bars):
        m = (h >= 70 + k * bw) & (h < 70 + (k + 1) * bw)
        y += np.where(m, yy, 0.0)
        u += np.where(m, uu, 0.0)
        v += np.where(m, vv, 0.0)
    sig = (np.clip((y + 43.122874) * IRESCALE, 1, 65535)
           + np.where((h >= 16) & (h < 60), burst, 0.0)
           + IRESCALE * (u * np.cos(theta) + s * v * np.sin(theta))
           + rng.normal(0, 6.0, (L_Y, L_X)))
    frame = np.clip(sig, 1, 65535).astype(np.uint16)
    frame[:24] = 0
    frame[:, :4] = 1000
    return frame


def legacy_comb_phase(torch, np):
    phase('24 legacy PAL comb: card vs cpu')
    from ld_decode_tpu_torch.comb import comb_pal_legacy as LG
    frames = [_legacy_pal_frame(np, seed) for seed in (0, 1)]
    res = {}
    for dim in (1, 2, 3):
        outs = {}
        for dev in ('cuda', 'cpu'):
            comb = LG.LegacyPALComb(LG.LegacyPALConfig(dim=dim), device=dev,
                                    graphs=False)
            outs[dev] = [comb.process(f) for f in frames]
        for k, (a, b) in enumerate(zip(outs['cuda'], outs['cpu'])):
            d = np.abs(a.astype(np.int64) - b)
            p999 = float(np.percentile(d, 99.9))
            print(f'dim {dim} frame {k}: max {int(d.max())} p99.9 {p999} '
                  f'LSB, {float((d > 0).mean()):.5f} of values differ')
            if d.max() > LEGACY_MAX or p999 > LEGACY_P999 \
                    or a.shape != (576, 974, 3):
                fail(f'legacy PAL comb card vs cpu outside the budget (max '
                     f'{LEGACY_MAX}, p99.9 {LEGACY_P999} LSB)')
        if dim == 3 and (outs['cuda'][0].max() or not outs['cuda'][1].max()):
            fail('legacy PAL comb dim 3: the primer frame is not black')
        raw = torch.from_numpy(frames[0].astype(np.int32)).cuda()
        cfg = LG.LegacyPALConfig(dim=dim)
        res[dim] = _event_median_ms(
            torch, lambda: LG.comb_pal_legacy_frame(raw, cfg, graphs=False))
        print(f'dim {dim}: {res[dim]:.4f} ms a frame on the card (CUDA '
              f'events, median of {EVENT_REPS})')
    return res


# phase 25: the compile boundary, graphs vs eager in one call (eager
# first).  GRAPH_BATCHES chained batch calls a system through a GraphCache;
# the decode paths' frames (NTSC 40, PAL 32), timed whole and after the
# first frame (whose refill holds the graph's warm-up and capture); the
# chain over GRAPH_CHAIN_FRAMES frames of phase 4's capture played twice
# (windows of 8: M = 7, then 9), timed whole and, in steady state, over
# the frames pushed from GRAPH_CHAIN_STEADY on (the comb's graph is
# captured in the third window)
GRAPH_BATCHES, GRAPH_CHAIN_FRAMES, GRAPH_CHAIN_STEADY = 6, 72, 32


def _launch_profile(torch, fn) -> dict:
    """fn() once under torch.profiler: the device operations it ran and
    the host's launch calls (kernel launches and graph launches)."""
    from torch.autograd import DeviceType
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    ev = prof.key_averages()
    return dict(
        device_ops=sum(e.count for e in ev
                       if e.device_type == DeviceType.CUDA),
        kernel_launch_calls=sum(e.count for e in ev
                                if e.device_type == DeviceType.CPU
                                and 'LaunchKernel' in e.key),
        graph_launch_calls=sum(e.count for e in ev
                               if e.device_type == DeviceType.CPU
                               and 'GraphLaunch' in e.key))


def _graph_batches(torch, np, FU, G, cfg, bank, cap_t, start, nblk, mode):
    """GRAPH_BATCHES chained batch calls of 16 fields through a GraphCache
    (mode None: graphs; 'eager'), each batch's outputs and chained
    scalars copied to the host; then one more call profiled, and the
    host time of 3 more calls (no synchronisation inside)."""
    cache = G.GraphCache('cuda', mode)
    n_audio1 = nblk * bank.a_stage1_keep
    pitch = int(round(cfg.freq_hz / cfg.sys.fps / 2))

    def fn(s, o, m):
        return FU.field_pipeline_batch(cap_t, s, o, m, bank, cfg, nblk,
                                       n_audio1, 16, pitch)

    state = [torch.full((), start, dtype=torch.int32, device='cuda'),
             torch.zeros((), device='cuda'), torch.ones((), device='cuda')]
    outs = []

    def step():
        out, state[0], state[1] = cache('batch', fn, state, reads=(cap_t,))
        return out

    for _ in range(GRAPH_BATCHES):
        host = {k: v.cpu().numpy() for k, v in step().items()}
        host['chain'] = np.array([float(state[0]), float(state[1])])
        outs.append(host)
    prof = _launch_profile(torch, step)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        step()
    prof['host_ms'] = (time.perf_counter() - t0) / 3 * 1e3
    torch.cuda.synchronize()
    return outs, prof, cache


def _graph_decode(torch, np, FR, CR, cfg, bank, cap, p, graphs):
    """The decode path's frames through Framer(batch 16, graphs=...):
    frames, audio and each field's line locations, burst levels and VBI,
    K1 launches, the rate and t_dispatch a batch over the whole run and
    after the first frame, peak device memory, the cache's counts."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    CR.resample_lines_batch.launches = 0
    fr = FR.Framer(cfg, bank, capture=cap, batch=16, nblocks=p['nblocks'],
                   device='cuda', graphs=graphs)
    st = fr.prefetcher.stats
    frames, audio, fields = [], [], []
    sample = p['start']
    t0 = time.perf_counter()
    for i in range(p['want']):
        rv = fr.readframe(None, sample, i == 0)
        if rv[0] is None:
            fail(f'{cfg.system} decode (graphs={graphs}) ended at frame {i}')
        if i == 0:
            t1, st1 = time.perf_counter(), dict(st)
        frames.append(rv[0])
        audio.append(rv[1])
        fields += [(f.readsample, f.linelocs, f.burstlevel, f.vbi)
                   for f in rv[3]]
        sample = rv[2]
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    spf = cfg.freq_hz / cfg.sys.fps
    return dict(frames=frames, audio=audio, fields=fields,
                k1=CR.resample_lines_batch.launches,
                msas=p['want'] * spf / (t2 - t0) / 1e6,
                steady=(p['want'] - 1) * spf / (t2 - t1) / 1e6,
                dispatch_ms=st['t_dispatch'] / st['batches'] * 1e3,
                steady_dispatch_ms=(st['t_dispatch'] - st1['t_dispatch'])
                / max(st['batches'] - st1['batches'], 1) * 1e3,
                batches=st['batches'], seq_fallback=st['seq_fallback'],
                peak_mib=torch.cuda.max_memory_allocated() / 2**20,
                reserved_mib=torch.cuda.max_memory_reserved() / 2**20,
                counts=dict(fr.prefetcher.graphs.counts),
                capture_s=sum(fr.prefetcher.graphs.capture_seconds.values()))


def _graph_chain(torch, np, FR, CR, CG, CB, CombConfig, cfg, bank, cap,
                 graphs):
    """GRAPH_CHAIN_FRAMES frames through the chain (Framer chain mode and
    the NTSC flow comb in CombWindows(8, 3)), graphs on or off: the RGB
    frames and words, K1 and K2 launches, RGB frames/s over the whole run
    and frames pushed per second from GRAPH_CHAIN_STEADY on, the comb's
    t_feed a window (all windows; the steady ones), peak memory."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    CR.resample_lines_batch.launches = 0
    CG.take_along_axis.launches = 0
    fr = FR.Framer(cfg, bank, capture=cap, batch=16, nblocks=52,
                   device='cuda', fetch_picture=False, graphs=graphs)
    comb = CB.NTSCCombBatch(CombConfig(dim=3), device='cuda', graphs=graphs)
    rgbs, words = [], []
    windows = CB.CombWindows(comb, 8, 3, lambda r, w: (rgbs.append(r),
                                                       words.append(w)))
    sample = 33046
    t0 = time.perf_counter()
    for i in range(GRAPH_CHAIN_FRAMES):
        if i == GRAPH_CHAIN_STEADY:
            t1, c1 = time.perf_counter(), dict(comb.stats)
        rv = fr.readframe(None, sample, i == 0)
        if rv[0] is None:
            fail(f'chain (graphs={graphs}) ended at frame {i}')
        windows.push(rv[0].reshape(525, 910))
        sample = rv[2]
    t2, c2 = time.perf_counter(), dict(comb.stats)
    windows.drain()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    st = fr.prefetcher.stats
    return dict(rgbs=rgbs, words=words, fps=len(rgbs) / dt,
                steady_fps=(GRAPH_CHAIN_FRAMES - GRAPH_CHAIN_STEADY)
                / (t2 - t1),
                k1=CR.resample_lines_batch.launches,
                k2=CG.take_along_axis.launches,
                peak_mib=torch.cuda.max_memory_allocated() / 2**20,
                reserved_mib=torch.cuda.max_memory_reserved() / 2**20,
                decode=dict(fr.prefetcher.graphs.counts),
                comb=dict(comb.graphs.counts),
                capture_s=sum(comb.graphs.capture_seconds.values())
                + sum(fr.prefetcher.graphs.capture_seconds.values()),
                dispatch_ms=st['t_dispatch'] / st['batches'] * 1e3,
                feed_ms=comb.stats['t_feed'] / comb.stats['windows'] * 1e3,
                steady_feed_ms=(c2['t_feed'] - c1['t_feed'])
                / max(c2['windows'] - c1['windows'], 1) * 1e3)


def _same(np, what: str, a, b):
    """Fail unless a and b (arrays, or lists/tuples/dicts of them) are
    equal bit for bit."""
    if isinstance(a, dict):
        if a.keys() != b.keys():
            fail(f'{what}: keys {sorted(a)} vs {sorted(b)}')
        for k in a:
            _same(np, f'{what} {k}', a[k], b[k])
    elif isinstance(a, (list, tuple)):
        if len(a) != len(b):
            fail(f'{what}: {len(a)} vs {len(b)} items')
        for i, (x, y) in enumerate(zip(a, b)):
            _same(np, f'{what}[{i}]', x, y)
    elif a is None or isinstance(a, (int, float, str, bool)):
        if a != b:
            fail(f'{what}: {a} vs {b}')
    else:
        if hasattr(a, 'cpu'):                # a tensor, on the card too
            a, b = a.cpu(), b.cpu()
        x, y = np.asarray(a), np.asarray(b)
        if x.dtype != y.dtype or x.shape != y.shape \
                or x.tobytes() != y.tobytes():
            fail(f'{what}: graph replay differs from the eager call')


def graphs_phase(torch, np, systems):
    """systems: {name: (cfg, cap, bank)}.  Returns the numbers PERF.md
    keeps."""
    phase('25 graphs: replay vs eager')
    from ld_decode_tpu_torch.comb import batch as CB
    from ld_decode_tpu_torch.comb.comb_ntsc import CombConfig
    from ld_decode_tpu_torch.ops import cuda_gather as CG
    from ld_decode_tpu_torch.tbc import cuda_resample as CR
    from ld_decode_tpu_torch.tbc import framer as FR
    from ld_decode_tpu_torch.tbc import fused as FU
    from ld_decode_tpu_torch.utils import graphs as G
    res = {}
    for system in ('NTSC', 'PAL'):
        cfg, cap, bank = systems[system]
        p = DECODE_PATHS[system]
        label = f'{system} decode'
        # the batch call alone: every batch's outputs and chained
        # scalars, eager against replayed
        cap_t = FR.to_device_capture(cap, 'cuda')
        fr = FR.Framer(cfg, bank, capture=cap, batch=16,
                       nblocks=p['nblocks'], device='cuda', graphs=False)
        f0, rs0, _ = fr.readfield(None, p['start'])
        rs0 = int(f0.readsample if f0.readsample >= 0 else rs0)
        del fr
        be, pe, _ = _graph_batches(torch, np, FU, G, cfg, bank, cap_t,
                                   rs0, p['nblocks'], 'eager')
        bg, pg, cache = _graph_batches(torch, np, FU, G, cfg, bank,
                                       cap_t, rs0, p['nblocks'], None)
        _same(np, f'{system} batch outputs', be, bg)
        if not be[0]['meta_i'][:, 0].all():
            fail(f'{system}: the chained batches hold invalid fields')
        print(f'{system} batch call, {GRAPH_BATCHES} chained batches of '
              f'16 fields: every output and chained scalar bit-equal '
              f'(graphs {cache.counts}, capture '
              f'{sum(cache.capture_seconds.values()):.3f} s); one call '
              f'eager: {pe["device_ops"]} device ops, '
              f'{pe["kernel_launch_calls"]} kernel launch calls, '
              f'{pe["host_ms"]:.3f} ms of host time; replayed: '
              f'{pg["device_ops"]} device ops, '
              f'{pg["kernel_launch_calls"]} kernel launch calls, '
              f'{pg["graph_launch_calls"]} graph launch, '
              f'{pg["host_ms"]:.3f} ms of host time')
        if pg['graph_launch_calls'] != 1:
            fail(f'{system}: the replayed call made '
                 f'{pg["graph_launch_calls"]} graph launches')
        res[f'{system} ops'] = dict(eager=pe, graphs=pg)
        del cap_t
        e = _graph_decode(torch, np, FR, CR, cfg, bank, cap, p, False)
        g = _graph_decode(torch, np, FR, CR, cfg, bank, cap, p, True)
        _same(np, f'{label} .tbc frames', e['frames'], g['frames'])
        _same(np, f'{label} .pcm audio', e['audio'], g['audio'])
        _same(np, f'{label} fields', e['fields'], g['fields'])
        if g['counts']['replays'] < 1 or e['k1'] != g['k1']:
            fail(f'{label}: replays {g["counts"]}, K1 eager {e["k1"]} '
                 f'graphs {g["k1"]}')
        print(f'{label}, {p["want"]} frames: .tbc, .pcm and fields '
              f'bit-equal; graphs {g["counts"]}, capture '
              f'{g["capture_s"]:.3f} s; K1 {e["k1"]} both ways; '
              f'{e["batches"]} / {g["batches"]} batches; sequential '
              f'fallback fields (eager both ways) {e["seq_fallback"]} / '
              f'{g["seq_fallback"]}')
        for name, r in (('eager', e), ('graphs', g)):
            print(f'  {name:6s}: {r["msas"]:.2f} MSa/s ({r["steady"]:.2f} '
                  f'after the first frame), t_dispatch '
                  f'{r["dispatch_ms"]:.3f} ms a batch '
                  f'({r["steady_dispatch_ms"]:.3f} after the first frame), '
                  f'peak '
                  f'{r["peak_mib"]:.1f} MiB allocated, '
                  f'{r["reserved_mib"]:.1f} MiB reserved')
        res[label] = {k: {q: r[q] for q in ('msas', 'steady',
                                            'dispatch_ms',
                                            'steady_dispatch_ms',
                                            'peak_mib', 'reserved_mib',
                                            'counts', 'capture_s',
                                            'seq_fallback')}
                      for k, r in (('eager', e), ('graphs', g))}

    cfg, cap, bank = systems['NTSC']
    twice = np.concatenate([cap, cap])
    e = _graph_chain(torch, np, FR, CR, CG, CB, CombConfig, cfg, bank,
                     twice, False)
    g = _graph_chain(torch, np, FR, CR, CG, CB, CombConfig, cfg, bank,
                     twice, True)
    _same(np, 'chain RGB48 frames', e['rgbs'], g['rgbs'])
    _same(np, 'chain line-0 words', e['words'], g['words'])
    if g['comb']['replays'] < 1 or g['decode']['replays'] < 1 \
            or (e['k1'], e['k2']) != (g['k1'], g['k2']) \
            or g['k2'] != 9 * len(g['rgbs']):
        fail(f'chain: comb {g["comb"]}, decode {g["decode"]}, K1/K2 eager '
             f'{e["k1"]}/{e["k2"]} graphs {g["k1"]}/{g["k2"]}')
    print(f'NTSC chain, {GRAPH_CHAIN_FRAMES} frames -> {len(g["rgbs"])} RGB '
          f'frames: RGB48 and words bit-equal; decode graphs '
          f'{g["decode"]}, comb graphs {g["comb"]}, capture '
          f'{g["capture_s"]:.3f} s; K1 {g["k1"]}, K2 {g["k2"]} both ways')
    for name, r in (('eager', e), ('graphs', g)):
        print(f'  {name:6s}: {r["fps"]:.2f} RGB frames/s '
              f'({r["steady_fps"]:.2f} frames pushed a second from frame '
              f'{GRAPH_CHAIN_STEADY}), t_dispatch {r["dispatch_ms"]:.3f} ms '
              f'a batch, comb t_feed {r["feed_ms"]:.3f} ms a window '
              f'({r["steady_feed_ms"]:.3f} from frame {GRAPH_CHAIN_STEADY}), '
              f'peak {r["peak_mib"]:.1f} MiB allocated, '
              f'{r["reserved_mib"]:.1f} MiB reserved')
    res['NTSC chain'] = {k: {q: r[q] for q in ('fps', 'steady_fps',
                                               'dispatch_ms', 'feed_ms',
                                               'steady_feed_ms', 'peak_mib',
                                               'reserved_mib',
                                               'comb', 'decode',
                                               'capture_s')}
                         for k, r in (('eager', e), ('graphs', g))}
    return res


# phase 26: the sequential paths' graphs.  SEQ_GRAPH_FRAMES frames of each
# --batch 1 decode a run, timed whole, after the first frame (whose fields
# warm up every key) and from frame SEQ_GRAPH_STEADY on (every key of both
# line counts captured before it); STREAM_GRAPH_FRAMES frames of phase 4's
# capture through the streaming comb, timed whole and from
# STREAM_GRAPH_STEADY on (every key replayed from there); the 16-field
# field_finish_batch (eager: phase 29 holds its graphs) timed with CUDA
# events, median of FINISH_REPS
SEQ_GRAPH_FRAMES, SEQ_GRAPH_STEADY = 8, 3
STREAM_GRAPH_FRAMES, STREAM_GRAPH_STEADY = 12, 6
FINISH_BATCH, FINISH_REPS = 16, 5
# (mtf_level, audio_offset) of the values case's calls
SEQ_VALUE_CALLS = ((1.0, 0.0), (0.5, 1e-4), (0.8, 2e-5), (0.0, 7e-5),
                   (1.0, 0.0), (0.3, 4e-5), (0.9, 1e-5))


def _seq_run(torch, np, FR, CR, cfg, bank, source, p, graphs, n):
    """n frames of Framer(batch=1) over `source` (a loader's path, or the
    capture array for the resident decode), graphs on or off: frames,
    audio, every field's outputs, K1 launches, MSa/s whole and after the
    first frame, one more field's device ops and launch calls under the
    profiler and the untraced host ms of 3 more, peak memory, the cache's
    counts and capture seconds a key."""
    from ld_decode_tpu_torch.io import loaders as L
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    CR.resample_lines_batch.launches = 0
    resident = not isinstance(source, str)
    kw = dict(capture=source) if resident \
        else dict(loader=L.loader_for_path(source))
    fr = FR.Framer(cfg, bank, batch=1, nblocks=p['nblocks'], device='cuda',
                   graphs=graphs, **kw)
    fd = None if resident else open(source, 'rb')
    try:
        frames, audio, fields = [], [], []
        sample = p['start']
        t0 = time.perf_counter()
        for i in range(n):
            rv = fr.readframe(fd, sample, i == 0)
            if rv[0] is None:
                fail(f'{cfg.system} batch 1 (graphs={graphs}) ended at '
                     f'frame {i}')
            if i == 0:
                t1 = time.perf_counter()
            if i == SEQ_GRAPH_STEADY - 1:
                t_settled = time.perf_counter()
            frames.append(rv[0])
            audio.append(rv[1])
            fields += [(f.readsample, f.linelocs, f.burstlevel, f.vbi,
                        f.linecode) for f in rv[3]]
            sample = rv[2]
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        k1 = CR.resample_lines_batch.launches
        state = [sample]

        def field():
            f, _, state[0] = fr.readfield(fd, state[0])
            if f is None:
                fail(f'{cfg.system} batch 1: no field to profile')

        prof = _launch_profile(torch, field)
        t3 = time.perf_counter()
        for _ in range(3):
            field()
        prof['host_ms'] = (time.perf_counter() - t3) / 3 * 1e3
    finally:
        if fd is not None:
            fd.close()
    spf = cfg.freq_hz / cfg.sys.fps
    caps = list(fr.graphs.capture_seconds.values())
    return dict(frames=frames, audio=audio, fields=fields, k1=k1,
                msas=n * spf / (t2 - t0) / 1e6,
                steady=(n - 1) * spf / (t2 - t1) / 1e6,
                settled=(n - SEQ_GRAPH_STEADY) * spf / (t2 - t_settled) / 1e6,
                prof=prof, key_s=_key_seconds(fr.graphs),
                peak_mib=torch.cuda.max_memory_allocated() / 2**20,
                reserved_mib=torch.cuda.max_memory_reserved() / 2**20,
                counts=dict(fr.graphs.counts), keys=len(caps),
                capture_s=(min(caps), max(caps)) if caps else (0.0, 0.0))


def _stream_run(torch, np, TC, CG, cfg, frames, graphs):
    """The streaming NTSCComb over `frames`, graphs on or off: per emitted
    frame the RGB48, words and extras; K2 launches; RGB frames/s whole
    and from STREAM_GRAPH_STEADY on; one more frame's device ops and launch
    calls and the untraced host ms of the last frames; peak memory; the
    cache's counts and capture seconds a key."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    CG.take_along_axis.launches = 0
    comb = TC.NTSCComb(cfg, device='cuda', graphs=graphs)
    out = []

    def push(f):
        rgb = comb.process(f)
        if rgb is not None:
            out.append((rgb, comb.last_frame_words.copy(),
                        comb.last_debug2d, comb.last_debugline))

    t0 = time.perf_counter()
    for i, f in enumerate(frames):
        if i == STREAM_GRAPH_STEADY:
            t1, n1 = time.perf_counter(), len(out)
        push(f)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    k2, emitted = CG.take_along_axis.launches, len(out)
    prof = _launch_profile(torch, lambda: push(frames[-1]))
    t3 = time.perf_counter()
    for f in frames[-3:]:
        push(f)
    prof['host_ms'] = (time.perf_counter() - t3) / 3 * 1e3
    caps = list(comb.graphs.capture_seconds.values())
    return dict(out=out, k2=k2, emitted=emitted, key_s=_key_seconds(
                    comb.graphs),
                fps=emitted / (t2 - t0),
                steady=(emitted - n1) / (t2 - t1), prof=prof,
                peak_mib=torch.cuda.max_memory_allocated() / 2**20,
                reserved_mib=torch.cuda.max_memory_reserved() / 2**20,
                counts=dict(comb.graphs.counts), keys=len(caps),
                capture_s=(min(caps), max(caps)) if caps else (0.0, 0.0))


def _key_seconds(cache) -> dict:
    """Capture seconds by key name (the largest where a name has several
    keys, e.g. one a line count)."""
    out = {}
    for full, sec in cache.capture_seconds.items():
        name = str(full[0][0])
        out[name] = max(out.get(name, 0.0), sec)
    return out


def _both_ways(name, e, g, rate, unit):
    print(f'{name}: graphs {g["counts"]}, {g["keys"]} keys captured in '
          f'{g["capture_s"][0]:.3f}-{g["capture_s"][1]:.3f} s each '
          f'({", ".join(f"{k} {v:.3f}" for k, v in g["key_s"].items())})')
    for label, r in (('eager', e), ('graphs', g)):
        pr = r['prof']
        when = (f'after the first frame, {r["settled"]:.2f} from frame '
                f'{SEQ_GRAPH_STEADY}' if unit == 'MSa/s'
                else f'from frame {STREAM_GRAPH_STEADY}')
        print(f'  {label:6s}: {r[rate]:.2f} {unit} ({r["steady"]:.2f} '
              f'{when}), '
              f'one more call: {pr["device_ops"]} device ops, '
              f'{pr["kernel_launch_calls"]} kernel launch calls, '
              f'{pr["graph_launch_calls"]} graph launches, '
              f'{pr["host_ms"]:.3f} ms a call untraced; peak '
              f'{r["peak_mib"]:.1f} MiB allocated, {r["reserved_mib"]:.1f} '
              f'MiB reserved')


def _seq_values(torch, np, cfg, cap, bank, p):
    """Calls of one graph key with other window starts, mtf_level and
    audio_offset (SEQ_VALUE_CALLS fields): every graphed FieldDecoder call,
    `process` and `process_resident`, equals an eager decoder's call with
    the same values bit for bit, and the values move the outputs, so a
    value frozen into a capture would show."""
    from ld_decode_tpu_torch.ops import demod as D
    from ld_decode_tpu_torch.tbc import field as TFD
    nblk = p['nblocks']
    eager = TFD.FieldDecoder(cfg, bank, nblk, device='cuda', graphs=False)
    graphed = TFD.FieldDecoder(cfg, bank, nblk, device='cuda')
    capt = torch.from_numpy(np.asarray(cap, np.float32)).cuda()
    n = D.stream_len(cfg, nblk)
    starts, rs = [], p['start']
    while len(starts) < len(SEQ_VALUE_CALLS):
        r = eager.process_resident(capt, rs)
        if r is None:
            fail(f'{cfg.system} values case: the capture ended')
        if r.valid:
            starts.append(rs)
        rs += r.nextfieldoffset
    firsts = []
    for rs, (mtf, aoff) in zip(starts, SEQ_VALUE_CALLS):
        window = cap[rs - cfg.blockcut:rs - cfg.blockcut + n]
        for name, call in (
                ('process', lambda dec: dec.process(window, mtf, aoff)),
                ('process_resident',
                 lambda dec: dec.process_resident(capt, rs, mtf, aoff))):
            a, b = call(eager), call(graphed)
            if not a.valid:
                fail(f'{cfg.system} values case: {name} at {rs} invalid')
            _same(np, f'{cfg.system} {name} at {rs}, mtf {mtf}, audio '
                  f'offset {aoff}', _field_values(a), _field_values(b))
        firsts.append(a)
    c = graphed.graphs.counts
    moved = not np.array_equal(firsts[0].dspicture, firsts[2].dspicture) \
        and firsts[0].audio_next_offset != firsts[2].audio_next_offset
    print(f'{cfg.system} values case, {len(starts)} fields with other '
          f'starts, mtf_level and audio_offset: process and '
          f'process_resident bit-equal to eager; graphs {c}; the values '
          f'move the outputs: {moved}')
    if c['replays'] < 2 * len(starts) or not moved:
        fail(f'{cfg.system} values case: replays {c}, outputs moved '
             f'{moved}')


def _field_values(f) -> list:
    return [f.valid, f.nextfieldoffset, f.istop, f.linecount,
            f.audio_next_offset, f.linelocs, f.burstlevel, f.dspicture,
            f.dsaudio, f.vbi, f.linecode]


def _finish_batch(torch, np, FR, FU, CR, F, cfg, cap, nblk, start):
    """field_finish_batch on a 16-field batch from a locked start, on the
    card against the CPU on the same inputs (phase 5's budgets); its ms a
    batch (CUDA events, median of FINISH_REPS) and K1 launches a call."""
    bank = F.make_demod_bank(cfg, np.complex64, device='cuda')
    fr = FR.Framer(cfg, bank, capture=cap, batch=1, nblocks=nblk,
                   device='cuda', graphs=False)
    f0, rs0, _ = fr.readfield(None, start)
    rs0 = int(f0.readsample if f0.readsample >= 0 else rs0)
    pitch = int(round(cfg.freq_hz / cfg.sys.fps / 2))
    starts = FU.pipeline_starts(rs0, 0, FINISH_BATCH, pitch, cap.shape[0],
                                cfg, nblk, device='cuda')
    video, audio1, lld, lc, valid, *_ = FU.pipeline_analyze(
        fr.capture_dev, starts, 1.0, bank, cfg, nblk)
    if not bool(valid.all()):
        fail(f'{cfg.system} finish batch: invalid fields in the batch')
    offs = torch.arange(FINISH_BATCH, device='cuda', dtype=torch.float32) \
        * 2.5e-6
    n_audio1 = nblk * bank.a_stage1_keep
    args = (video, audio1, lld.lli, lld.llf, lld.bad, lc, offs)

    def call(dev, b):
        a = [{k: v.to(dev) for k, v in x.items()} if isinstance(x, dict)
             else x.to(dev) for x in args]
        return FU.field_finish_batch(*a, b, cfg, n_audio1, graphs=False)

    CR.resample_lines_batch.launches = 0
    got = {k: v.cpu().numpy() for k, v in call('cuda', bank).items()}
    launches = CR.resample_lines_batch.launches
    ms = _event_median_ms(torch, lambda: call('cuda', bank), FINISH_REPS)
    want = {k: v.numpy() for k, v in call(
        'cpu', F.make_demod_bank(cfg, np.complex64, device='cpu')).items()}
    loc = lambda d: d['linelocs_i'].astype(np.float64) + d['linelocs_f']
    dll = float(np.abs(loc(got) - loc(want)).max())
    lcs = lc.cpu().numpy()
    p999, pmax, tmax = 0.0, 0, 0
    for b in range(FINISH_BATCH):
        n = int(lcs[b])
        cut = n - PAL_TAIL_ROWS if cfg.system == 'PAL' else n
        dp = np.abs(got['picture'][b, :n].astype(np.int64)
                    - want['picture'][b, :n])
        p999 = max(p999, float(np.percentile(dp[24:cut], 99.9)))
        pmax = max(pmax, int(dp[24:cut].max()))
        tmax = max(tmax, int(dp[cut:].max()) if cut < n else 0)
    if not np.array_equal(got['audio_count'], want['audio_count']):
        fail(f'{cfg.system} finish batch: audio tick counts differ')
    da = np.concatenate([np.abs(got['audio'][b, :2 * (c - 1)].astype(
        np.float64) - want['audio'][b, :2 * (c - 1)])
        for b, c in enumerate(want['audio_count'])])
    picks = da > AUDIO_PICK_LSB
    arms = float(np.sqrt(np.mean(da[~picks] ** 2)))
    print(f'{cfg.system} field_finish_batch, {FINISH_BATCH} fields: '
          f'{ms:.3f} ms a batch on the card (CUDA events, median of '
          f'{FINISH_REPS}); K1 {launches} launches a call; card vs CPU '
          f'linelocs max|d| {dll:.2e} px, picture p99.9 {p999} max {pmax} '
          f'LSB (tail rows max {tmax}), audio rms {arms:.3f} LSB with '
          f'{int(picks.sum())} of {da.size} values over {AUDIO_PICK_LSB}')
    if dll > 0.02 or p999 > 2 or pmax > 4 or tmax > PAL_TAIL_MAX \
            or arms > 0.6 or picks.mean() > AUDIO_PICK_MAX:
        fail(f'{cfg.system} field_finish_batch card vs CPU outside the '
             f'budgets')
    want_k1 = 3 if cfg.system == 'NTSC' else 1
    if launches != want_k1:
        fail(f'{cfg.system} field_finish_batch: K1 {launches} launches, '
             f'want {want_k1}')
    return dict(ms=ms, k1=launches)


def seq_graphs_phase(torch, np, systems, d: str):
    """systems: {name: (cfg, cap, bank)}.  Returns the numbers PERF.md
    keeps and the paths' launches."""
    phase('26 sequential graphs: --batch 1, the resident sequential '
          'decode, the streaming comb, ldview, field_finish_batch')
    import ldview_torch
    from ld_decode_tpu_torch.comb import comb_ntsc as TC
    from ld_decode_tpu_torch.io import loaders as L
    from ld_decode_tpu_torch.ops import cuda_gather as CG
    from ld_decode_tpu_torch.ops import filters as F
    from ld_decode_tpu_torch.tbc import cuda_resample as CR
    from ld_decode_tpu_torch.tbc import framer as FR
    from ld_decode_tpu_torch.tbc import fused as FU
    res, launches = {}, {}
    for system in ('NTSC', 'PAL'):
        cfg, cap, bank = systems[system]
        p = SEQ_PATHS[system]
        spf = int(cfg.freq_hz / cfg.sys.fps) + 1
        path = os.path.join(d, f'seq_graphs_{system}.lds')
        L.pack_data_4_40(cap[:(SEQ_GRAPH_FRAMES + 4) * spf]).tofile(path)
        runs = [(f'{system} --batch 1', path, SEQ_GRAPH_FRAMES)]
        if system == 'NTSC':
            runs.append(('NTSC resident sequential', cap, 5))
        for label, source, n in runs:
            e = _seq_run(torch, np, FR, CR, cfg, bank, source, p, False, n)
            g = _seq_run(torch, np, FR, CR, cfg, bank, source, p, True, n)
            _same(np, f'{label} .tbc frames', e['frames'], g['frames'])
            _same(np, f'{label} .pcm audio', e['audio'], g['audio'])
            _same(np, f'{label} fields', e['fields'], g['fields'])
            if g['counts']['replays'] < 1 or e['k1'] != g['k1'] \
                    or g['k1'] == 0:
                fail(f'{label}: replays {g["counts"]}, K1 eager {e["k1"]} '
                     f'graphs {g["k1"]}')
            print(f'{label}, {n} frames: frames, audio and fields '
                  f'bit-equal; K1 {g["k1"]} both ways')
            _both_ways(label, e, g, 'msas', 'MSa/s')
            res[label] = {k: {q: r[q] for q in (
                'msas', 'steady', 'settled', 'prof', 'peak_mib',
                'reserved_mib', 'counts', 'keys', 'capture_s', 'key_s')}
                for k, r in (('eager', e), ('graphs', g))}
            launches[label] = g['k1']
        _seq_values(torch, np, cfg, cap, bank, p)
        # the CLI both ways, the same files
        outs = []
        for flags in (['--no-graphs'], []):
            out = os.path.join(d, f'cli_{system}{"".join(flags)}')
            dt, _ = _run_cli('lddecode_torch.py', [
                path, out, '--batch', '1', '-l', '4', '-q'] + flags
                + (['-p'] if system == 'PAL' else []))
            outs.append((open(out + '.tbc', 'rb').read(),
                         open(out + '.pcm', 'rb').read(), dt))
        if outs[0][:2] != outs[1][:2] or not outs[0][0]:
            fail(f'lddecode_torch.py --batch 1 {system}: the graphed and '
                 f'the --no-graphs run wrote different files')
        print(f'lddecode_torch.py --batch 1 -l 4 {system}: .tbc '
              f'({len(outs[0][0])} bytes) and .pcm equal both ways; '
              f'{outs[0][2]:.1f} s eager, {outs[1][2]:.1f} s graphed (new '
              f'processes, the build and the warm-ups included)')
        res[f'{system} cli s'] = dict(eager=outs[0][2], graphs=outs[1][2])
        fb = _finish_batch(torch, np, FR, FU, CR, F, cfg, cap,
                           DECODE_PATHS[system]['nblocks'],
                           DECODE_PATHS[system]['start'])
        res[f'{system} finish batch'] = fb
        launches[f'{system} finish batch'] = fb['k1']

    # the streaming comb over decoded frames of phase 4's capture
    cfg, cap, bank = systems['NTSC']
    fr = FR.Framer(cfg, bank, capture=cap, batch=16, nblocks=52,
                   device='cuda')
    frames, s = [], 33046
    for i in range(STREAM_GRAPH_FRAMES + 4):
        rv = fr.readframe(None, s, i == 0)
        if rv[0] is None:
            fail(f'streaming comb: capture ended at frame {i}')
        frames.append(rv[0])
        s = rv[2]
    del fr
    for label, ccfg, fs in (
            ('NTSC streaming comb dim 3 flow', TC.CombConfig(dim=3),
             frames),
            ('NTSC streaming comb dim 2 -D -l',
             TC.CombConfig(dim=2, debug2d=True, debugline=100),
             frames[:8])):
        e = _stream_run(torch, np, TC, CG, ccfg, fs, False)
        g = _stream_run(torch, np, TC, CG, ccfg, fs, True)
        _same(np, f'{label} RGB48, words, extras', e['out'], g['out'])
        # (the flow runs from the second frame, from the third with K2)
        if g['counts']['replays'] < 1 or e['k2'] != g['k2'] or (
                ccfg.dim == 3 and g['k2'] != 9 * (len(fs) - 2)):
            fail(f'{label}: replays {g["counts"]}, K2 eager {e["k2"]} '
                 f'graphs {g["k2"]}')
        print(f'{label}, {len(fs)} frames -> {g["emitted"]} RGB frames: '
              f'RGB48, words and extras bit-equal; K2 {g["k2"]} both ways')
        _both_ways(label, e, g, 'fps', 'RGB frames/s')
        res[label] = {k: {q: r[q] for q in (
            'fps', 'steady', 'prof', 'peak_mib', 'reserved_mib', 'counts',
            'keys', 'capture_s', 'key_s')}
            for k, r in (('eager', e), ('graphs', g))}
        launches[label] = g['k2']

    # ldview both ways on phase 26's NTSC .lds
    # (the CLI is eager; main(graphs=True) is the comparison)
    imgs = {}
    for graphs in (False, True):
        CR.resample_lines_batch.launches = 0
        img = os.path.join(d, f'view_graphs{int(graphs)}.rgb')
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rc = ldview_torch.main([os.path.join(d, 'seq_graphs_NTSC.lds'),
                                '902', img], graphs=graphs)
        torch.cuda.synchronize()
        imgs[graphs] = (rc, time.perf_counter() - t0,
                        CR.resample_lines_batch.launches,
                        open(img, 'rb').read())
    (rc0, t0_, k0, b0), (rc1, t1_, k1, b1) = imgs[False], imgs[True]
    print(f'ldview_torch.py CAV 902 (raw RGB48): {t0_:.3f} s eager, '
          f'{t1_:.3f} s graphed; the same image ({len(b0)} bytes); K1 '
          f'{k0} / {k1}')
    if rc0 or rc1 or b0 != b1 or len(b0) != 744 * 480 * 3 * 2 or k0 != k1:
        fail('ldview: eager and graphed runs differ')
    res['ldview s'] = dict(eager=t0_, graphs=t1_)
    launches['ldview graphs'] = k1
    return res, launches


# phase 27: the file decode's graphs across segment swaps and the last
# comb paths, eager then graphed in one call.  SEG_TILES copies of phase
# 4's (NTSC) and phase 10's (PAL) capture, each cut to a whole number of
# frames and colour-subcarrier cycles (SEG_TILE_SAMPLES: 48 and 40
# frames), written in a row as one .lds and decoded segmented (batch 16)
# at the smallest legal segment, 2x the chain horizon: >= SEG_MIN_SWAPS
# swaps and a short zero-padded tail (the FM carriers' phase steps at
# each join, which the decode rides).  The batch combs over the woven
# frames of phases 7 and 12 played twice in CombWindows(8, 3), steady from
# window COMB_STEADY on (the first window holds 8 frames and the later 10
# where 2 stay pending, so the later key captures in window 3); the
# streaming PAL comb (dim 3) over
# PAL_STREAM_FRAMES of phase 12's frames, steady from frame
# PAL_STREAM_STEADY on (its 3D key captured in the frame before)
SEG_TILES, SEG_MIN_SWAPS = 5, 3
SEG_TILE_SAMPLES = {'NTSC': 64_064_000, 'PAL': 64_000_000}
COMB_STEADY, COMB_REPS = 3, 5
PAL_STREAM_FRAMES, PAL_STREAM_STEADY = 12, 4


def _seg_decode(torch, np, FR, CR, L, cfg, bank, path, p, graphs):
    """The whole .lds through Framer(loader, batch 16, the smallest
    segment, graphs=...): sha256 of the .tbc frames and the .pcm audio, K1
    launches, MSa/s whole and after the first frame, each segment load
    (base, real samples, the batch call's graph counts and the device
    memory reserved before it), capture seconds, peak memory, K4's
    launches and widenings by route."""
    from ld_decode_tpu_torch.tbc import cuda_widen as CW
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    CR.resample_lines_batch.launches = 0
    CW.widen.launches, routes = 0, dict(CW.routes)
    fr = FR.Framer(cfg, bank, loader=L.loader_for_path(path), batch=16,
                   nblocks=p['nblocks'], segment_samples=1, device='cuda',
                   graphs=graphs)
    pf = fr.prefetcher
    set_capture, loads = pf.set_capture, []

    def counted(capture, base, valid_len=None):
        torch.cuda.synchronize()
        loads.append(dict(base=base, valid=valid_len,
                          counts=dict(pf.graphs.counts),
                          reserved_mib=torch.cuda.memory_reserved() / 2**20))
        return set_capture(capture, base, valid_len)

    pf.set_capture = counted
    tbc, pcm = hashlib.sha256(), hashlib.sha256()
    n, sample = 0, p['start']
    with open(path, 'rb') as fd:
        t0 = time.perf_counter()
        rv = fr.readframe(fd, sample, True)
        while rv[0] is not None:
            tbc.update(np.ascontiguousarray(rv[0]).tobytes())
            if rv[1] is not None:
                pcm.update(np.ascontiguousarray(rv[1]).tobytes())
            n += 1
            sample = rv[2]
            if n == 1:
                t1, s1 = time.perf_counter(), sample
            rv = fr.readframe(fd, sample, False)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
    return dict(frames=n, tbc=tbc.hexdigest(), pcm=pcm.hexdigest(),
                k1=CR.resample_lines_batch.launches,
                k4=CW.widen.launches,
                widenings={k: CW.routes[k] - routes[k] for k in routes},
                msas=(sample - p['start']) / (t2 - t0) / 1e6,
                steady=(sample - s1) / (t2 - t1) / 1e6,
                loads=loads, seg=fr._seg_samples,
                counts=dict(pf.graphs.counts),
                end_reserved_mib=torch.cuda.memory_reserved() / 2**20,
                capture_s=sum(pf.graphs.capture_seconds.values()),
                peak_mib=torch.cuda.max_memory_allocated() / 2**20,
                reserved_mib=torch.cuda.max_memory_reserved() / 2**20)


def _comb_run(torch, np, CB, comb, frames):
    """The frames through CombWindows(comb, 8, 3) (ldchain_torch.py's
    loop), then one more window of 8 fed and collected under the profiler
    and COMB_REPS more timed: the RGB frames and words, RGB frames/s,
    t_feed a window (all; from window COMB_STEADY on), the window's launch
    profile and its host ms fed and collected (median; the collect waits
    for the copies)."""
    out = []
    windows = CB.CombWindows(comb, 8, 3, lambda r, w: out.append((r, w)))
    torch.cuda.synchronize()
    t0, mark = time.perf_counter(), None
    for f in frames:
        if mark is None and comb.stats['windows'] == COMB_STEADY:
            mark = dict(comb.stats)
        windows.push(f)
    windows.drain()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    st = comb.stats
    res = dict(out=out, fps=len(out) / dt,
               feed_ms=st['t_feed'] / st['windows'] * 1e3,
               steady_feed_ms=(st['t_feed'] - mark['t_feed'])
               / (st['windows'] - mark['windows']) * 1e3,
               windows=st['windows'])
    win = torch.stack(frames[:8])
    res['prof'] = _launch_profile(torch,
                                  lambda: comb.collect(comb.feed(win)))
    times = []
    for _ in range(COMB_REPS):
        t0 = time.perf_counter()
        comb.collect(comb.feed(win))
        times.append(time.perf_counter() - t0)
    res['window_ms'] = statistics.median(times) * 1e3
    return res


def _key_windows(cache) -> dict:
    """Capture seconds by key name and window length."""
    return {f'{full[0][0]} M={full[2][0][0][0]}': sec
            for full, sec in cache.capture_seconds.items()}


def _pal_stream(torch, np, TP, frames, graphs):
    """PALComb(dim 3) over the frames and its flush: the RGB frames, ms a
    frame over all and from PAL_STREAM_STEADY on, the cache."""
    comb = TP.PALComb(TP.CombPALConfig(dim=3), device='cuda', graphs=graphs)
    out, times = [], []
    for f in frames:
        t0 = time.perf_counter()
        r = comb.process(f)
        times.append(time.perf_counter() - t0)
        if r is not None:
            out.append(r)
    out.append(comb.flush())
    return dict(out=out, ms=sum(times) / len(times) * 1e3,
                steady_ms=statistics.mean(times[PAL_STREAM_STEADY:]) * 1e3,
                counts=dict(comb.graphs.counts),
                key_s={'3D' if full[0][2] else '2D': sec for full, sec
                       in comb.graphs.capture_seconds.items()})


def segment_graphs_phase(torch, np, systems, woven, d: str):
    """systems: {name: (cfg, cap, bank)}; woven: {name: the chain phases'
    woven frames on the host}.  Returns the numbers PERF.md keeps and the
    graphed segmented decodes' K1 launches."""
    phase('27 segments and combs: the file decode across segment swaps, '
          'the no-flow / 2D NTSC and PAL batch combs, the streaming PAL '
          'comb, graphs vs eager')
    from ld_decode_tpu_torch.comb import batch as CB
    from ld_decode_tpu_torch.comb import comb_ntsc as TC
    from ld_decode_tpu_torch.comb import comb_pal as TP
    from ld_decode_tpu_torch.io import loaders as L
    from ld_decode_tpu_torch.io import native_unpack as NU
    from ld_decode_tpu_torch.tbc import cuda_resample as CR
    from ld_decode_tpu_torch.tbc import cuda_widen as CW
    from ld_decode_tpu_torch.tbc import framer as FR
    res, k1 = {}, {}
    for system in ('NTSC', 'PAL'):
        cfg, cap, bank = systems[system]
        p = DECODE_PATHS[system]
        tile = cap[:SEG_TILE_SAMPLES[system]]
        if tile.shape[0] != SEG_TILE_SAMPLES[system]:
            fail(f'{system} segments: the capture holds {cap.shape[0]} '
                 f'samples, under a tile')
        path = os.path.join(d, f'tiled_{system}.lds')
        packed = NU.pack_4_40(tile).tobytes()
        with open(path, 'wb') as f:
            for _ in range(SEG_TILES):
                f.write(packed)
        del packed
        n_file = SEG_TILES * tile.shape[0]
        e = _seg_decode(torch, np, FR, CR, L, cfg, bank, path, p, False)
        g = _seg_decode(torch, np, FR, CR, L, cfg, bank, path, p, True)
        os.remove(path)
        seg = g['seg']
        label = f'{system} segmented file'
        if (e['tbc'], e['pcm'], e['frames']) != (g['tbc'], g['pcm'],
                                                 g['frames']):
            fail(f'{label}: the graphed .tbc/.pcm differ from the eager '
                 f'ones ({e["frames"]} vs {g["frames"]} frames)')
        spf = cfg.freq_hz / cfg.sys.fps
        first, end = g['loads'][1]['counts'], g['counts']
        swaps = len(g['loads']) - 1
        print(f'{label}: {n_file} samples ({SEG_TILES} tiles), segment '
              f'{seg} samples, {swaps} swaps, the tail segment '
              f'{g["loads"][-1]["valid"]} real samples (zero-padded to '
              f'{seg}); {g["frames"]} frames, .tbc and .pcm bit-equal both '
              f'ways (sha256 {g["tbc"][:16]}, {g["pcm"][:16]}); K1 '
              f'{e["k1"]} eager, {g["k1"]} graphed')
        print(f'  graph counts after the first segment {first}, at the '
              f'end {end}; capture {g["capture_s"]:.3f} s')
        for name, r in (('eager', e), ('graphs', g)):
            grow = r['end_reserved_mib'] - r['loads'][1]['reserved_mib']
            r['reserved_growth_mib'] = grow
            print(f'  {name:6s}: {r["msas"]:.2f} MSa/s ({r["steady"]:.2f} '
                  f'after the first frame); peak {r["peak_mib"]:.1f} MiB '
                  f'allocated, {r["reserved_mib"]:.1f} MiB reserved; '
                  f'reserved at each load '
                  + ', '.join(f'{x["reserved_mib"]:.1f}' for x in r['loads'])
                  + f', at the end {r["end_reserved_mib"]:.1f} MiB (grew '
                  f'{grow:.1f} MiB after the first segment)')
            if grow > seg * 4 / 2**20 / 2:
                fail(f'{label} ({name}): reserved memory grew by {grow:.1f} '
                     f'MiB over the swaps (a segment is '
                     f'{seg * 4 / 2**20:.1f} MiB)')
        if swaps < SEG_MIN_SWAPS or g['loads'][-1]['valid'] >= seg \
                or any(x['valid'] != seg for x in g['loads'][:-1]):
            fail(f'{label}: {swaps} swaps, loads '
                 f'{[x["valid"] for x in g["loads"]]}: want >= '
                 f'{SEG_MIN_SWAPS} full segments after the first and a '
                 f'short tail')
        if g['frames'] < 0.9 * (n_file - p['start']) / spf:
            fail(f'{label}: {g["frames"]} frames of a '
                 f'{(n_file - p["start"]) / spf:.0f}-frame file')
        if (first['eager_warmups'], first['captures']) != (
                end['eager_warmups'], end['captures']) \
                or first['captures'] < 1 or end['replays'] <= first['replays']:
            fail(f'{label}: graph counts after the first segment {first}, '
                 f'at the end {end}')
        if e['k1'] != g['k1'] or g['k1'] == 0:
            fail(f'{label}: K1 eager {e["k1"]}, graphed {g["k1"]}')
        k1[system] = g['k1']
        # K4: one widening of the .lds route's uint16 a swap, on the card,
        # its schedule's launches for the swap's real samples
        for name, r in (('eager', e), ('graphs', g)):
            want = sum(len(CW.widen_schedule(x['valid'], 2)) - 1
                       for x in r['loads'])
            print(f'  {name:6s}: K4 {r["k4"]} launches over '
                  f'{len(r["loads"])} loads (expected {want}), widenings '
                  f'{r["widenings"]}')
            if r['k4'] != want or r['widenings'] != {
                    'card': len(r['loads']), 'host': 0}:
                fail(f'{label} ({name}): K4 launches {r["k4"]}, expected '
                     f'{want}; widenings {r["widenings"]} for '
                     f'{len(r["loads"])} loads')
        res[label] = dict(
            swaps=swaps, seg=seg, tail=g['loads'][-1]['valid'],
            frames=g['frames'], first=first, end=end, k4=g['k4'],
            capture_s=g['capture_s'],
            **{k: {q: r[q] for q in ('msas', 'steady', 'peak_mib',
                                     'reserved_mib', 'reserved_growth_mib')}
               for k, r in (('eager', e), ('graphs', g))})

    # the batch combs over the chains' woven frames, played twice
    for label, make, frames in (
            ('NTSC batch comb -F', lambda g: CB.NTSCCombBatch(
                TC.CombConfig(dim=3, opticalflow=False), device='cuda',
                graphs=g), woven['NTSC']),
            ('NTSC batch comb -d 2', lambda g: CB.NTSCCombBatch(
                TC.CombConfig(dim=2), device='cuda', graphs=g),
             woven['NTSC']),
            ('PAL batch comb -d 3', lambda g: CB.PALCombBatch(
                TP.CombPALConfig(dim=3), device='cuda', graphs=g),
             woven['PAL']),
            ('PAL batch comb -d 2', lambda g: CB.PALCombBatch(
                TP.CombPALConfig(dim=2), device='cuda', graphs=g),
             woven['PAL'])):
        dev = [f.cuda() for f in frames + frames]
        ce, cg = make(False), make(True)
        e = _comb_run(torch, np, CB, ce, dev)
        g = _comb_run(torch, np, CB, cg, dev)
        del dev
        _same(np, f'{label} RGB48 and words', e['out'], g['out'])
        c = cg.graphs.counts
        if c['replays'] < 2 or g['prof']['graph_launch_calls'] != 1:
            fail(f'{label}: graphs {c}, {g["prof"]["graph_launch_calls"]} '
                 f'graph launches a window')
        key_s = _key_windows(cg.graphs)
        print(f'{label}, {len(frames)} frames played twice -> '
              f'{len(g["out"])} RGB frames in {g["windows"]} windows: RGB48 '
              f'and words bit-equal; graphs {c}; capture s a key '
              + ', '.join(f'{k} {v:.3f}' for k, v in key_s.items()))
        for name, r in (('eager', e), ('graphs', g)):
            pr = r['prof']
            print(f'  {name:6s}: {r["fps"]:.2f} RGB frames/s, t_feed '
                  f'{r["feed_ms"]:.3f} ms a window ({r["steady_feed_ms"]:.3f}'
                  f' from window {COMB_STEADY}); one more window of 8: '
                  f'{pr["device_ops"]} device ops, '
                  f'{pr["kernel_launch_calls"]} kernel launch calls, '
                  f'{pr["graph_launch_calls"]} graph launches; fed and '
                  f'collected in {r["window_ms"]:.3f} ms (median of '
                  f'{COMB_REPS}: {8e3 / r["window_ms"]:.2f} RGB frames/s)')
        res[label] = dict(counts=c, key_s=key_s, **{
            k: {q: r[q] for q in ('fps', 'feed_ms', 'steady_feed_ms',
                                  'prof', 'window_ms')}
            for k, r in (('eager', e), ('graphs', g))})

    # the streaming PAL comb (ldexport_torch.py --pal)
    frames = [f.numpy() for f in woven['PAL'][:PAL_STREAM_FRAMES]]
    e = _pal_stream(torch, np, TP, frames, False)
    g = _pal_stream(torch, np, TP, frames, True)
    _same(np, 'PAL streaming comb RGB48', e['out'], g['out'])
    if g['counts']['replays'] < 2 or len(g['out']) != len(frames):
        fail(f'PAL streaming comb: graphs {g["counts"]}, '
             f'{len(g["out"])} RGB frames of {len(frames)}')
    print(f'PAL streaming comb -d 3, {len(frames)} frames and the flush: '
          f'RGB48 bit-equal; graphs {g["counts"]}; capture s a key '
          + ', '.join(f'{k} {v:.3f}' for k, v in g['key_s'].items()))
    for name, r in (('eager', e), ('graphs', g)):
        print(f'  {name:6s}: {r["ms"]:.3f} ms a frame ({r["steady_ms"]:.3f} '
              f'from frame {PAL_STREAM_STEADY})')
    res['PAL streaming comb'] = dict(
        counts=g['counts'], key_s=g['key_s'],
        **{k: {q: r[q] for q in ('ms', 'steady_ms')}
           for k, r in (('eager', e), ('graphs', g))})
    return res, k1


# phase 29: the last compile-boundary keys, eager then graphed in one call
# (graphs=False, then the default): the chain's device weave with its words
# over the chain-mode frames of phase 4's and phase 10's captures, all kept
# (as a comb window keeps them); field_analyze_batch / field_finish_batch on
# 16-field batches at API_CALLS starts; decode_vhs over VHS_WINDOWS windows
# of nblocks 66; the legacy PAL comb at dims 2 and 3 over LEGACY_FRAMES
# frames.  Each bit-equal both ways, its counts and capture seconds, the
# seconds of its first two calls (the warm-up and the capture) and, over
# its calls run again, its host ms a call (the Python call, no
# synchronisation, median) and its wall ms a call to the end of the device
# work, both ways.
WEAVE_FRAMES, API_CALLS, VHS_WINDOWS, LEGACY_FRAMES = 12, 4, 6, 4


def _snapshot(cache) -> tuple:
    return dict(cache.counts), set(cache.capture_seconds)


def _site_counts(cache, before: tuple) -> dict:
    """The cache's counts since `before` (a `_snapshot`), and the capture
    seconds of each key captured since, by name."""
    counts, keys = before
    out = {k: cache.counts[k] - counts[k] for k in counts}
    out['capture_s'] = {str(full[0][0]): round(sec, 4)
                        for full, sec in cache.capture_seconds.items()
                        if full not in keys}
    return out


def _host_ms(torch, calls) -> tuple:
    """Run each of `calls` (no arguments) in turn, keeping the results,
    then time them all again with their results dropped (as a user's loop
    drops each call's result, so the allocator reuses its memory).
    Returns (the first pass's results, a dict: the seconds of the first two
    calls to the end of their device work (a key's warm-up and capture),
    and from the second pass the median host ms of the Python call and the
    wall ms a call to the end of the device work)."""
    torch.cuda.synchronize()
    outs = []
    t0 = time.perf_counter()
    for k, fn in enumerate(calls):
        if k == 2:
            torch.cuda.synchronize()
            t2 = time.perf_counter()
        outs.append(fn())
    torch.cuda.synchronize()
    host = []
    t1 = time.perf_counter()
    for fn in calls:
        t = time.perf_counter()
        fn()
        host.append(time.perf_counter() - t)
    torch.cuda.synchronize()
    return outs, {'first_two_s': round(t2 - t0, 4),
                  'host_ms_a_call': round(statistics.median(host) * 1e3, 4),
                  'wall_ms_a_call': round((time.perf_counter() - t1) * 1e3
                                          / len(calls), 4)}


def _weave_site(torch, np, cfg, cap, bank, start) -> dict:
    from ld_decode_tpu_torch.tbc import framer as FR
    from ld_decode_tpu_torch.utils.graphs import GraphCache
    fr = FR.Framer(cfg, bank, capture=cap, batch=16, device='cuda',
                   fetch_picture=False, nblocks=52 if cfg.system == 'NTSC'
                   else 56)
    pairs, s = [], start
    for i in range(WEAVE_FRAMES + 1):
        rv = fr.readframe(None, s, i == 0)
        if rv[0] is None:
            break
        s = rv[2]
        if all(f.dev_picture is not None for f in rv[3]):
            pairs.append((rv[3], fr.mergevbi(rv[3])))
    straddle = sum(p[0].dev_picture[0] is not p[1].dev_picture[0]
                   for p, _ in pairs)
    res = {'frames': len(pairs), 'straddling pairs': straddle}
    outs = {}
    for mode in ('eager', 'graph'):
        fr.weave_graphs = GraphCache('cuda', mode)
        before = _snapshot(fr.weave_graphs)
        outs[mode], res[mode] = _host_ms(
            torch, [lambda p=p, v=v: fr.formatoutput(p, v) for p, v in pairs])
    res['graph'].update(_site_counts(fr.weave_graphs, before))
    _same(np, f'{cfg.system} device weave', outs['eager'], outs['graph'])
    if len(pairs) < WEAVE_FRAMES - 2 \
            or res['graph']['replays'] != 2 * len(pairs) - 1:
        fail(f'{cfg.system} device weave graphed vs eager: {res}')
    return res


def _api_batches(torch, np, FR, FU, cfg, cap, bank, nblk, start):
    """API_CALLS 16-field batches from a locked start, 4 fields apart:
    their starts and host line tables (the batch call's own analysis)."""
    fr = FR.Framer(cfg, bank, capture=cap, batch=1, nblocks=nblk,
                   device='cuda', graphs=False)
    f0, rs0, _ = fr.readfield(None, start)
    rs0 = int(f0.readsample if f0.readsample >= 0 else rs0)
    pitch = int(round(cfg.freq_hz / cfg.sys.fps / 2))
    calls = []
    for k in range(API_CALLS):
        starts = FU.pipeline_starts(rs0, 4 * k, FINISH_BATCH, pitch,
                                    cap.shape[0], cfg, nblk, device='cuda')
        _v, _a, lld, lc, valid, *_ = FU.pipeline_analyze(
            fr.capture_dev, starts, 1.0, bank, cfg, nblk)
        if not bool(valid.all()):
            fail(f'{cfg.system} API batch {k}: invalid fields')
        offs = torch.arange(FINISH_BATCH, device='cuda',
                            dtype=torch.float32) * 2.5e-6 * (k + 1)
        calls.append((starts, lld.lli, lld.llf, lld.bad, lc, offs,
                      1.0 - 0.05 * k))
    return fr.capture_dev, calls


def _api_site(torch, np, cfg, cap, bank, nblk, start) -> dict:
    from ld_decode_tpu_torch.tbc import cuda_resample as CR
    from ld_decode_tpu_torch.tbc import framer as FR
    from ld_decode_tpu_torch.tbc import fused as FU
    from ld_decode_tpu_torch.utils.graphs import api_cache
    capt, calls = _api_batches(torch, np, FR, FU, cfg, cap, bank, nblk,
                               start)
    n_audio1 = nblk * bank.a_stage1_keep
    shared = api_cache(True, 'cuda')[0]
    res, outs = {}, {}
    for mode, graphs in (('eager', False), ('graph', True)):
        before = _snapshot(shared)
        CR.resample_lines_batch.launches = 0
        an, an_t = _host_ms(torch, [
            lambda c=c: FU.field_analyze_batch(capt, c[0], bank, cfg, nblk,
                                               c[6], graphs=graphs)
            for c in calls])
        fin, fin_t = _host_ms(torch, [
            lambda c=c, a=a: FU.field_finish_batch(
                a[0], a[1], *c[1:6], bank, cfg, n_audio1, graphs=graphs)
            for c, a in zip(calls, an)])
        res[mode] = {'analyze': an_t, 'finish': fin_t,
                     'K1': CR.resample_lines_batch.launches}
        if graphs:
            # the two keys' counts together, each key's capture seconds
            res[mode].update(_site_counts(shared, before))
        outs[mode] = (an, fin)
    _same(np, f'{cfg.system} field_analyze_batch / field_finish_batch',
          outs['eager'], outs['graph'])
    counts = tuple(res['graph'][k] for k in ('eager_warmups', 'captures',
                                             'replays'))
    if res['eager']['K1'] != res['graph']['K1'] \
            or counts != (2, 2, 2 * (2 * API_CALLS - 1)):
        fail(f'{cfg.system} field_analyze_batch / field_finish_batch '
             f'graphed vs eager: {res}')
    return res


def _vhs_site(torch, np) -> dict:
    from ld_decode_tpu_torch.ops import demod as D
    from ld_decode_tpu_torch.tape import vhs as V
    from ld_decode_tpu_torch.utils.graphs import api_cache
    cfg = V.vhs_config()
    nblocks = 66
    n = D.stream_len(cfg, nblocks)
    step = nblocks * cfg.block_keep
    rng = np.random.default_rng(RNG_SEED)
    sig = torch.from_numpy(rng.normal(
        32768, 6000, n + (VHS_WINDOWS - 1) * step).astype(np.float32)).cuda()
    bank = V.make_vhs_bank(cfg, device='cuda')
    shared = api_cache(True, 'cuda')[0]
    res, outs = {}, {}
    for mode, graphs in (('eager', False), ('graph', True)):
        before = _snapshot(shared)
        outs[mode], res[mode] = _host_ms(torch, [
            lambda k=k: V.decode_vhs(sig[k * step:k * step + n], bank, cfg,
                                     nblocks, graphs=graphs)
            for k in range(VHS_WINDOWS)])
        # the steady rate: every window again, the key captured
        res[mode]['MSa_s'] = round(
            step / res[mode]['wall_ms_a_call'] / 1e3, 2)
        if graphs:
            res[mode].update(_site_counts(shared, before))
    _same(np, 'decode_vhs', outs['eager'], outs['graph'])
    if res['graph']['captures'] != 1 \
            or res['graph']['replays'] != 2 * VHS_WINDOWS - 1:
        fail(f'decode_vhs graphed vs eager: {res}')
    return res


def _legacy_site(torch, np) -> dict:
    from ld_decode_tpu_torch.comb import comb_pal_legacy as LG
    frames = [_legacy_pal_frame(np, seed) for seed in range(LEGACY_FRAMES)]
    res = {}
    for dim in (2, 3):
        outs = {}
        for mode, graphs in (('eager', False), ('graph', True)):
            comb = LG.LegacyPALComb(LG.LegacyPALConfig(dim=dim),
                                    device='cuda', graphs=graphs)
            before = _snapshot(comb.graphs)
            outs[mode], res[f'dim {dim} {mode}'] = _host_ms(torch, [
                lambda f=f: comb.process(f) for f in frames])
            if graphs:
                res[f'dim {dim} {mode}'].update(_site_counts(comb.graphs,
                                                             before))
        _same(np, f'legacy PAL comb dim {dim}', outs['eager'],
              outs['graph'])
        if res[f'dim {dim} graph']['replays'] != 2 * LEGACY_FRAMES - 1:
            fail(f'legacy PAL comb dim {dim} graphed vs eager: {res}')
    return res


def api_graphs_phase(torch, np, systems) -> dict:
    """systems: {name: (cfg, cap, bank)}.  Returns each site's numbers;
    fails unless every site is bit-equal both ways (`_same`) with its
    counts."""
    phase('29 the last compile-boundary keys: graphs vs eager')
    res = {}
    for name, (cfg, cap, bank) in systems.items():
        start = 33046 if name == 'NTSC' else PAL_START
        res[f'{name} weave'] = _weave_site(torch, np, cfg, cap, bank, start)
        print(f'{name} device weave, bit-equal both ways',
              json.dumps(res[f'{name} weave']))
        res[f'{name} analyze/finish'] = _api_site(
            torch, np, cfg, cap, bank, 52 if name == 'NTSC' else 56, start)
        print(f'{name} field_analyze_batch / field_finish_batch, '
              f'{FINISH_BATCH} fields, bit-equal both ways', json.dumps(
                  res[f'{name} analyze/finish']))
    res['decode_vhs'] = _vhs_site(torch, np)
    print(f'decode_vhs, {VHS_WINDOWS} windows of nblocks 66 (real time '
          f'28.64 MSa/s), bit-equal both ways', json.dumps(res['decode_vhs']))
    res['legacy PAL comb'] = _legacy_site(torch, np)
    print('legacy PAL comb, bit-equal both ways',
          json.dumps(res['legacy PAL comb']))
    return res


# phase 28: the repo's bench through the port (bench_torch.py --quick), in
# its own process, so every count there starts at 0
BENCH_DECODE = ('ntsc', 'ntsc_noisy', 'pal')
BENCH_FLOW = ('full_chain', 'full_chain_rgb8')
BENCH_NO_K2 = ('full_chain_noflow', 'pal_chain', 'pal_chain_rgb8')


def bench_phase(torch) -> dict:
    """bench_torch.py --quick: every stage's rate above 0, its checks held
    (frames checked, RGB frames back but those the comb holds), K1 launched
    in every stage, K2 in the flow chains only.  Returns each stage's
    launches."""
    phase('28 bench')
    dt, out = _run_cli('bench_torch.py', ['--quick'])
    try:
        line = json.loads(out.strip().splitlines()[-1])
    except (IndexError, ValueError) as e:
        fail(f'bench_torch.py printed no JSON line: {e}')
    extra = line['extra']
    stages = extra['stages']
    if line['value'] <= 0 or not extra['device']['power_limit'] \
            or extra['device']['count'] != torch.cuda.device_count():
        fail(f'bench_torch.py: headline {line["value"]}, device '
             f'{extra["device"]}')
    rates = {'ntsc': line['value']}
    for key in BENCH_DECODE[1:] + BENCH_FLOW + BENCH_NO_K2:
        rates[key] = extra.get(f'{key}_MSa_s', 0)
        if not rates[key] > 0:
            fail(f'bench_torch.py: {key} rate {rates[key]}')
    launches = {}
    for key, st in stages.items():
        k = st['kernel_launches']
        launches[key] = k
        if st['frames_checked'] <= 0 or k['K1'] <= 0:
            fail(f'bench_torch.py {key}: {st["frames_checked"]} frames '
                 f'checked, K1 launched {k["K1"]} times')
        if (k['K2'] > 0) != (key in BENCH_FLOW):
            fail(f'bench_torch.py {key}: K2 launched {k["K2"]} times')
        if key not in BENCH_DECODE and (
                st['rgb_frames'] <= 0
                or st['frames_fed'] - st['rgb_frames'] != st['comb_held']):
            fail(f'bench_torch.py {key}: {st["frames_fed"]} frames fed, '
                 f'{st["rgb_frames"]} back, {st["comb_held"]} held')
    print(f'bench_torch.py --quick: {dt:.1f} s, encode '
          f'{extra["encode_mode"]} {extra["encode_s"]}; '
          f'{"; ".join(extra["reduced"])}')
    print('bench stages (MSa/s, warmup_s)', json.dumps(
        {k: [rates[k], stages[k]['warmup_s']] for k in rates}))
    print('bench launches', json.dumps(launches))
    return launches


def main():
    if sys.argv[1:2] == ['--mesh-rank']:
        return mesh_rank(sys.argv[2:])
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
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, 'build')) as work:
        run(torch, np, work)


def run(torch, np, work: str):
    device_phase(torch)
    build_phase()
    kres = kernel_phase(torch, np)
    cfg, cap, bank, fr, launches, k4_ntsc = main_path_phase(torch, np)
    parity_phase(torch, np, cfg, bank, fr)
    ntsc_cli = cli_phase(np, cap, cfg, _subdir(work, 'ntsc'))
    del fr
    k1, k2, dev_frames, woven = chain_phase(torch, np, cfg, cap, bank)
    comb_parity_phase(torch, np, dev_frames)
    chain_cli_phase(torch, np, cap, cfg)
    del dev_frames

    pcfg, pcap, pbank, pfr, pal_launches, k4_pal = main_path_phase(
        torch, np, 'PAL')
    parity_phase(torch, np, pcfg, pbank, pfr,
                 title='11 PAL: card vs cpu, one batch', start=PAL_START,
                 nblk=56, tail_rows=PAL_TAIL_ROWS)
    del pfr
    pal_k1, pal_frames, pal_woven = pal_chain_phase(torch, np, pcfg, pcap,
                                                    pbank)
    pal_comb_parity_phase(torch, np, pal_frames)
    pal_cli = cli_phase(np, pcap, pcfg, _subdir(work, 'pal'),
                        title='14 PAL cli')
    chain_cli_phase(torch, np, pcap, pcfg, title='14 PAL chain cli')
    del pal_frames

    seq_ntsc, base = seq_decode_phase(torch, np, cfg, cap, bank, work)
    seq_pal, _ = seq_decode_phase(torch, np, pcfg, pcap, pbank, work)
    del bank, pbank
    k2_stream = stream_comb_phase(torch, np, base)
    k3 = k3_phase(torch, np)
    two = two_step_phase(torch, np, ntsc_cli, pal_cli, _subdir(work, 'two'))
    nn = nn_comb_phase(torch, np, ntsc_cli, _subdir(work, 'nn'))
    print('NN comb graphs vs eager', json.dumps(nn))
    vhs_phase(torch, np)
    loader_phase(torch, np, cfg, cap, _subdir(work, 'loader'))
    sharded = mesh_phase(torch, np, cfg, cap, pcfg, pcap,
                         _subdir(work, 'mesh'))
    from ld_decode_tpu_torch.ops import filters as F
    systems = {
        'NTSC': (cfg, cap, F.make_demod_bank(cfg, np.complex64,
                                             device='cuda')),
        'PAL': (pcfg, pcap, F.make_demod_bank(pcfg, np.complex64,
                                              device='cuda'))}
    legacy_comb_phase(torch, np)
    graphs = graphs_phase(torch, np, systems)
    print('graphs vs eager', json.dumps(graphs))
    seq_graphs, seq_launches = seq_graphs_phase(torch, np, systems,
                                                _subdir(work, 'seqgraphs'))
    print('sequential graphs vs eager', json.dumps(seq_graphs))
    seg_graphs, seg_k1 = segment_graphs_phase(
        torch, np, systems, {'NTSC': woven, 'PAL': pal_woven},
        _subdir(work, 'seg'))
    print('segments and combs, graphs vs eager', json.dumps(seg_graphs))
    bench = bench_phase(torch)
    api = api_graphs_phase(torch, np, systems)
    k4 = k4_phase(torch, np)
    unpack_phase(np)
    if 'jax' in sys.modules:
        fail('jax was imported')

    # the kernels line: each kernel with the launches of every path that
    # runs it (each path counted from 0 just before it, read just after);
    # `launches` is this slice's own path of each: the sequential decodes
    # (K1), the streaming comb (K2), file-level CX (K3), the graphed NTSC
    # segmented file decode (K4)
    print(f'K1 launches: NTSC decode {launches}, NTSC chain {k1}, PAL decode '
          f'{pal_launches}, PAL chain {pal_k1}, NTSC seq decode {seq_ntsc}, '
          f'PAL seq decode {seq_pal}, ldview {two["k1_view"]}; K2: NTSC chain '
          f'{k2}, NTSC stream comb {k2_stream}, ldexport {two["k2"]}; K3: cx '
          f'file {k3["launches"]}, ldexport {two["k3"]}; K1 in the sharded '
          f'decode: NTSC {sharded["NTSC"]} + burst window '
          f'{sharded["NTSC burst window"]}, PAL {sharded["PAL"]} (ranks '
          f'summed, by world size); K1 in the segmented file decode (graphed): NTSC {seg_k1["NTSC"]}, PAL '
          f'{seg_k1["PAL"]}')
    # the sharded decode is this slice's path: its `launches` are the
    # 2-rank world's, summed over the ranks
    k1_paths = {'ntsc seq decode': seq_ntsc, 'pal seq decode': seq_pal,
                'ntsc seq decode graphs': seq_launches['NTSC --batch 1'],
                'pal seq decode graphs': seq_launches['PAL --batch 1'],
                'ntsc resident seq graphs':
                    seq_launches['NTSC resident sequential'],
                'ntsc finish batch': seq_launches['NTSC finish batch'],
                'pal finish batch': seq_launches['PAL finish batch'],
                'ntsc finish batch graphs':
                    api['NTSC analyze/finish']['graph']['K1'],
                'pal finish batch graphs':
                    api['PAL analyze/finish']['graph']['K1'],
                'ldview graphs': seq_launches['ldview graphs'],
                'ldview': two['k1_view'], 'pal decode': pal_launches,
                'pal chain': pal_k1, 'ntsc decode': launches,
                'ntsc chain': k1,
                'ntsc segmented file graphs': seg_k1['NTSC'],
                'pal segmented file graphs': seg_k1['PAL'],
                'sharded decode': {f'{s.lower()} {w} rank{"s" * (w > 1)}': n
                                   for s, by in sharded.items()
                                   for w, n in by.items()},
                'bench': {k: v['K1'] for k, v in bench.items()},
                'bench burst window': {k: v['K1_window']
                                       for k, v in bench.items()}}
    k1_common = dict(route='cuda',
                     source='ld_decode_tpu_torch/csrc/resample_lines.cu',
                     replaces='ld_decode_tpu/tbc/pallas_resample.py:205',
                     ms_method=MS_METHOD)
    k3_launches = k3.pop('launches')
    k4_swap = k4.pop('launches')
    print(json.dumps({'kernels': [
        dict(name='resample_lines_batch[ntsc finish batch]',
             shape='ntsc field_finish_batch picture (16, 263, 910)',
             launches=seq_launches['NTSC finish batch'] // 3, **k1_common,
             **kres['K1']['ntsc picture']),
        dict(name='resample_lines_batch[ntsc finish batch burst]',
             shape='ntsc field_finish_batch burst window (16, 263, 48)',
             launches=2 * seq_launches['NTSC finish batch'] // 3,
             **k1_common, **kres['K1']['ntsc burst window']),
        dict(name='resample_lines_batch[pal finish batch]',
             shape='pal field_finish_batch picture (16, 313, 1135)',
             launches=seq_launches['PAL finish batch'], **k1_common,
             **kres['K1']['pal-width picture']),
        dict(name='resample_lines_batch[ntsc segmented]',
             shape='ntsc picture (16, 263, 910), segmented file, graphed',
             launches=seg_k1['NTSC'] // 3, **k1_common,
             **kres['K1']['ntsc picture']),
        dict(name='resample_lines_batch[pal segmented]',
             shape='pal picture (16, 313, 1135), segmented file, graphed',
             launches=seg_k1['PAL'], **k1_common,
             **kres['K1']['pal-width picture']),
        dict(name='resample_lines_batch[ntsc shard]',
             shape='ntsc shard picture (8, 263, 910)',
             launches=sharded['NTSC'][2], **k1_common,
             **kres['K1']['ntsc shard picture']),
        dict(name='resample_lines_batch[ntsc shard burst]',
             shape='ntsc shard burst window (8, 263, 48)',
             launches=sharded['NTSC burst window'][2], **k1_common,
             **kres['K1']['ntsc shard burst window']),
        dict(name='resample_lines_batch[pal shard]',
             shape='pal shard picture (8, 313, 1135)',
             launches=sharded['PAL'][2], **k1_common,
             **kres['K1']['pal shard picture']),
        dict(name='resample_lines_batch[ntsc seq]',
             shape='ntsc seq picture (1, 263, 910)', launches=seq_ntsc,
             launches_by_path=k1_paths, **k1_common,
             **kres['K1']['ntsc seq picture']),
        dict(name='resample_lines_batch[pal seq]',
             shape='pal seq picture (1, 313, 1135)', launches=seq_pal,
             **k1_common, **kres['K1']['pal seq picture']),
        dict(name='resample_lines_batch', shape='pal picture (16, 313, 1135)',
             launches=pal_k1, **k1_common,
             **kres['K1']['pal-width picture']),
        dict(name='resample_lines_batch[ntsc]',
             shape='ntsc picture (16, 263, 910)', launches=k1, **k1_common,
             **kres['K1']['ntsc picture']),
        dict(name='take_along_axis', route='cuda',
             source='ld_decode_tpu_torch/csrc/take_along_axis.cu',
             replaces='scripts/probe_warp.py:118', launches=k2_stream,
             launches_by_path={
                 'ntsc stream comb': k2_stream, 'ldexport': two['k2'],
                 'ntsc chain': k2,
                 'ntsc stream comb graphs':
                     seq_launches['NTSC streaming comb dim 3 flow'],
                 'bench': {k: v['K2'] for k, v in bench.items()}},
             ms_method=MS_METHOD, **kres['K2']['warp 2 fields x 252x840']),
        dict(name='envelope_lanes', route='cuda',
             source='ld_decode_tpu_torch/csrc/cx_envelope.cu',
             replaces='ld_decode_tpu/audio/cx.py:119 (_blocked_envelopes, '
                      'a lax.scan: no Pallas kernel)',
             launches=k3_launches,
             launches_by_path={'cx file': k3_launches,
                               'ldexport': two['k3']},
             shape='1 MB chunk: 4 lanes x 393,216 steps',
             ms_method='one eager call between CUDA events, median of 5',
             plain_on='cpu', **k3),
        dict(name='capture_widen', route='cuda',
             source='ld_decode_tpu_torch/csrc/capture_widen.cu',
             replaces='none: ld_decode_tpu/tbc/framer.py keeps the capture '
                      'uint16 on the device (jax.device_put)',
             shape='one segment swap: 2^28 uint16 samples widened in place',
             launches_by_path={
                 'segment swap (2^28 uint16)': k4_swap,
                 'ntsc decode (whole capture)': k4_ntsc,
                 'pal decode (whole capture)': k4_pal,
                 'ntsc segmented file graphs':
                     seg_graphs['NTSC segmented file']['k4'],
                 'pal segmented file graphs':
                     seg_graphs['PAL segmented file']['k4']},
             launches=seg_graphs['NTSC segmented file']['k4'],
             ms_method=K4_METHOD, **k4)]}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))


def _subdir(work: str, name: str) -> str:
    d = os.path.join(work, name)
    os.makedirs(d, exist_ok=True)
    return d


if __name__ == '__main__':
    main()
