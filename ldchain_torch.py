#!/usr/bin/env python
"""One-command RF -> RGB video + CX-expanded audio with the PyTorch port:
the device-resident full chain (torch port of ldchain_tpu.py).

The TBC pictures stay on the card (`Framer(fetch_picture=False)`), the
interlace weave runs there, and the batched comb (comb/batch.py: NTSC,
default dim 3 with Farnebäck optical flow; PAL with -p, default dim 3
with the temporal ring, 1135 x 576 at 25 fps) reads the woven frames
where they are; only the RGB frames and the audio come to the host.

Same arguments as ldchain_tpu.py plus --device (default `cuda`; without a
CUDA device it fails unless `--device cpu` asks for the CPU).  --efm also
pulls the EFM digital audio out of the capture on the host
(<out>.efm.pcm + <out>.subcode.log).

`-l N` writes the audio of exactly the first N decoded frames, a named
divergence from ldchain_tpu.py (ROADMAP.md Queue 3, fixed in the port):
the loop stops when the sink holds N frames, which lags the decode by up
to a comb window per window in flight, and ldchain_tpu.py writes the audio
of every frame it decoded.  The video is JAX's: the chain still decodes
past N for the comb's lookahead.
"""

import argparse
import sys

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description='Decode RF capture straight to RGB video + expanded '
                    'audio (device-resident chain; PyTorch port)')
    p.add_argument('infile', help='RF capture (.lds/.r30/.r16/.u8)')
    p.add_argument('out', help='output base name (.mp4 with ffmpeg, '
                               'else .rgb) + .audio.pcm')
    p.add_argument('-p', '--pal', action='store_true',
                   help='source is PAL')
    p.add_argument('-s', '--start', type=int, default=0,
                   help='rough jump to frame n of capture')
    p.add_argument('-S', '--seek', type=int, default=-1,
                   help='seek to frame n of capture (CAV/CLV aware)')
    p.add_argument('-l', '--length', type=int, default=None,
                   help='max output frames')
    p.add_argument('-d', '--dim', type=int, default=3,
                   help='comb dimensions (default 3, like encode-ntsc)')
    p.add_argument('--no-pilot-notch', action='store_true',
                   help='PAL: keep the 3.75 MHz pilot pattern in the picture '
                        '(default removes it with a per-line notch)')
    p.add_argument('--pal-colorlpf', action='store_true',
                   help='PAL: post-demod chroma low-pass (the attic comb\'s '
                        'FilterIQ capability, off by default)')
    p.add_argument('-F', '--no-opticalflow', action='store_true',
                   help='dim 3: K-map motion gate instead of Farneback '
                        'optical flow (comb -F)')
    p.add_argument('-8', '--write8bit', action='store_true',
                   dest='write8bit', help='8-bit RGB output')
    p.add_argument('-W', '--wide', action='store_true',
                   help='full 910-dot width')
    p.add_argument('-B', '--bw', action='store_true', help='B&W output')
    p.add_argument('--pulldown', action='store_true',
                   help='reassemble 3:2 pulldown film frames')
    p.add_argument('-b', '--brightness', type=float, default=None)
    p.add_argument('-I', '--black-ire', type=float, default=None)
    p.add_argument('-n', '--nr-y', type=float, default=None)
    p.add_argument('-N', '--nr-c', type=float, default=None)
    p.add_argument('-c', '--threedcore', type=float, default=None)
    p.add_argument('-r', '--threedrange', type=float, default=None)
    p.add_argument('--no-cx', action='store_true',
                   help='skip CX expansion of the analog audio')
    p.add_argument('--no-audio', action='store_true',
                   help='no audio output')
    p.add_argument('--batch', type=int, default=16,
                   help='speculative field-batch size (framer pipeline)')
    p.add_argument('--comb-batch', type=int, default=8,
                   help='frames per comb window')
    p.add_argument('--depth', type=int, default=3,
                   help='comb windows whose RGB is not yet on the host')
    p.add_argument('--segment-mb', type=int, default=512,
                   help='device-resident capture window, MB of 16-bit '
                        'samples')
    p.add_argument('--raw', action='store_true',
                   help='write raw .rgb even when ffmpeg is available')
    p.add_argument('--efm', action='store_true',
                   help='also decode the EFM digital-audio track to '
                        '<out>.efm.pcm (+ <out>.subcode.log)')
    p.add_argument('--device', default='cuda',
                   help='torch device to run on (default cuda; pass '
                        '"--device cpu" to run on the CPU)')
    p.add_argument('-q', '--quiet', action='store_true')
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    from ld_decode_tpu_torch.utils import log
    log.configure_from_flags(quiet=args.quiet, debug=False)

    from ld_decode_tpu_torch.audio.cx import CXExpander
    from ld_decode_tpu_torch.comb.batch import (CombWindows, NTSCCombBatch,
                                                PALCombBatch)
    from ld_decode_tpu_torch.comb.comb_pal import CombPALConfig
    from ld_decode_tpu_torch.comb.comb_ntsc import (CombConfig,
                                                    PulldownAssembler)
    from ld_decode_tpu_torch.io import loaders as L
    from ld_decode_tpu_torch.io.export_sink import VideoSink
    from ld_decode_tpu_torch.ops import filters as F
    from ld_decode_tpu_torch.tbc import framer as FR
    from ld_decode_tpu_torch.utils.device import resolve
    from ld_decode_tpu_torch.utils.params import DecoderConfig

    device = resolve(args.device, hint='--device cpu')
    cfg = DecoderConfig(system='PAL' if args.pal else 'NTSC', freq_mhz=40.0)
    bank = F.make_demod_bank(cfg, dtype=np.complex64, device=device)
    loader = L.loader_for_path(args.infile)
    samples_per_frame = int(cfg.freq_hz / cfg.sys.fps) + 1

    fd = open(args.infile, 'rb')
    framer = FR.Framer(cfg, bank, loader, batch=max(args.batch, 2),
                       segment_samples=args.segment_mb * (1 << 20) // 2,
                       device=device, fetch_picture=False)

    if args.seek >= 0:
        nextsample = FR.findframe(fd, framer, args.seek,
                                  args.start * samples_per_frame)
        if nextsample is None:
            log.critical('SEEK ERROR: unable to find a usable frame')
            return 1
    else:
        nextsample = args.start * samples_per_frame
    start_first = nextsample              # EFM span start

    # ----- comb (batched; same emission protocol as ldchain_tpu)
    Y, X = cfg.sys.frame_lines, cfg.sys.outlinelen
    kw = dict(dim=args.dim, bw=args.bw)
    if args.brightness is not None:
        kw['brightness'] = args.brightness
    if args.black_ire is not None:
        kw['black_ire'] = args.black_ire
    if args.nr_y is not None:
        kw['nr_y'] = args.nr_y
    if args.pal:
        if args.threedcore is not None:
            kw['p_3dcore'] = args.threedcore
        if args.threedrange is not None:
            kw['p_3drange'] = args.threedrange
        if args.no_pilot_notch:
            kw['pilot_notch'] = False
        if args.pal_colorlpf:
            kw['colorlpf'] = True
        pcfg = CombPALConfig(**kw)
        comb = PALCombBatch(pcfg, out8=args.write8bit, device=device,
                            graphs=framer.graphs)
        width, height, fps = X, pcfg.linesout, '25'
    else:
        kw.update(wide=args.wide, opticalflow=not args.no_opticalflow)
        if args.nr_c is not None:
            kw['nr_c'] = args.nr_c
        if args.threedcore is not None:
            kw['of_3dcore' if not args.no_opticalflow
               else 'p_3dcore'] = args.threedcore
        if args.threedrange is not None:
            kw['of_3drange' if not args.no_opticalflow
               else 'p_3drange'] = args.threedrange
        comb = NTSCCombBatch(CombConfig(**kw), out8=args.write8bit,
                             device=device, graphs=framer.graphs)
        width = X if args.wide else 744
        height = 480
        fps = '24000/1001' if args.pulldown else '30000/1001'

    audio_path = args.out + '.audio.pcm'
    out_audio = None if args.no_audio else open(audio_path, 'wb')
    sink = VideoSink(args.out, width, height, fps, write8bit=args.write8bit,
                     force_raw=args.raw, quiet_ffmpeg=True)
    # PAL frames carry no pulldown words (and its flush tail has none)
    pulldown = PulldownAssembler() if args.pulldown and not args.pal \
        else None
    cx = CXExpander(device=device)

    def emit(rgb, words):
        if args.length is not None and sink.nframes >= args.length:
            return
        if pulldown is not None:
            for film, _code in pulldown.process(rgb, words):
                sink.write(film)
        else:
            sink.write(rgb)

    # ----- the chain loop: frames accumulate on the device; every
    # comb-batch frames one comb window runs, and up to --depth windows
    # keep their RGB on the device (its copy to the host in flight) while
    # the next frames decode
    windows = CombWindows(comb, args.comb_batch, args.depth, emit)
    first = True
    decoded = 0
    try:
        while args.length is None or sink.nframes < args.length:
            combined, audio, nextsample, fields = framer.readframe(
                fd, nextsample, first)
            first = False
            if combined is None:
                break
            decoded += 1
            windows.push(combined.reshape(Y, X))
            # -l: the audio of the first N decoded frames only
            if args.length is not None and decoded > args.length:
                continue
            if audio is not None and out_audio is not None:
                pcm = np.asarray(audio).ravel()
                out = cx.process(pcm) if not args.no_cx \
                    else (pcm.astype(np.int64) + 32768).astype(np.uint16)
                out_audio.write((out.astype(np.int32) - 32768
                                 ).astype('<i2').tobytes())
        windows.drain()
        if args.efm:
            framer.close()                # the pass below reads the file
            from ld_decode_tpu_torch.audio import efm as EFM
            nspan = (args.length + 2 if args.length is not None
                     else max(sink.nframes + 8, 4)) * samples_per_frame
            dec = EFM.extract_digital_audio(loader, fd, start_first, nspan,
                                            cfg.freq_hz)
            if dec is not None:
                EFM.write_digital_audio_outputs(dec, args.out)
                print(f'EFM: {dec["samples"].shape[0]} digital-audio '
                      f'samples, {len(dec["q"])} valid Q packets',
                      file=sys.stderr)
    finally:
        framer.close()                    # no read ahead outlives the file
        fd.close()
        sink.close()
        if out_audio is not None:
            out_audio.close()
    if out_audio is not None:
        # the audio is produced during the decode, so the mp4 gets it in
        # a second stream-copy remux
        sink.remux_audio(audio_path)
    print(f'wrote {sink.nframes} frames', file=sys.stderr)
    return 0


if __name__ == '__main__':
    sys.exit(main())
