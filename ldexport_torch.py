#!/usr/bin/env python
"""Packaging front-end of the PyTorch port: .tbc (+ .pcm) -> RGB48 video
(+ CX-expanded audio).

The second step of the two-step path (lddecode_torch.py, then this), the
port of ldexport_tpu.py and of the reference's `encode-ntsc` /
`encode-pal` pipelines (`cat x.tbc | comb -d3 | ffmpeg ...`): runs the comb
chroma decoder and the CX expander and either pipes rgb48le into ffmpeg
(when available) or writes raw .rgb / .pcm files in the stream formats the
reference scripts used (rgb48, 744x480 @29.97 NTSC interlaced).

Same arguments as ldexport_tpu.py plus --device: the comb and the
file-level CX run on the CUDA device (default `cuda`); without one it fails
unless `--device cpu` asks for the CPU.  NTSC combs frame by frame through
the streaming NTSCComb (the debug surfaces -D, -k and --debug-line need
it), or --comb-batch N frames a window through NTSCCombBatch, fed and
collected one window apart; PAL (--pal) through PALComb or PALCombBatch.
-a CX-expands the .pcm in 1 MB chunks, whose envelopes run the
block-parallel evaluation on the device (kernel K3).

As in ldexport_tpu.py, -l stops the video after N frames while the audio is
expanded in full before the video starts: the .pcm runs past the video.
This is not ldchain's `-l` overrun, which the port fixed (ROADMAP.md Queue
3): the .pcm is an input stream, and the .tbc carries no frame's audio
count to cut it at.  -t (NN-comb training mode, reference comb -t) forces
-d 3 and per-frame images, collects up to 128 raw .tbc frames (NTSC only)
and writes their 3D-comb-supervised training pairs to <out>.train.npz
(models/nn_comb.py, on the same device), which either package's
train_nn_comb(data=...) reads.
"""

import argparse
import sys

import numpy as np

TRAIN_FRAMES = 128   # raw frames kept for -t (~122 MB; more adds nothing
                     # for the small NN)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description='Package decoded .tbc into video '
                                            '(PyTorch port)')
    p.add_argument('intbc', help='input .tbc file')
    p.add_argument('out', help='output base name (.mp4 with ffmpeg, else .rgb)')
    p.add_argument('--pal', action='store_true')
    p.add_argument('-p', '--pulldown', action='store_true',
                   help='reassemble 3:2 pulldown film frames from white '
                        'flag / CAV frame # (NTSC; reference comb -p)')
    p.add_argument('-d', '--dim', type=int, default=3,
                   help='comb dimensions (1/2/3, default 3 like encode-ntsc)')
    p.add_argument('-a', '--audio', default=None, help='input .pcm (48kHz s16)')
    p.add_argument('--no-cx', action='store_true',
                   help='skip CX expansion of the audio')
    p.add_argument('-B', '--bw', action='store_true', help='B&W output')
    p.add_argument('-W', '--wide', action='store_true',
                   help='full 910-dot width (no crop)')
    p.add_argument('--pal-colorlpf', action='store_true',
                   help='PAL: enable the post-demod chroma LPF (the '
                        'attic comb-pal f_colorlpf toggle; off by '
                        'default like the reference)')
    p.add_argument('--no-pilot-notch', action='store_true',
                   help='PAL: keep the 3.75 MHz pilot band in the '
                        'picture (default: notch it)')
    p.add_argument('-l', '--length', type=int, default=None,
                   help='max frames')
    # comb tunables (reference comb-ntsc.cxx:972-1068 getopt set)
    p.add_argument('-F', '--no-opticalflow', action='store_true',
                   help='dim 3: use the YIQ-diff K-map motion gate '
                        'instead of Farneback optical flow (comb -F)')
    p.add_argument('-L', '--no-colorlpf', action='store_true',
                   help='disable the post chroma LPF (comb -L toggle)')
    p.add_argument('-Q', '--no-colorlpf-hq', action='store_true',
                   help='low-quality chroma LPF (comb -Q toggle)')
    p.add_argument('-A', '--no-adaptive2d', action='store_true',
                   help='disable adaptive 2D weighting (comb -a toggle; '
                        '-a is taken by --audio here)')
    p.add_argument('-c', '--threedcore', type=float, default=None,
                   help='3D motion-gate core threshold (comb -c)')
    p.add_argument('--threedrange', type=float, default=None,
                   help='3D motion-gate range (comb -r)')
    p.add_argument('-b', '--brightness', type=float, default=None,
                   help='output brightness scale (comb -b)')
    p.add_argument('-I', '--black-ire', type=float, default=None,
                   help='black level IRE, e.g. 0 or 7.5 (comb -I; '
                        'encode-ntsc uses -I0)')
    p.add_argument('-n', '--nr-y', type=float, default=None,
                   help='luma noise-reduction level, IRE (comb -n)')
    p.add_argument('-N', '--nr-c', type=float, default=None,
                   help='chroma noise-reduction level, IRE (comb -N)')
    p.add_argument('-v', '--vbi-area', action='store_true',
                   help='output the full field height incl. VBI area '
                        '(comb -v; B&W rows above firstline)')
    p.add_argument('-8', '--write8bit', action='store_true',
                   dest='write8bit',
                   help='emit 8-bit RGB instead of RGB48 (comb -8)')
    p.add_argument('--write-images', action='store_true',
                   help='write each frame as <out>_<n>.rgb instead of '
                        'one stream (comb -f image mode)')
    p.add_argument('-t', '--training', action='store_true',
                   help='NN-comb training mode (reference comb -t): '
                        'forces -d 3 and per-frame images, writes '
                        '<out>.train.npz')
    p.add_argument('--comb-batch', type=int, default=1,
                   help='comb N frames per device call (comb/batch.py); '
                        'debug flags force the frame-at-a-time comb')
    p.add_argument('-D', '--debug2d', action='store_true',
                   help='render the 2D-3D chroma difference over gray and '
                        'print per-line/total MSE+ME (reference comb -D; '
                        'forces -d 3)')
    p.add_argument('-k', '--show-k', action='store_true',
                   help='render the K-map (combk[dim-1]) as grayscale '
                        '(reference comb -k)')
    p.add_argument('--debug-line', type=int, default=None,
                   help='dump + black out TBC line N+25 (reference comb -l)')
    p.add_argument('--device', default='cuda',
                   help='torch device to comb and expand on (default cuda; '
                        'pass "--device cpu" to run on the CPU)')
    return p.parse_args(argv)


def _pal_comb(args, device):
    from ld_decode_tpu_torch.comb.comb_pal import (PAL_X, PAL_Y, PALComb,
                                                   CombPALConfig)
    pkw = dict(dim=args.dim, bw=args.bw)
    if args.brightness is not None:
        pkw['brightness'] = args.brightness
    if args.black_ire is not None:
        pkw['black_ire'] = args.black_ire
    if args.nr_y is not None:
        pkw['nr_y'] = args.nr_y
    if args.no_adaptive2d:
        pkw['adaptive2d'] = False
    if args.threedcore is not None:
        pkw['p_3dcore'] = args.threedcore
    if args.threedrange is not None:
        pkw['p_3drange'] = args.threedrange
    if args.vbi_area:
        pkw['linesout'] = PAL_Y
        pkw['firstline'] = 0
    if args.no_pilot_notch:
        pkw['pilot_notch'] = False
    if args.pal_colorlpf:
        pkw['colorlpf'] = True
        pkw['colorlpf_hq'] = not args.no_colorlpf_hq
    comb = PALComb(CombPALConfig(**pkw), device=device)
    return comb, (PAL_X, PAL_Y), (PAL_X, pkw.get('linesout', 576)), '25'


def _ntsc_comb(args, device):
    from ld_decode_tpu_torch.comb.comb_ntsc import (IN_X, IN_Y, CombConfig,
                                                    NTSCComb)
    nkw = dict(
        dim=3 if args.debug2d else args.dim, bw=args.bw, wide=args.wide,
        opticalflow=not args.no_opticalflow,
        colorlpf=not args.no_colorlpf,
        colorlpf_hq=not args.no_colorlpf_hq,
        adaptive2d=not args.no_adaptive2d,
        debug2d=args.debug2d, showk=args.show_k,
        debugline=args.debug_line if args.debug_line is not None
        else -10000)
    if args.brightness is not None:
        nkw['brightness'] = args.brightness
    if args.black_ire is not None:
        nkw['black_ire'] = args.black_ire
    if args.nr_y is not None:
        nkw['nr_y'] = args.nr_y
    if args.nr_c is not None:
        nkw['nr_c'] = args.nr_c
    # -c/-r tune whichever 3D gate is active (the reference keeps
    # separate defaults per mode, comb-ntsc.cxx:1070-1078)
    if args.threedcore is not None:
        nkw['of_3dcore' if not args.no_opticalflow
            else 'p_3dcore'] = args.threedcore
    if args.threedrange is not None:
        nkw['of_3drange' if not args.no_opticalflow
            else 'p_3drange'] = args.threedrange
    if args.vbi_area:
        nkw['linesout'] = IN_Y
    comb = NTSCComb(CombConfig(**nkw), device=device)
    width = IN_X if args.wide else 744
    fps = '24000/1001' if args.pulldown else '30000/1001'
    return comb, (IN_X, IN_Y), (width, nkw.get('linesout', 480)), fps


def main(argv=None):
    args = parse_args(argv)
    if args.training:
        # reference -t: training mode forces dim 3 + image output
        # (comb-ntsc.cxx:1057-1061)
        args.dim = 3
        args.write_images = True
    from ld_decode_tpu_torch.audio.cx import CXExpander
    from ld_decode_tpu_torch.io.export_sink import VideoSink
    from ld_decode_tpu_torch.utils.device import resolve

    device = resolve(args.device, hint='--device cpu')
    comb, (in_x, in_y), (width, height), fps = (
        _pal_comb if args.pal else _ntsc_comb)(args, device)
    frame_bytes = in_x * in_y * 2

    # audio: CX expand to a side .pcm
    audio_path = None
    if args.audio:
        cx = CXExpander(device=device)
        audio_path = args.out + '.audio.pcm'
        with open(args.audio, 'rb') as fa, open(audio_path, 'wb') as fo:
            while True:
                buf = fa.read(1 << 20)
                if not buf:
                    break
                pcm = np.frombuffer(buf[:len(buf) // 4 * 4], '<i2')
                out = cx.process(pcm) if not args.no_cx \
                    else (pcm.astype(np.int64) + 32768).astype(np.uint16)
                fo.write((out.astype(np.int32) - 32768
                          ).astype('<i2').tobytes())

    sink = VideoSink(args.out, width, height, fps,
                     write8bit=args.write8bit, audio_path=audio_path,
                     write_images=args.write_images)

    pulldown = None
    if args.pulldown and not args.pal:
        from ld_decode_tpu_torch.comb.comb_ntsc import PulldownAssembler
        pulldown = PulldownAssembler()

    # -t: the raw .tbc frames for the training-pair writer
    train_frames = [] if args.training and not args.pal else None

    def keep_for_training(frames):
        if train_frames is not None:
            train_frames.extend(frames[:TRAIN_FRAMES - len(train_frames)])

    def emit(rgb, words):
        if args.length is not None and sink.nframes >= args.length:
            return
        if args.write8bit and rgb.dtype != np.uint8:
            # comb -8: top byte only (the batched combs cut it on the
            # device)
            rgb = (rgb >> 8).astype(np.uint8)
        if pulldown is not None:
            for film, _code in pulldown.process(rgb, words):
                sink.write(film)
        else:
            sink.write(rgb)

    use_batch = (args.comb_batch > 1
                 and not (args.debug2d or args.show_k
                          or args.debug_line is not None))
    if use_batch and args.pal:
        from ld_decode_tpu_torch.comb.batch import PALCombBatch
        comb = PALCombBatch(comb.cfg, out8=args.write8bit, device=device,
                            graphs=comb.graphs)
    elif use_batch:
        from ld_decode_tpu_torch.comb.batch import NTSCCombBatch
        comb = NTSCCombBatch(comb.cfg, out8=args.write8bit, device=device,
                             graphs=comb.graphs)

    with open(args.intbc, 'rb') as f:
        if use_batch:
            # windowed: feed window k while window k-1's RGB copies
            pending = None
            while args.length is None or sink.nframes < args.length:
                raw = f.read(frame_bytes * args.comb_batch)
                n = len(raw) // frame_bytes
                if n:
                    win = np.frombuffer(raw[:n * frame_bytes],
                                        np.uint16).reshape(n, -1)
                    keep_for_training(win)
                    handle = comb.feed(win)
                if pending is not None:
                    for rgb, w in zip(*comb.collect(pending)):
                        emit(rgb, w)
                if n == 0:
                    pending = None
                    break
                pending = handle
                if n < args.comb_batch:
                    break
            if pending is not None:
                for rgb, w in zip(*comb.collect(pending)):
                    emit(rgb, w)
        else:
            while args.length is None or sink.nframes < args.length:
                buf = f.read(frame_bytes)
                if len(buf) < frame_bytes:
                    break
                frame = np.frombuffer(buf, np.uint16)
                keep_for_training([frame])
                rgb = comb.process(frame)
                if rgb is None:          # 3D warmup
                    continue
                if getattr(comb, 'last_debug2d', None) is not None:
                    d = comb.last_debug2d
                    for li in range(36, 524):
                        print(f'{li} {d["mse_line"][li]:.6g} ME '
                              f'{d["me_line"][li]:.6g}', file=sys.stderr)
                    print(f'TOTAL MSE {d["mse"]:.6g} ME {d["me"]:.6g}',
                          file=sys.stderr)
                emit(rgb, getattr(comb, 'last_frame_words', None))

    if hasattr(comb, 'flush'):
        tail = comb.flush()
        if tail is not None:
            if args.write8bit and tail.dtype != np.uint8:
                tail = (tail >> 8).astype(np.uint8)
            sink.write(tail)

    sink.close()
    if train_frames is not None and len(train_frames) >= 3:
        from ld_decode_tpu_torch.models.nn_comb import write_training_file
        # eager pair windows: -t makes at most 16 of them, too few to repay
        # a capture (chip_smoke.py phase 19 times the pairs both ways)
        npairs = write_training_file(np.stack(train_frames),
                                     args.out + '.train.npz', device=device,
                                     graphs=False)
        print(f'wrote {npairs} training pairs to {args.out}.train.npz',
              file=sys.stderr)
    print(f'wrote {sink.nframes} frames', file=sys.stderr)
    return 0


if __name__ == '__main__':
    sys.exit(main())
