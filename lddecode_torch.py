#!/usr/bin/env python
"""CLI front-end of the PyTorch port: raw RF LaserDisc capture -> <out>.tbc
(4fsc 16-bit frames) + <out>.pcm (16-bit 48 kHz stereo).

Same arguments as lddecode_tpu.py, plus --device.  Decodes on the CUDA device (--device,
default `cuda`); without one it fails unless `--device cpu` asks for the
CPU.  NTSC and PAL (-p); --efm also pulls the EFM digital audio out of the
capture on the host (<out>.efm.pcm + <out>.subcode.log).  --batch 1 decodes
field by field (the JAX package's sequential path, FieldDecoder.process on
each field's window of the file); larger batches run the speculative
batched pipeline over a sliding device-resident segment of the file.
"""

import argparse
import os
import sys

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description='Extract audio and video from raw RF laserdisc captures '
                    '(PyTorch port)')
    p.add_argument('infile', type=str, help='source file')
    p.add_argument('outfile', type=str, help='base name for destination files')
    p.add_argument('-s', '--start', type=int, default=0,
                   help='rough jump to frame n of capture (default 0)')
    p.add_argument('-S', '--seek', type=int, default=-1,
                   help='seek to frame n of capture')
    p.add_argument('-E', '--end', type=int, default=-1,
                   help='cutting: last frame')
    p.add_argument('-l', '--length', type=int, default=None,
                   help='limit length to n frames')
    p.add_argument('-p', '--pal', action='store_true',
                   help='source is in PAL format')
    p.add_argument('-n', '--ntsc', action='store_true',
                   help='source is in NTSC format')
    p.add_argument('-c', '--cut', action='store_true',
                   help='cut (to r16) instead of decode')
    p.add_argument('--batch', type=int, default=8,
                   help='speculative field-batch size for the device '
                        'pipeline (1: the sequential decode, one field '
                        'at a time)')
    p.add_argument('--segment-mb', type=int, default=512,
                   help='device-resident capture window, MB of 16-bit '
                        'samples (decoding runs inside a sliding segment '
                        'of the file)')
    p.add_argument('--f64', action='store_true',
                   help='run the filter bank at float64')
    p.add_argument('--despackle', action='store_true',
                   help='conceal laser-rot dropouts in the output picture')
    p.add_argument('-r', '--rot', type=float, default=40.0,
                   help='laser-rot detection level for --despackle '
                        '(IRE margin outside 0..100)')
    p.add_argument('-f', '--flip', action='store_true',
                   help='flip video fields (swap even/odd weave order)')
    p.add_argument('-z', '--freeze', action='store_true',
                   help='freeze-frame: decode one frame and repeat it '
                        'for the requested length')
    p.add_argument('-m', '--bff', action='store_true',
                   help='magnetic video mode: pair frames bottom-field '
                        'first (VHS-style)')
    p.add_argument('-A', '--audio-only', action='store_true',
                   help='output only audio (no .tbc file)')
    p.add_argument('--efm', action='store_true',
                   help='also decode the EFM digital-audio track to '
                        '<out>.efm.pcm (+ <out>.subcode.log with the '
                        'CRC-valid Q-channel packets)')
    p.add_argument('--device', default='cuda',
                   help='torch device to decode on (default cuda; pass '
                        '"--device cpu" to run on the CPU)')
    p.add_argument('--no-graphs', dest='graphs', action='store_false',
                   help='run the device programs eagerly instead of '
                        'replaying them as CUDA graphs on the card')
    p.add_argument('-q', '--quiet', action='store_true',
                   help='warnings and errors only')
    p.add_argument('-d', '--debug', action='store_true',
                   help='debug output (per-frame progress percentage, and '
                        'at exit the time spent in each span of the '
                        'decode)')
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    from ld_decode_tpu_torch.utils import log
    log.configure_from_flags(quiet=args.quiet, debug=args.debug)
    try:
        return decode(args)
    finally:
        log_spans()


def log_spans():
    """Debug: each span's count, total and self seconds
    (utils/spans.py), slowest first, the capture widenings by route
    (tbc/cuda_widen.py) and the .lds unpacks split across threads
    (io/loaders.py)."""
    from ld_decode_tpu_torch.io import loaders
    from ld_decode_tpu_torch.tbc import cuda_widen
    from ld_decode_tpu_torch.utils import log, spans
    for name, (n, total, own) in sorted(spans.totals().items(),
                                        key=lambda kv: -kv[1][1]):
        log.debug(f'span {name}: {n} calls, {total:.3f} s total, '
                  f'{own:.3f} s self')
    log.debug(f'capture widening: {cuda_widen.routes["card"]} on the card '
              f'({cuda_widen.widen.launches} launches), '
              f'{cuda_widen.routes["host"]} on the host')
    log.debug(f'.lds unpack: {loaders.unpack_threads["split"]} split across '
              f'threads (the last on {loaders.unpack_threads["threads"]})')


def decode(args):
    from ld_decode_tpu_torch.utils import log
    if args.pal and args.ntsc:
        log.critical('Can only be PAL or NTSC')
        return 1

    from ld_decode_tpu_torch.io import loaders as L
    from ld_decode_tpu_torch.utils.device import resolve
    from ld_decode_tpu_torch.utils.params import DecoderConfig
    from ld_decode_tpu_torch.ops import filters as F
    from ld_decode_tpu_torch.tbc import framer as FR

    device = resolve(args.device, hint='--device cpu')
    cfg = DecoderConfig(system='PAL' if args.pal else 'NTSC', freq_mhz=40.0)
    bank = F.make_demod_bank(
        cfg, dtype=np.complex128 if args.f64 else np.complex64,
        device=device)
    loader = L.loader_for_path(args.infile)

    samples_per_frame = int(cfg.freq_hz / cfg.sys.fps) + 1
    bytes_per_sample = L.bytes_per_sample_for_path(args.infile)
    bytes_per_frame = int(samples_per_frame * bytes_per_sample)

    infile_size = os.path.getsize(args.infile)
    if (infile_size // bytes_per_frame - args.start) < 2:
        log.critical('start frame is past end of file')
        return 1
    num_frames = args.length if args.length is not None \
        else infile_size // bytes_per_frame - args.start

    with open(args.infile, 'rb') as fd:
        framer = FR.Framer(cfg, bank, loader, batch=max(args.batch, 1),
                           segment_samples=args.segment_mb * (1 << 20) // 2,
                           despackle=args.despackle, rot_level=args.rot,
                           flip_fields=args.flip, bff=args.bff,
                           device=device, graphs=args.graphs)

        if args.seek >= 0:
            nextsample = FR.findframe(fd, framer, args.seek,
                                      args.start * samples_per_frame)
            if nextsample is None:
                log.critical('SEEK ERROR: unable to find a usable frame')
                return 1
        else:
            nextsample = args.start * samples_per_frame
        first_sample = nextsample             # EFM span start (below)

        if args.cut:
            lastsample = FR.findframe(fd, framer, args.end, nextsample)
            lastsample += int(samples_per_frame * .25)
            with open(args.outfile + '.r16', 'wb') as outfile:
                for i in range(int(nextsample), int(lastsample), 16384):
                    n = min(16384, int(lastsample) - i)
                    data = loader(fd, i, n)
                    if data is None:
                        break
                    outfile.write(np.asarray(data, dtype=np.int16).tobytes())
            return 0

        out_video = None if args.audio_only \
            else open(args.outfile + '.tbc', 'wb')
        out_audio = open(args.outfile + '.pcm', 'wb')
        try:
            frozen = None
            for f in range(num_frames):
                if frozen is not None:
                    if out_video is not None:
                        out_video.write(frozen.tobytes())
                    continue
                combined, audio, nextsample, fields = framer.readframe(
                    fd, nextsample, f == 0)
                if combined is None:
                    if args.length is not None and f < num_frames - 1:
                        log.warning('end of file before requested frame '
                                    'count')
                    break
                log.info(f'frame {framer.vbi.get("framenr")}')
                if log.get_level() <= log.DEBUG:
                    log.progress(nextsample * bytes_per_sample, infile_size)
                if out_video is not None:
                    out_video.write(combined.tobytes())
                if audio is not None:
                    out_audio.write(audio.tobytes())
                if args.freeze:
                    frozen = combined
        finally:
            if out_video is not None:
                out_video.close()
            out_audio.close()

        if args.efm:
            # digital audio rides the composite below the video FM.  One
            # decode on the host over the frame span the video pass used:
            # the EFM frame stream and the CIRC interleave are continuous,
            # so the span loads whole
            from ld_decode_tpu_torch.audio import efm as EFM
            dec = EFM.extract_digital_audio(
                loader, fd, first_sample,
                (num_frames + 2) * samples_per_frame, cfg.freq_hz)
            if dec is None:
                log.critical('EFM: no samples readable at decode start')
                return 1
            EFM.write_digital_audio_outputs(dec, args.outfile)
            log.info(f'EFM: {dec["samples"].shape[0]} digital-audio '
                     f'samples, {len(dec["q"])} valid Q packets')

    return 0


if __name__ == '__main__':
    sys.exit(main())
