#!/usr/bin/env python
"""One-command frame preview of the PyTorch port: seek, decode ONE frame,
comb, write a PNG.

The port of ldview_tpu.py (the reference's `ldview` script family,
attic2/ldview: `lddecode.py -s 1 -S $1 $2 | ntsc - | comb -d 3 -L -m`).
It seeks with findframe and decodes the frame through the sequential
Framer (batch 1, the file read by a loader), then combs it with a static
ring (the same frame three times: no motion, a pure temporal comb) and
writes an 8-bit PNG, or raw RGB48 (<out>.rgb) without pillow.  Runs on the
CUDA device (--device, default `cuda`); without one it fails unless
`--device cpu` asks for the CPU.

    python ldview_torch.py capture.lds 5000 preview.png        # CAV frame
    python ldview_torch.py -s 120 capture.lds - preview.png    # 120th frame
"""

import argparse
import sys

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser(description='decode one frame to an image '
                                            '(PyTorch port)')
    p.add_argument('infile', help='raw RF capture (.lds/.r30/.r16/.raw)')
    p.add_argument('frame', help='CAV frame number to seek to, or "-" '
                                 'to use --start only')
    p.add_argument('out', help='output image (.png with pillow, else '
                               'raw RGB48 written as <out>.rgb)')
    p.add_argument('-s', '--start', type=int, default=0,
                   help='rough start frame for the seek / plain decode')
    p.add_argument('-p', '--pal', action='store_true')
    p.add_argument('-d', '--dim', type=int, default=3,
                   help='comb dimensions (default 3, like ldview)')
    p.add_argument('-B', '--bw', action='store_true', help='B&W output')
    p.add_argument('-W', '--wide', action='store_true',
                   help='full-width output (no active-area crop)')
    p.add_argument('--device', default='cuda',
                   help='torch device to decode on (default cuda; pass '
                        '"--device cpu" to run on the CPU)')
    return p.parse_args(argv)


def main(argv=None, *, graphs: bool = False):
    """graphs: whether the decode and the comb replay CUDA graphs.  The
    CLI runs eagerly: one frame runs each program once or twice, and its
    captures cost more than they save (measured in `chip_smoke.py`, which
    passes graphs=True for the comparison; README)."""
    args = parse_args(argv)

    from ld_decode_tpu_torch.io import loaders as L
    from ld_decode_tpu_torch.ops import filters as F
    from ld_decode_tpu_torch.tbc import framer as FR
    from ld_decode_tpu_torch.utils.device import resolve
    from ld_decode_tpu_torch.utils.params import DecoderConfig

    device = resolve(args.device, hint='--device cpu')
    cfg = DecoderConfig(system='PAL' if args.pal else 'NTSC', freq_mhz=40.0)
    bank = F.make_demod_bank(cfg, dtype=np.complex64, device=device)
    loader = L.loader_for_path(args.infile)
    samples_per_frame = int(cfg.freq_hz / cfg.sys.fps) + 1

    with open(args.infile, 'rb') as fd:
        framer = FR.Framer(cfg, bank, loader, batch=1, device=device,
                           graphs=graphs)
        sample = args.start * samples_per_frame
        first = True
        if args.frame != '-':
            sample = FR.findframe(fd, framer, int(args.frame), sample)
            if sample is None:
                print('SEEK ERROR: unable to find a usable frame',
                      file=sys.stderr)
                return 1
            first = False               # the seek already field-synced
        combined, _audio, _next, _fields = framer.readframe(fd, sample, first)
    if combined is None:
        print('DECODE ERROR: no frame at that position', file=sys.stderr)
        return 1
    print(f'frame {framer.vbi.get("framenr")}', file=sys.stderr)

    if args.pal:
        from ld_decode_tpu_torch.comb.comb_pal import CombPALConfig, PALComb
        comb = PALComb(CombPALConfig(dim=args.dim, bw=args.bw), device=device)
    else:
        from ld_decode_tpu_torch.comb.comb_ntsc import CombConfig, NTSCComb
        comb = NTSCComb(CombConfig(dim=args.dim, bw=args.bw, wide=args.wide,
                                   opticalflow=False), device=device,
                        graphs=graphs)
    # dim-3 wants a 3-frame ring; a static ring of the same frame is
    # exact for a single-frame preview (no motion -> pure temporal comb)
    rgb = comb.process(combined)
    while rgb is None:
        rgb = comb.process(combined)

    try:
        from PIL import Image
    except ImportError:
        Image = None
    if Image is not None and args.out.lower().endswith('.png'):
        img = (rgb.astype(np.uint32) * 255 // 65535).astype(np.uint8)
        Image.fromarray(img, 'RGB').save(args.out)
        print(f'wrote {args.out} ({img.shape[1]}x{img.shape[0]})',
              file=sys.stderr)
    else:
        path = args.out if args.out.lower().endswith('.rgb') \
            else args.out + '.rgb'
        rgb.astype('<u2').tofile(path)
        print(f'wrote {path} (rgb48le {rgb.shape[1]}x{rgb.shape[0]})',
              file=sys.stderr)
    return 0


if __name__ == '__main__':
    sys.exit(main())
