"""Frame line-0 metadata words (.tbc format spec, reference ld-decoder.h:227-252).

The PyTorch port's copy of ld_decode_tpu/vbi/metadata.py (the port imports
nothing of the JAX package); tests/test_torch_hostcopies.py holds the two
equal.

The reference's C++ TBC writes these (app/tbc/tbc.cpp:1653-1725); its Python
pipeline never did, leaving comb's pulldown inputs zeroed.  We implement the
full spec:

  words 0-5 : decoded VBI data (three 24-bit Philips codes, high word first)
  word 6    : flags — bit0 CLV, bit2 CAV frame on even field, bit3 CAV frame
              on odd field, bit4 CX enabled, bit8/9 white flag odd/even
  word 7    : frame # (CAV and CLV; CLV converted to frames)
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

FRAME_INFO_CLV = 0x1
FRAME_INFO_CAV_EVEN = 0x4
FRAME_INFO_CAV_ODD = 0x8
FRAME_INFO_CX = 0x10
FRAME_INFO_WHITE_ODD = 0x100
FRAME_INFO_WHITE_EVEN = 0x200


def nibbles_to_code(nibbles: Optional[List[int]]) -> int:
    if not nibbles:
        return 0
    h = 0
    for n in nibbles:
        h = (h << 4) | (n & 0xF)
    return h


def status_cx_enabled(status: Optional[int]) -> bool:
    """CX flag from the programme status code: 0x8DCxxx codes signal CX
    on, 0x8BAxxx off (reference app/tbc/interpretvbi.cpp:167:
    isCxOn = (line16 & 0x0DC000) == 0x0DC000; same test as
    vbi/iec60857.py's 'cx' field)."""
    if status is None:
        return False
    return (status & 0x0DC000) == 0x0DC000


def white_flag(dspicture: np.ndarray, outlinelen: int, linecount: int,
               line: int = 11, out_scale: float = 51200.0 / 140.0,
               offset: int = 1024, vsync_ire: float = -40.0) -> bool:
    """>80 IRE for >=200 dots on the white-flag line
    (reference app/tbc/tbc.cpp:1633-1644)."""
    if dspicture is None or line >= linecount:
        return False
    thresh = (80.0 - vsync_ire) * out_scale + offset
    # scan a small row window: the field-line-11 convention differs by one
    # between the implementations (picture rows are lines-1..linecount)
    for r in range(max(line - 3, 0), line + 1):
        row = dspicture[r * outlinelen:(r + 1) * outlinelen]
        if int((row[2:] > thresh).sum()) >= 200:
            return True
    return False


def frame_metadata_words(fields, vbi: Dict, cfg) -> np.ndarray:
    """The 16 uint16 samples written into the frame's first line."""
    words = np.zeros(16, np.uint16)

    codes = []
    for f in (fields[0], fields[1]):
        if f is None or not f.linecode:
            continue
        for l in sorted(f.linecode):
            c = nibbles_to_code(f.linecode[l])
            if c:
                codes.append(c)
    for i, c in enumerate(codes[:3]):
        words[i * 2] = (c >> 16) & 0xFFFF
        words[i * 2 + 1] = c & 0xFFFF

    flags = 0
    if vbi.get('isclv'):
        flags |= FRAME_INFO_CLV
    elif vbi.get('framenr') is not None:
        top_has = fields[0] is not None and fields[0].vbi \
            and fields[0].vbi.get('framenr') is not None
        flags |= FRAME_INFO_CAV_ODD if top_has else FRAME_INFO_CAV_EVEN
    if status_cx_enabled(vbi.get('status')):
        flags |= FRAME_INFO_CX

    W = cfg.sys.outlinelen
    scale = ((0xc800 - 0x0400) if cfg.system == 'NTSC'
             else (0xd300 - 0x0100)) / (100 - cfg.sys.vsync_ire)
    off = 1024 if cfg.system == 'NTSC' else 256

    def field_white(f) -> bool:
        if f is None:
            return False
        if f.dspicture is None:
            # device-chain mode: the picture never reaches the host —
            # use the bit the fused pipeline computed on device (same
            # row window / threshold; fused.pipeline_finish)
            return bool(getattr(f, 'white_flag', None))
        return white_flag(f.dspicture, W, f.linecount, 11, scale, off,
                          cfg.sys.vsync_ire)

    if field_white(fields[0]):
        flags |= FRAME_INFO_WHITE_ODD
    if field_white(fields[1]):
        flags |= FRAME_INFO_WHITE_EVEN

    words[12] = (flags >> 16) & 0xFFFF
    words[13] = flags & 0xFFFF

    framenr = vbi.get('framenr') or 0
    words[14] = (int(framenr) >> 16) & 0xFFFF
    words[15] = int(framenr) & 0xFFFF
    return words
