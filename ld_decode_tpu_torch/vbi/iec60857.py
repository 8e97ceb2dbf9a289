"""Full IEC 60857 VBI code interpretation.

The PyTorch port's copy of ld_decode_tpu/vbi/iec60857.py (the port imports
nothing of the JAX package); tests/test_torch_hostcopies.py holds the two
equal.

Port of the reference's C++ interpreter semantics
(reference app/tbc/interpretvbi.cpp:31-310): lead-in/out, user codes,
CAV/CLV discrimination, CAV picture number and stop code, chapter numbers,
CLV programme timecode and picture number, and the programme status code
(CX flag, disc size/side, teletext, digital video, sound mode table).

Reference bugs fixed here (each noted inline):
  * lead-out detection set the lead-IN flag (interpretvbi.cpp:62)
  * the CLV-detect alternative compared a 20-bit mask against a 28-bit
    constant, so it could never match (interpretvbi.cpp:87)
  * the audio-status weight for bit 8 re-tested x4 bit 1 instead of
    x4 bit 8 (interpretvbi.cpp:196-199)
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

SOUND_MODES = {
    0: 'stereo', 1: 'mono', 2: 'futureUse', 3: 'bilingual',
    4: 'stereo_stereo', 5: 'stereo_bilingual', 6: 'crossChannelStereo',
    7: 'bilingual_bilingual', 8: 'mono_dump', 9: 'mono_dump',
    10: 'futureUse', 11: 'mono_dump', 12: 'stereo_dump', 13: 'stereo_dump',
    14: 'bilingual_dump', 15: 'bilingual_dump',
}


@dataclass
class VbiInfo:
    disc_type: str = 'unknown'            # 'cav' | 'clv' | 'unknown'
    lead_in: bool = False
    lead_out: bool = False
    user_code: Optional[str] = None
    picture_number: Optional[int] = None
    picture_stop_code: bool = False
    chapter_number: Optional[int] = None
    clv_hours: Optional[int] = None
    clv_minutes: Optional[int] = None
    clv_seconds: Optional[int] = None
    clv_picture_number: Optional[int] = None
    status: dict = field(default_factory=dict)


def interpret_iec60857(line16: int, line17: int, line18: int) -> VbiInfo:
    """Interpret the three 24-bit VBI codes of one field."""
    v = VbiInfo()

    if (line17 & 0x88FFFF) == 0x88FFFF or (line18 & 0x88FFFF) == 0x88FFFF:
        v.lead_in = True
    if (line17 & 0x80EEEE) == 0x80EEEE or (line18 & 0x80EEEE) == 0x80EEEE:
        v.lead_out = True                  # (ref. bug: set lead_in)

    if (v.lead_in or v.lead_out) and (line16 & 0x80D000) == 0x80D000:
        x1 = (line16 & 0x0F0000) >> 16
        x345 = line16 & 0x000FFF
        if x1 <= 7:
            v.user_code = f'{x1:X}{x345:03X}'

    # CLV if a programme timecode or the CLV lead-in marker is present
    if ((line17 & 0xF0DD00) == 0xF0DD00 or line17 == 0x87FFFF
            or line18 == 0x87FFFF):       # (ref. bug: impossible mask)
        v.disc_type = 'clv'
    else:
        v.disc_type = 'cav'

    if v.disc_type == 'cav':
        for ln in (line17, line18):
            if (ln & 0xF00000) == 0xF00000:
                v.picture_number = ln & 0x0FFFFF
        for ln in (line16, line17):
            if (ln & 0x82CFFF) == 0x82CFFF:
                v.picture_stop_code = True
        if (line17 & 0x800DDD) == 0x800DDD:
            v.chapter_number = (line17 & 0x0FF000) >> 12
    if (line18 & 0x800DDD) == 0x800DDD:
        v.chapter_number = (line18 & 0x0FF000) >> 12

    if v.disc_type == 'clv':
        for ln in (line17, line18):
            if (ln & 0xF0DD00) == 0xF0DD00:
                v.clv_hours = (ln & 0x0F0000) >> 16
                v.clv_minutes = ln & 0x0000FF
        if (line16 & 0x80E000) == 0x80E000:
            x1 = (line16 & 0x0F0000) >> 16
            x3 = (line16 & 0x000F00) >> 8
            v.clv_seconds = x1 * 16 + x3
            v.clv_picture_number = line16 & 0x0000FF

    if (line16 & 0x8DC000) == 0x8DC000 or (line16 & 0x8BA000) == 0x8BA000:
        x3 = (line16 & 0x000F00) >> 8
        x4 = (line16 & 0x0000F0) >> 4
        audio = ((1 if x4 & 1 else 0) + (2 if x4 & 4 else 0)
                 + (4 if x3 & 8 else 0) + (8 if x4 & 8 else 0))
        v.status = {
            'cx': (line16 & 0x0DC000) == 0x0DC000,
            'twelve_inch': not (x3 & 1),
            'first_side': not (x3 & 2),
            'teletext': bool(x3 & 4),
            'digital_video': bool(x4 & 2),
            'sound_mode': SOUND_MODES[audio],
            'programme_dump': audio >= 8,
            'fm_fm_multiplex': audio in (4, 5, 6, 7, 12, 13, 14, 15),
        }
    return v


def interpret_field_codes(linecode: Dict[int, Optional[List[int]]],
                          system: str = 'NTSC') -> VbiInfo:
    """Adapter from our per-line nibble codes to the 24-bit words."""
    from ld_decode_tpu_torch.vbi.metadata import nibbles_to_code
    lines = sorted(linecode)
    vals = [nibbles_to_code(linecode.get(l)) for l in lines]
    while len(vals) < 3:
        vals.append(0)
    return interpret_iec60857(vals[0], vals[1], vals[2])
