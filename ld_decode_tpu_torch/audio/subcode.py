"""CD subcode (Q-channel) decoding for the digital-audio chain.

The reference's EFM prototype cites Q-subcode decoding as the next step
(attic2/cd-decoder.py:14-17, "Q-subcode decoding: http://bani.anime.net/
iec958/q_subcode/project.htm") but never implements it.  This module
completes that capability per IEC 60908 / ECMA-130:

  * sections of 98 F3 frames delimited by the S0/S1 subcode sync symbols
    (14-bit channel patterns outside the EFM code set)
  * Q-channel extraction: bit 6 of the 96 post-sync subcode symbols
    -> 12 bytes: [control|ADR] + 9 data + CRC-16
  * CRC-16 (x^16 + x^12 + x^5 + 1, transmitted inverted) validation
  * ADR=1 position decode: TNO / INDEX / relative MSF / absolute MSF
    (BCD), lead-in TOC rows (TNO=0xAA lead-out), ADR=2 catalogue number,
    ADR=3 ISRC
  * an encoder for all of the above (test fixtures; the reference had
    no encoder at all)

Everything is plain NumPy on tiny arrays — subcode is 75 sections/s of
12 bytes; there is nothing here for the device to accelerate.

The PyTorch port's copy of ld_decode_tpu/audio/subcode.py (the port imports
nothing of the JAX package): numpy on the host, unchanged.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

# S0/S1 subcode-sync channel patterns (IEC 60908): 14-bit symbols that are
# deliberately NOT EFM codewords, used only in the control-symbol slot of
# the first two F3 frames of each 98-frame section.
S0_PATTERN = 0b00100000000001
S1_PATTERN = 0b00000000010010
# sentinel values decode_f3_frame emits for them (EFM proper is 0..255)
S0 = -2
S1 = -3

SECTION_FRAMES = 98
Q_BITS = 96

# Q-channel ADR nibble meanings
ADR_POSITION = 1
ADR_CATALOGUE = 2
ADR_ISRC = 3

LEADOUT_TNO = 0xAA


def crc16_q(bits: np.ndarray) -> int:
    """CRC-16 over a bit array, polynomial x^16 + x^12 + x^5 + 1
    (CCITT, init 0).  Q transmits the remainder inverted."""
    reg = 0
    for b in np.asarray(bits, np.int64):
        reg ^= int(b) << 15
        fb = (reg >> 15) & 1
        reg = ((reg << 1) & 0xFFFF) ^ (0x1021 if fb else 0)
    return reg


def _bcd(v: int) -> Optional[int]:
    hi, lo = v >> 4, v & 0xF
    if hi > 9 or lo > 9:
        return None
    return hi * 10 + lo


def _to_bcd(v: int) -> int:
    return ((v // 10) << 4) | (v % 10)


def decode_q(qbytes: np.ndarray) -> Optional[dict]:
    """Decode one 12-byte Q packet.  Returns None if the CRC fails.

    Always returns 'control', 'adr', and raw 'data'; position packets
    (ADR=1) add tno/index/min/sec/frame/amin/asec/aframe (ints, BCD
    decoded; None where a nibble is not valid BCD).
    """
    q = np.asarray(qbytes, np.uint8)
    assert q.shape == (12,)
    bits = np.unpackbits(q)
    crc = crc16_q(bits[:80])
    stored = (int(q[10]) << 8) | int(q[11])
    if crc != (stored ^ 0xFFFF):
        return None
    out = {
        'control': int(q[0]) >> 4,
        'adr': int(q[0]) & 0xF,
        'data': q[1:10].copy(),
        # control bit meanings (IEC 60908 22.3.1)
        'pre_emphasis': bool((q[0] >> 4) & 0x1),
        'copy_permitted': bool((q[0] >> 4) & 0x2),
        'four_channel': bool((q[0] >> 4) & 0x8),
    }
    if out['adr'] == ADR_POSITION:
        tno = int(q[1])
        out.update({
            'tno': tno if tno == LEADOUT_TNO else _bcd(tno),
            'leadout': tno == LEADOUT_TNO,
            'index': _bcd(int(q[2])),
            'min': _bcd(int(q[3])), 'sec': _bcd(int(q[4])),
            'frame': _bcd(int(q[5])),
            'amin': _bcd(int(q[7])), 'asec': _bcd(int(q[8])),
            'aframe': _bcd(int(q[9])),
        })
    elif out['adr'] == ADR_CATALOGUE:
        # 13 BCD digits packed across q[1:7.5]
        digs = []
        nib = np.concatenate([[b >> 4, b & 0xF] for b in q[1:8]])
        for d in nib[:13]:
            digs.append(str(int(d)) if d <= 9 else '?')
        out['catalogue'] = ''.join(digs)
    elif out['adr'] == ADR_ISRC:
        # 5 six-bit chars (30 bits) + 2 pad, then 7 BCD digits
        # (year 2 + serial 5) starting at bit 32 of the data field
        bits30 = np.unpackbits(q[1:5])[:30]
        chars = []
        for k in range(5):
            v = int(bits30[k * 6:k * 6 + 6].dot(1 << np.arange(5, -1, -1)))
            chars.append(chr(v + ord('0')) if v < 10 else
                         chr(v - 17 + ord('A')) if 17 <= v <= 42 else '?')
        digs = [str(int(d)) if d <= 9 else '?'
                for b in q[5:9] for d in (b >> 4, b & 0xF)]
        out['isrc'] = ''.join(chars) + ''.join(digs[:7])
    return out


def encode_q(control: int, adr: int, data: np.ndarray) -> np.ndarray:
    """12-byte Q packet from a control nibble, ADR nibble, and 9 data
    bytes (CRC appended inverted)."""
    data = np.asarray(data, np.uint8)
    assert data.shape == (9,)
    q = np.zeros(12, np.uint8)
    q[0] = ((control & 0xF) << 4) | (adr & 0xF)
    q[1:10] = data
    crc = crc16_q(np.unpackbits(q)[:80]) ^ 0xFFFF
    q[10], q[11] = crc >> 8, crc & 0xFF
    return q


def encode_q_position(tno: int, index: int, rel_frames: int,
                      abs_frames: int, control: int = 0) -> np.ndarray:
    """ADR=1 current-position packet from track/index + frame counts
    (75 frames/s)."""

    def msf(nf):
        m, r = divmod(nf, 75 * 60)
        s, f = divmod(r, 75)
        return _to_bcd(m), _to_bcd(s), _to_bcd(f)

    rm, rs, rf = msf(rel_frames)
    am, as_, af = msf(abs_frames)
    tno_b = tno if tno == LEADOUT_TNO else _to_bcd(tno)
    data = np.array([tno_b, _to_bcd(index), rm, rs, rf, 0, am, as_, af],
                    np.uint8)
    return encode_q(control, ADR_POSITION, data)


def subcode_symbols_for_section(q12: np.ndarray,
                                p_flag: bool = False) -> List[int]:
    """The 98 control-slot symbols of one section: S0, S1, then 96 bytes
    carrying the Q packet in bit 6 (and P in bit 7; R..W left zero —
    LaserDisc soundtracks don't carry CD+G)."""
    qbits = np.unpackbits(np.asarray(q12, np.uint8))
    assert qbits.shape == (Q_BITS,)
    syms = [S0, S1]
    p = 0x80 if p_flag else 0
    syms += [int(p | (b << 6)) for b in qbits]
    return syms


def sections_from_controls(controls: np.ndarray):
    """Split a control-symbol stream (one per F3 frame, S0/S1 sentinels
    from decode_f3_frame) into aligned 98-symbol sections.

    Returns list of (start_frame_index, symbols[98]).  Tolerates a
    corrupt S1 (S0 alone is enough to anchor) but requires S0 — matching
    player behavior."""
    c = np.asarray(controls, np.int64)
    out = []
    i = 0
    n = len(c)
    while i < n - 1:
        if c[i] == S0 and (c[i + 1] == S1 or c[i + 1] < 0):
            if i + SECTION_FRAMES <= n:
                out.append((i, c[i:i + SECTION_FRAMES]))
            i += SECTION_FRAMES
        else:
            i += 1
    return out


def decode_subcode(controls: np.ndarray) -> List[dict]:
    """All CRC-valid Q packets in a control-symbol stream.

    Each dict is decode_q()'s output plus 'section_start' (F3 frame
    index of the section's S0)."""
    out = []
    for start, syms in sections_from_controls(controls):
        body = syms[2:]
        if (body < 0).any():        # EFM-invalid symbol inside the section
            continue
        qbits = ((body.astype(np.int64) >> 6) & 1).astype(np.uint8)
        q = np.packbits(qbits)
        dec = decode_q(q)
        if dec is not None:
            dec['section_start'] = int(start)
            out.append(dec)
    return out
