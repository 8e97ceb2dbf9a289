"""CIRC error correction (Cross-Interleaved Reed-Solomon Code).

Completes the CD-format digital-audio chain behind the EFM front-end
(audio/efm.py).  The reference never implemented this layer — its CD
prototype stops at frame consumption (reference attic2/cd-decoder.py:
407-443, audio extraction at 507 with no correction) — so this module is
specified directly from IEC 60908 / ECMA-130:

  encoder (for fixtures):  24 audio bytes/frame
     -> 2-frame delay on the odd-sample words, even/odd word split
     -> C2 = RS(28,24) over GF(2^8), parity in the middle (bytes 12..15)
     -> cross-interleave: byte j delayed 4*j frames
     -> C1 = RS(32,28), parity appended (bytes 28..31)
     -> 1-frame delay on odd-numbered bytes; P and Q parities inverted

  decoder: the exact reverse; C1 corrects up to 2 symbol errors and
  flags uncorrectable words; C2 uses the C1 flags as erasures (up to 4)
  plus its own error correction, then the de-interleave reassembles the
  6 stereo 16-bit samples per frame.

Reed-Solomon is the textbook Berlekamp-Massey + Chien + Forney chain
over GF(256) with the CD field polynomial x^8+x^4+x^3+x^2+1 (0x11d) and
code roots alpha^0..alpha^3.  Decoding runs per-frame in numpy (this is
a stretch capability, not a throughput path; the hot EFM channel-bit
recovery stays vectorized).

The PyTorch port's copy of ld_decode_tpu/audio/circ.py (the port imports
nothing of the JAX package): numpy on the host, unchanged.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

# ---------------------------------------------------------------------------
# GF(256) arithmetic, poly 0x11d, generator alpha = 2

GF_EXP = np.zeros(512, np.int32)
GF_LOG = np.zeros(256, np.int32)
_x = 1
for _i in range(255):
    GF_EXP[_i] = _x
    GF_LOG[_x] = _i
    _x <<= 1
    if _x & 0x100:
        _x ^= 0x11d
GF_EXP[255:510] = GF_EXP[:255]


def gf_mul(a, b):
    a = np.asarray(a, np.int32)
    b = np.asarray(b, np.int32)
    out = GF_EXP[(GF_LOG[a] + GF_LOG[b]) % 255]
    return np.where((a == 0) | (b == 0), 0, out)


def gf_inv(a):
    return GF_EXP[(255 - GF_LOG[a]) % 255]


def _poly_eval(poly: np.ndarray, x: int) -> int:
    """Evaluate polynomial (highest degree first) at x."""
    y = 0
    for c in poly:
        y = int(gf_mul(y, x)) ^ int(c)
    return y


# ---------------------------------------------------------------------------
# systematic RS with parity at arbitrary positions
#
# codeword c (length n) must satisfy sum_j c[j] * alpha^(i*j) = 0 for
# i = 0..3.  With 4 parity bytes at positions `ppos` this is a 4x4 GF
# linear system; its inverse is constant per (n, ppos) and precomputed.

def _parity_matrix(n: int, ppos: Tuple[int, ...]) -> np.ndarray:
    m = len(ppos)
    A = np.zeros((m, m), np.int32)
    for i in range(m):
        for k, j in enumerate(ppos):
            A[i, k] = GF_EXP[(i * j) % 255]
    # invert via Gauss-Jordan over GF(256)
    aug = np.concatenate([A, np.eye(m, dtype=np.int32)], axis=1)
    for col in range(m):
        piv = col + int(np.nonzero(aug[col:, col])[0][0])
        aug[[col, piv]] = aug[[piv, col]]
        aug[col] = gf_mul(aug[col], gf_inv(aug[col, col]))
        for r in range(m):
            if r != col and aug[r, col]:
                aug[r] = aug[r] ^ gf_mul(aug[r, col], aug[col])
    return aug[:, m:]


def rs_encode(data_cols: np.ndarray, n: int, ppos: Tuple[int, ...]
              ) -> np.ndarray:
    """data_cols: (nframes, n-4) data bytes; returns (nframes, n) codewords
    with parity inserted at positions `ppos`."""
    nf = data_cols.shape[0]
    dpos = [j for j in range(n) if j not in ppos]
    cw = np.zeros((nf, n), np.int32)
    cw[:, dpos] = data_cols
    # syndromes of the data-only word
    S = np.zeros((nf, 4), np.int32)
    for i in range(4):
        acc = np.zeros(nf, np.int32)
        for j in dpos:
            acc ^= gf_mul(cw[:, j], GF_EXP[(i * j) % 255])
        S[:, i] = acc
    Minv = _parity_matrix(n, ppos)
    for k in range(4):
        acc = np.zeros(nf, np.int32)
        for i in range(4):
            acc ^= gf_mul(S[:, i], Minv[k, i])
        cw[:, ppos[k]] = acc
    return cw


def rs_decode_word(cw: np.ndarray, erasures: List[int], tmax: int
                   ) -> Tuple[Optional[np.ndarray], int]:
    """Decode one RS word (4 parity symbols, roots alpha^0..3).

    Returns (corrected word or None, n_corrected).  Handles e errors and
    f erasures with 2e + f <= 4 via erasure-initialized Berlekamp-Massey
    + Chien search + Forney.  `tmax` caps the non-erasure errors C1/C2
    will claim (2 for both here)."""
    n = len(cw)
    S = np.array([_poly_eval(cw[::-1], GF_EXP[i]) for i in range(4)],
                 np.int32)
    if not S.any():
        return cw.copy(), 0

    # erasure locator prod (1 + X_j x), X_j = alpha^pos, lowest-first:
    # appending 0 keeps the polynomial, prepending shifts by x
    gamma = np.array([1], np.int32)
    for pos in erasures:
        X = GF_EXP[pos % 255]
        gamma = np.concatenate([gamma, [0]]) ^ np.concatenate(
            [[0], gf_mul(gamma, X)])
    f = len(erasures)
    if f > 4:
        return None, 0

    # modified syndrome polynomial + BM for the error locator
    # (work with S(x) = S0 + S1 x + ... lowest-first)
    def poly_mul(a, b):
        out = np.zeros(len(a) + len(b) - 1, np.int32)
        for i, ai in enumerate(a):
            if ai:
                out[i:i + len(b)] ^= gf_mul(ai, b)
        return out

    Sx = S[::1]                                  # lowest-first
    gamma_lf = gamma                             # already lowest-first
    T = poly_mul(gamma_lf, Sx)[:4]               # Forney syndromes

    # Berlekamp-Massey on the Forney syndromes T[f..3] (errors only;
    # erasures are already folded into T via gamma)
    C = np.array([1], np.int32)
    B = np.array([1], np.int32)
    L, m, b = 0, 1, 1
    for nn in range(f, 4):
        d = int(T[nn])
        for i in range(1, L + 1):
            if i < len(C) and nn - i >= 0:
                d ^= int(gf_mul(C[i], T[nn - i]))
        if d == 0:
            m += 1
        elif 2 * L <= nn - f:
            Cprev = C.copy()
            coef = gf_mul(d, gf_inv(b))
            shifted = np.concatenate([np.zeros(m, np.int32), B])
            ln = max(len(C), len(shifted))
            C = np.pad(C, (0, ln - len(C))) ^ gf_mul(
                coef, np.pad(shifted, (0, ln - len(shifted))))
            L = nn - f + 1 - L
            B = Cprev
            b = d
            m = 1
        else:
            coef = gf_mul(d, gf_inv(b))
            shifted = np.concatenate([np.zeros(m, np.int32), B])
            ln = max(len(C), len(shifted))
            C = np.pad(C, (0, ln - len(C))) ^ gf_mul(
                coef, np.pad(shifted, (0, ln - len(shifted))))
            m += 1
    if L > tmax:
        return None, 0

    # total locator = C * gamma
    locator = poly_mul(C, gamma_lf)
    # Chien search over codeword positions
    roots = []
    for pos in range(n):
        Xinv = GF_EXP[(255 - pos) % 255]
        if _poly_eval(locator[::-1], Xinv) == 0:
            roots.append(pos)
    if len(roots) != L + f:
        return None, 0

    # Forney: omega = S * locator mod x^4; formal derivative keeps the
    # odd-power coefficients
    omega = poly_mul(locator, Sx)[:4]
    dcoef = np.array([locator[i] for i in range(1, len(locator), 2)],
                     np.int32)

    out = cw.copy()
    for pos in roots:
        Xinv = GF_EXP[(255 - pos) % 255]
        num = _poly_eval(omega[::-1], Xinv)
        # derivative evaluated at Xinv: sum dcoef[k] * Xinv^(2k)
        den = 0
        for k, c in enumerate(dcoef):
            den ^= int(gf_mul(c, GF_EXP[(2 * k * (255 - pos)) % 255]))
        if den == 0:
            return None, 0
        # code roots start at alpha^0 (b0=0): e_j = X_j * Omega/Lambda'
        mag = gf_mul(GF_EXP[pos % 255], gf_mul(num, gf_inv(den)))
        out[pos] ^= int(mag)
    # verify
    S2 = [_poly_eval(out[::-1], GF_EXP[i]) for i in range(4)]
    if any(S2):
        return None, 0
    return out, len(roots)


# ---------------------------------------------------------------------------
# CIRC interleave constants (IEC 60908 / ECMA-130)

C2_PPOS = (12, 13, 14, 15)
C1_PPOS = (28, 29, 30, 31)
D2 = 4                      # cross-interleave unit delay (frames)

# stage-1 word order: 12 words (L0 R0 L1 R1 L2 R2 L3 R3 L4 R4 L5 R5 as
# byte pairs); even samples (L0,L2,L4,R0,R2,R4) go to the first 12 byte
# positions, odd samples to the last 12; odd samples get the 2-frame delay
_EVEN_WORDS = (0, 2, 4, 6, 8, 10)
_ODD_WORDS = (1, 3, 5, 7, 9, 11)


def circ_encode(audio_bytes: np.ndarray) -> np.ndarray:
    """audio_bytes: (nframes, 24) uint8 -> (nframes, 32) channel frames.

    The tail of the stream carries partially-flushed interleave state
    (delays are implemented by indexing into a zero-padded array)."""
    nf, w = audio_bytes.shape
    assert w == 24
    ab = audio_bytes.astype(np.int32)

    # stage 1: 2-frame delay on odd-sample words, even/odd split
    s1 = np.zeros((nf, 24), np.int32)
    for k, wd in enumerate(_EVEN_WORDS):
        s1[:, 2 * k] = ab[:, 2 * wd]
        s1[:, 2 * k + 1] = ab[:, 2 * wd + 1]
    for k, wd in enumerate(_ODD_WORDS):
        src = np.zeros(nf, np.int32)
        src[2:] = ab[:-2, 2 * wd]
        s1[:, 12 + 2 * k] = src
        src = np.zeros(nf, np.int32)
        src[2:] = ab[:-2, 2 * wd + 1]
        s1[:, 12 + 2 * k + 1] = src

    # C2 encode (parity in the middle)
    c2 = rs_encode(s1, 28, C2_PPOS)

    # stage 2: byte j delayed by 4*j frames
    s2 = np.zeros((nf, 28), np.int32)
    for j in range(28):
        d = D2 * j
        if d < nf:
            s2[d:, j] = c2[:nf - d, j]

    # C1 encode (parity appended)
    c1 = rs_encode(s2, 32, C1_PPOS)

    # stage 3: 1-frame delay on odd bytes; invert P and Q parities
    s3 = np.zeros((nf, 32), np.int32)
    s3[:, 0::2] = c1[:, 0::2]
    s3[1:, 1::2] = c1[:-1, 1::2]
    for j in list(C2_PPOS) + [28, 29, 30, 31]:
        s3[:, j] ^= 0xFF
    return s3.astype(np.uint8)


def circ_decode(frames: np.ndarray, bad_mask: np.ndarray = None):
    """frames: (nframes, 32) uint8 channel frames -> dict with
    'audio' (nvalid, 24) uint8, per-frame C1/C2 stats and erasure flags.

    `bad_mask` (nframes, 32) marks symbols the EFM demod could not
    decode: C1 treats them as erasures (2e + f <= 4), doubling the
    correction power on known-bad symbols vs. guessing.  Frames damaged
    beyond that propagate erasure flags into C2, which corrects up to 4
    erasures per word."""
    nf = frames.shape[0]
    fr = frames.astype(np.int32)

    # route the known-bad positions through the same stage-3 deinterleave
    # the data takes, so they land on the right C1 codeword symbols
    bad3 = np.zeros((nf, 32), bool)
    if bad_mask is not None:
        b = np.asarray(bad_mask, bool)
        bad3[:, 0::2] = b[:, 0::2]
        bad3[:nf - 1, 1::2] = b[1:, 1::2]

    # undo stage 3
    u3 = np.zeros((nf, 32), np.int32)
    u3[:, 0::2] = fr[:, 0::2]
    u3[:nf - 1, 1::2] = fr[1:, 1::2]
    for j in list(C2_PPOS) + [28, 29, 30, 31]:
        u3[:, j] ^= 0xFF

    # C1 decode
    c1_ok = np.zeros(nf, bool)
    c1_corrected = np.zeros(nf, np.int32)
    c1_out = np.zeros((nf, 28), np.int32)
    c1_flag = np.ones((nf, 28), bool)
    for i in range(nf - 1):          # last frame lacks its odd bytes
        ers = np.nonzero(bad3[i])[0].tolist()
        if len(ers) > 4:
            c1_out[i] = u3[i, :28]   # beyond C1: all symbols stay flagged
            continue
        out, ncorr = rs_decode_word(u3[i], ers, 2)
        if out is not None:
            c1_out[i] = out[:28]
            c1_flag[i] = False
            c1_ok[i] = True
            c1_corrected[i] = ncorr
        else:
            c1_out[i] = u3[i, :28]

    # undo stage 2 (advance by 4*j)
    u2 = np.zeros((nf, 28), np.int32)
    u2flag = np.ones((nf, 28), bool)
    for j in range(28):
        d = D2 * j
        if d < nf:
            u2[:nf - d, j] = c1_out[d:, j]
            u2flag[:nf - d, j] = c1_flag[d:, j]

    # C2 decode with C1 erasures
    c2_ok = np.zeros(nf, bool)
    c2_corrected = np.zeros(nf, np.int32)
    c2_out = np.zeros((nf, 28), np.int32)
    for i in range(nf):
        ers = list(np.nonzero(u2flag[i])[0])
        if len(ers) > 4:
            # too many erasures: pass through, flag the frame
            c2_out[i] = u2[i]
            continue
        out, ncorr = rs_decode_word(u2[i], ers, 2)
        if out is not None:
            c2_out[i] = out
            c2_ok[i] = True
            c2_corrected[i] = ncorr
        else:
            c2_out[i] = u2[i]

    # undo stage 1: drop Q parity, undo the 2-frame odd-sample delay
    dpos = [j for j in range(28) if j not in C2_PPOS]
    d24 = c2_out[:, dpos]
    audio = np.zeros((nf, 24), np.int32)
    for k, wd in enumerate(_EVEN_WORDS):
        audio[:, 2 * wd] = d24[:, 2 * k]
        audio[:, 2 * wd + 1] = d24[:, 2 * k + 1]
    for k, wd in enumerate(_ODD_WORDS):
        audio[:nf - 2, 2 * wd] = d24[2:, 12 + 2 * k]
        audio[:nf - 2, 2 * wd + 1] = d24[2:, 12 + 2 * k + 1]

    return {
        'audio': audio.astype(np.uint8),
        'c1_ok': c1_ok, 'c1_corrected': c1_corrected,
        'c2_ok': c2_ok, 'c2_corrected': c2_corrected,
    }


def audio_to_samples(audio_bytes: np.ndarray) -> np.ndarray:
    """(nframes, 24) bytes -> (nframes*6, 2) int16 stereo samples
    (big-endian words, L/R interleaved as L0 R0 L1 R1 ...)."""
    b = audio_bytes.reshape(-1, 12, 2)
    words = (b[:, :, 0].astype(np.int32) << 8) | b[:, :, 1]
    words = words.astype(np.uint16).astype(np.int16)
    return words.reshape(-1, 6, 2).reshape(-1, 2)


def samples_to_audio(samples: np.ndarray) -> np.ndarray:
    """(n, 2) int16 -> (n/6, 24) bytes (inverse of audio_to_samples)."""
    w = samples.astype(np.int16).astype(np.uint16).reshape(-1, 12)
    out = np.zeros((w.shape[0], 24), np.uint8)
    out[:, 0::2] = (w >> 8).astype(np.uint8)
    out[:, 1::2] = (w & 0xFF).astype(np.uint8)
    return out
