"""EFM (Eight-to-Fourteen Modulation) digital audio front-end.

LaserDiscs with digital soundtracks carry a CD-format EFM bitstream
(the reference explored this in attic2/cd-decoder.py, an incomplete
prototype: naive sample-by-sample PLL, frame consumption stubs).  This
module is a working, vectorized implementation of the front half of the
CD decode chain (ECMA-130 / IEC 60908):

  * channel-bit recovery: zero crossings -> run lengths -> NRZI-M bits,
    all as array ops (no per-sample Python loop)
  * F3 frame sync detection (the T11-T11 sync pattern)
  * EFM 14->8 demodulation via a 2^14 lookup-table gather
  * per-frame subcode/control byte separation and payload extraction
  * the ECMA-130 sector descrambler as a precomputed LFSR sequence

Error correction (CIRC C1/C2 Reed-Solomon, errors-and-erasures) lives
in `ld_decode_tpu_torch.audio.circ` and Q-subcode decode in
`ld_decode_tpu_torch.audio.subcode`; together with this front-end they form
the full digital-audio chain (the reference prototype had neither).

EFM_CODES holds the 256 standardized 14-bit channel patterns from
IEC 60908 (public standard constants), indexed by data byte value.

The PyTorch port's copy of ld_decode_tpu/audio/efm.py (the port imports
nothing of the JAX package): numpy on the host, unchanged.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

EFM_CLOCK_HZ = 4.3218e6
F3_CHANNEL_BITS = 588
SYNC_PATTERN = '100000000001000000000010'   # T11 T11 (+ merging handled after)

EFM_CODES = (
    0x1220, 0x2100, 0x2420, 0x2220, 0x1100, 0x0110, 0x0420, 0x0900,
    0x1240, 0x2040, 0x2440, 0x2240, 0x1040, 0x0040, 0x0440, 0x0840,
    0x2020, 0x2080, 0x2480, 0x0820, 0x1080, 0x0080, 0x0480, 0x0880,
    0x1210, 0x2010, 0x2410, 0x2210, 0x1010, 0x0210, 0x0410, 0x0810,
    0x0020, 0x2108, 0x0220, 0x0920, 0x1108, 0x0108, 0x1020, 0x0908,
    0x1248, 0x2048, 0x2448, 0x2248, 0x1048, 0x0048, 0x0448, 0x0848,
    0x0100, 0x2088, 0x2488, 0x2110, 0x1088, 0x0088, 0x0488, 0x0888,
    0x1208, 0x2008, 0x2408, 0x2208, 0x1008, 0x0208, 0x0408, 0x0808,
    0x1224, 0x2124, 0x2424, 0x2224, 0x1124, 0x0024, 0x0424, 0x0924,
    0x1244, 0x2044, 0x2444, 0x2244, 0x1044, 0x0044, 0x0444, 0x0844,
    0x2024, 0x2084, 0x2484, 0x0824, 0x1084, 0x0084, 0x0484, 0x0884,
    0x1204, 0x2004, 0x2404, 0x2204, 0x1004, 0x0204, 0x0404, 0x0804,
    0x1222, 0x2122, 0x2422, 0x2222, 0x1122, 0x0022, 0x1024, 0x0922,
    0x1242, 0x2042, 0x2442, 0x2242, 0x1042, 0x0042, 0x0442, 0x0842,
    0x2022, 0x2082, 0x2482, 0x0822, 0x1082, 0x0082, 0x0482, 0x0882,
    0x1202, 0x0248, 0x2402, 0x2202, 0x1002, 0x0202, 0x0402, 0x0802,
    0x1221, 0x2121, 0x2421, 0x2221, 0x1121, 0x0021, 0x0421, 0x0921,
    0x1241, 0x2041, 0x2441, 0x2241, 0x1041, 0x0041, 0x0441, 0x0841,
    0x2021, 0x2081, 0x2481, 0x0821, 0x1081, 0x0081, 0x0481, 0x0881,
    0x1201, 0x2090, 0x2401, 0x2201, 0x1090, 0x0201, 0x0401, 0x0890,
    0x0221, 0x2109, 0x1110, 0x0121, 0x1109, 0x0109, 0x1021, 0x0909,
    0x1249, 0x2049, 0x2449, 0x2249, 0x1049, 0x0049, 0x0449, 0x0849,
    0x0120, 0x2089, 0x2489, 0x0910, 0x1089, 0x0089, 0x0489, 0x0889,
    0x1209, 0x2009, 0x2409, 0x2209, 0x1009, 0x0209, 0x0409, 0x0809,
    0x1120, 0x2111, 0x2490, 0x0224, 0x1111, 0x0111, 0x0490, 0x0911,
    0x0241, 0x2101, 0x0244, 0x0240, 0x1101, 0x0101, 0x0090, 0x0901,
    0x0124, 0x2091, 0x2491, 0x2120, 0x1091, 0x0091, 0x0491, 0x0891,
    0x1211, 0x2011, 0x2411, 0x2211, 0x1011, 0x0211, 0x0411, 0x0811,
    0x1102, 0x0102, 0x2112, 0x0902, 0x1112, 0x0112, 0x1022, 0x0912,
    0x2102, 0x2104, 0x0249, 0x0242, 0x1104, 0x0104, 0x0422, 0x0904,
    0x0122, 0x2092, 0x2492, 0x0222, 0x1092, 0x0092, 0x0492, 0x0892,
    0x1212, 0x2012, 0x2412, 0x2212, 0x1012, 0x0212, 0x0412, 0x0812,)

# byte value -> 14-bit pattern; inverse map pattern -> byte (-1 = invalid)
EFM_DECODE = np.full(1 << 14, -1, dtype=np.int16)
for _b, _p in enumerate(EFM_CODES):
    EFM_DECODE[_p] = _b


def channel_bits_from_rf(samples: np.ndarray, sample_rate_hz: float,
                         max_bits: Optional[int] = None) -> np.ndarray:
    """Recover the NRZI-M channel bitstream from a sliced EFM waveform.

    Vectorized run-length clock recovery: sub-sample zero-crossing times ->
    transition intervals -> rounded bit counts at the EFM clock; a
    transition emits a 1 followed by (run-1) zeros.  Replaces the
    reference's per-sample `edge_pll` generator (cd-decoder.py:348-363).
    """
    x = np.asarray(samples, np.float64)
    x = x - x.mean()
    s = x >= 0
    flips = np.nonzero(s[1:] != s[:-1])[0]
    if len(flips) < 2:
        return np.zeros(0, np.uint8)
    a = x[flips]
    b = x[flips + 1]
    t = flips + a / (a - b)

    period = sample_rate_hz / EFM_CLOCK_HZ
    runs = np.diff(t) / period
    nbits = np.clip(np.round(runs).astype(np.int64), 1, 16)

    total = int(nbits.sum()) + 1
    bits = np.zeros(total, np.uint8)
    starts = np.concatenate([[0], np.cumsum(nbits)[:-1]])
    bits[starts] = 1
    if max_bits is not None:
        bits = bits[:max_bits]
    return bits


def find_frame_syncs(bits: np.ndarray) -> np.ndarray:
    """Positions of F3 frame sync patterns in the channel bitstream."""
    pat = np.array([int(c) for c in SYNC_PATTERN], np.uint8)
    n = len(bits) - len(pat)
    if n <= 0:
        return np.zeros(0, np.int64)
    # correlation == exact match when both are 0/1
    w = np.lib.stride_tricks.sliding_window_view(bits, len(pat))[:n]
    return np.nonzero((w == pat).all(axis=1))[0]


def decode_f3_frame(bits: np.ndarray, start: int
                    ) -> Optional[Tuple[int, np.ndarray]]:
    """Decode one 588-channel-bit F3 frame starting at its sync position.

    Returns (control_byte, 32 data bytes) with -1 for invalid EFM codes
    (reference frame layout, cd-decoder.py:424-443).
    """
    if start + F3_CHANNEL_BITS > len(bits):
        return None
    f = bits[start:start + F3_CHANNEL_BITS]
    pos = 24 + 3                       # skip sync + merging
    words = []
    for k in range(33):                # control byte + 32 payload bytes
        w = f[pos:pos + 14]
        val = int(w.dot(1 << np.arange(13, -1, -1)))
        dec = int(EFM_DECODE[val])
        if k == 0 and dec < 0:
            # control slot may carry the S0/S1 subcode-sync symbols,
            # which are deliberately outside the EFM code set
            from ld_decode_tpu_torch.audio import subcode as SC
            if val == SC.S0_PATTERN:
                dec = SC.S0
            elif val == SC.S1_PATTERN:
                dec = SC.S1
        words.append(dec)
        pos += 14 + 3                  # merging bits between symbols
    return words[0], np.array(words[1:], np.int16)


def chain_frame_syncs(syncs: np.ndarray) -> np.ndarray:
    """Keep only syncs on the 588-channel-bit frame grid.

    The T11-T11 pattern can also appear mid-frame (real encoders avoid it
    via merging-bit selection, but damaged streams alias it too).  A sync
    is kept when a neighbor exists exactly one frame before or after it —
    isolated pattern hits are discarded — and overlapping keepers are
    resolved greedily on the 588 grid."""
    syncs = np.asarray(syncs, np.int64)
    if len(syncs) == 0:
        return syncs
    pos = set(syncs.tolist())

    def near(p):
        return any(p + d in pos for d in (-1, 0, 1))

    supported = np.array([s for s in syncs
                          if near(s - F3_CHANNEL_BITS)
                          or near(s + F3_CHANNEL_BITS)], np.int64)
    out = []
    last = -F3_CHANNEL_BITS
    for s in supported:
        if s >= last + F3_CHANNEL_BITS - 2:
            out.append(int(s))
            last = s
    return np.array(out, np.int64)


def decode_frames(bits: np.ndarray):
    """All decodable F3 frames: list of (sync_pos, control, payload)."""
    out = []
    for s in chain_frame_syncs(find_frame_syncs(bits)):
        r = decode_f3_frame(bits, int(s))
        if r is not None:
            out.append((int(s), r[0], r[1]))
    return out


def decode_frames_on_grid(bits: np.ndarray):
    """Like decode_frames, but interleave-preserving: missing syncs on
    the 588-bit frame grid are filled by decoding at the interpolated
    position (a damaged SYNC pattern does not mean the frame data is
    gone), and frames that still fail come back as all-erasure
    placeholders instead of being DROPPED.  A dropped frame shifts
    every later frame's index, which silently corrupts up to 108
    frames of CIRC cross-interleave context downstream — C1 (intra-
    frame) cannot see the shift, so the damage surfaces only as C2
    failures far from the cause."""
    # interpolated positions hold alignment only while cumulative bit-
    # clock drift stays well under half an EFM symbol, which grows with
    # DISTANCE FROM THE NEAREST GOOD SYNC — so inside a long gap the
    # first/last MAX_INTERP positions (anchored forward off the
    # previous sync / backward off the next one) still get decode
    # attempts, while the deep middle becomes pure erasures (a
    # mis-clocked decode yields randomly-valid symbols that CIRC would
    # trust as data)
    MAX_INTERP = 16
    syncs = chain_frame_syncs(find_frame_syncs(bits))
    out = []
    prev = None
    for s in syncs:
        if prev is not None:
            gap = int(round((s - prev) / F3_CHANNEL_BITS))
            for k in range(1, max(gap, 1)):
                back = gap - k
                if k <= MAX_INTERP:
                    p = int(prev + k * F3_CHANNEL_BITS)
                elif back <= MAX_INTERP:
                    p = int(s - back * F3_CHANNEL_BITS)
                else:
                    p = int(prev + k * F3_CHANNEL_BITS)
                r = (decode_f3_frame(bits, p)
                     if min(k, back) <= MAX_INTERP
                     and p + F3_CHANNEL_BITS <= len(bits) else None)
                if r is not None:
                    out.append((p, r[0], r[1]))
                else:
                    out.append((p, -1, np.full(32, -1, np.int16)))
        if int(s) + F3_CHANNEL_BITS <= len(bits):
            r = decode_f3_frame(bits, int(s))
            if r is not None:
                out.append((int(s), r[0], r[1]))
            else:
                out.append((int(s), -1, np.full(32, -1, np.int16)))
        prev = s
    return out


def ecma130_scramble_sequence(nbytes: int = 2340) -> np.ndarray:
    """ECMA-130 Annex B scrambler stream: LFSR x^15+x+1 seeded 0x0001,
    LSB-first per byte (used to (de)scramble sector payloads; XOR is its
    own inverse)."""
    reg = 1
    out = np.zeros(nbytes, np.uint8)
    for i in range(nbytes):
        byte = 0
        for bit in range(8):
            lsb = reg & 1
            byte |= lsb << bit
            fb = (reg ^ (reg >> 1)) & 1
            reg = (reg >> 1) | (fb << 14)
        out[i] = byte
    return out


def descramble_sector(payload: np.ndarray) -> np.ndarray:
    seq = ecma130_scramble_sequence(len(payload))
    return np.bitwise_xor(np.asarray(payload, np.uint8), seq)


# ---------------------------------------------------------------------------
# test-signal generation (the encoder the reference never had)

def _pick_merging(tz: int, lz: int) -> list:
    """Choose 3 merging bits keeping every run in the EFM RLL window
    (3 <= distance between 1s <= 11); IEC 60908 guarantees a choice
    exists (real mastering additionally optimizes DSV)."""
    for m in ((0, 0, 0), (0, 1, 0), (0, 0, 1), (1, 0, 0)):
        seq = [1] + [0] * tz + list(m) + [0] * lz + [1]
        ones = [i for i, b in enumerate(seq) if b]
        runs = [b - a for a, b in zip(ones, ones[1:])]
        if all(3 <= r <= 11 for r in runs):
            return list(m)
    raise ValueError(f'no legal merging bits for tz={tz} lz={lz}')


def _tz(bits) -> int:
    n = 0
    for b in reversed(bits):
        if b:
            break
        n += 1
    return n


def encode_f3_frame(control: int, payload: np.ndarray,
                    rng=None) -> np.ndarray:
    """Channel bits of one F3 frame, with RLL-legal merging bits (all-zero
    merging can fabricate runs beyond T11, which no clocked reader — ours
    included — is required to resolve)."""
    bits = [int(c) for c in SYNC_PATTERN]
    for byte in [control] + list(payload):
        if int(byte) < 0:              # S0/S1 subcode-sync sentinels
            from ld_decode_tpu_torch.audio import subcode as SC
            p = {SC.S0: SC.S0_PATTERN, SC.S1: SC.S1_PATTERN}[int(byte)]
        else:
            p = EFM_CODES[int(byte) & 0xFF]
        sym = [(p >> k) & 1 for k in range(13, -1, -1)]
        lz = 0
        for b in sym:
            if b:
                break
            lz += 1
        bits += _pick_merging(_tz(bits), lz) + sym
    # closing merging bits (the next frame opens with the sync's leading 1)
    bits += _pick_merging(_tz(bits), 0)
    return np.array(bits, np.uint8)


def nrzi_waveform(bits: np.ndarray, sample_rate_hz: float,
                  amplitude: float = 1.0) -> np.ndarray:
    """NRZI-M: each 1 toggles the level; rendered at the capture rate."""
    level = np.cumsum(bits) % 2
    period = sample_rate_hz / EFM_CLOCK_HZ
    edges = np.round(np.arange(len(bits) + 1) * period).astype(np.int64)
    n = edges[-1]
    wave = np.zeros(n, np.float64)
    for i in range(len(bits)):
        wave[edges[i]:edges[i + 1]] = 1.0 if level[i] else -1.0
    return wave * amplitude


# ---------------------------------------------------------------------------
# RF band-split: the EFM baseband lives under the analog carriers

def efm_bandpass(rf: np.ndarray, sample_rate_hz: float,
                 lo_hz: float = 20e3, hi_hz: float = 1.75e6) -> np.ndarray:
    """Extract the EFM baseband from a composite RF capture.

    On digital-sound LaserDiscs the EFM stream occupies DC-1.75 MHz,
    below the analog audio FM carriers (2.3/2.8 MHz NTSC) and the video
    FM band; the reference band-limits raw RF with its efm8 bandpass
    before slicing (reference filtermaker.py:279-281 efm_filter,
    attic2/cd-decoder.py:469-471).  Zero-phase FFT brickwall with
    raised-cosine edges — one-shot (captures fed here are already
    windowed), DC removed."""
    rf = np.asarray(rf, np.float64)
    n = len(rf)
    X = np.fft.rfft(rf - rf.mean())
    f = np.fft.rfftfreq(n, d=1.0 / sample_rate_hz)
    roll = lo_hz            # raised-cosine edge width
    H = np.ones_like(f)
    H[f < lo_hz] = 0.5 * (1 - np.cos(np.pi * f[f < lo_hz] / lo_hz))
    hi_edge = (f > hi_hz) & (f < hi_hz + 4 * roll)
    H[hi_edge] = 0.5 * (1 + np.cos(np.pi * (f[hi_edge] - hi_hz)
                                   / (4 * roll)))
    H[f >= hi_hz + 4 * roll] = 0.0
    return np.fft.irfft(X * H, n)


def decode_digital_audio_from_rf(rf: np.ndarray, sample_rate_hz: float):
    """Composite RF capture (uint16 samples, video FM + analog audio
    carriers + EFM baseband) -> band-split -> full digital-audio decode
    (the reference's actual use case, attic2/cd-decoder.py:330-443)."""
    return decode_digital_audio(efm_bandpass(rf, sample_rate_hz),
                                sample_rate_hz)


# ---------------------------------------------------------------------------
# full digital-audio chain: EFM front-end -> CIRC -> stereo samples

def decode_digital_audio(samples: np.ndarray, sample_rate_hz: float):
    """RF samples -> error-corrected 16-bit stereo audio.

    Chains the vectorized front-end (channel-bit recovery, F3 sync, EFM
    demod) into CIRC C1/C2 correction (audio/circ.py) and the CD byte ->
    sample mapping.  The reference's prototype stopped at raw frame
    payloads with no correction (attic2/cd-decoder.py:407-507).

    Returns dict with 'samples' (n, 2) int16, 'controls' (nframes,) the
    subcode/control symbols (S0/S1 syncs as -2/-3 sentinels), 'q' the
    CRC-valid Q-subcode packets (audio/subcode.py), and the CIRC stats
    arrays.
    """
    from ld_decode_tpu_torch.audio import circ as C
    from ld_decode_tpu_torch.audio import subcode as SC

    bits = channel_bits_from_rf(samples, sample_rate_hz)
    frames = decode_frames_on_grid(bits)
    if not frames:
        return {'samples': np.zeros((0, 2), np.int16),
                'controls': np.zeros(0, np.int16), 'q': [],
                'c1_ok': np.zeros(0, bool), 'c2_ok': np.zeros(0, bool)}
    controls = np.array([f[1] for f in frames], np.int16)
    payload = np.stack([f[2] for f in frames])      # (nframes, 32), -1 bad
    chan = np.where(payload < 0, 0, payload).astype(np.uint8)
    # EFM-undecodable symbols are known-bad: hand them to C1 as erasures
    # (2e + f <= 4) instead of letting RS re-discover them as errors
    dec = C.circ_decode(chan, bad_mask=payload < 0)
    return {
        'samples': C.audio_to_samples(dec['audio']),
        'controls': controls,
        'q': SC.decode_subcode(controls),
        'c1_ok': dec['c1_ok'], 'c2_ok': dec['c2_ok'],
        'c1_corrected': dec['c1_corrected'],
        'c2_corrected': dec['c2_corrected'],
    }


def extract_digital_audio(loader, fd, start_sample: int, n_samples: int,
                          sample_rate_hz: float):
    """CLI helper: load an RF span via `loader` and run the full
    digital-audio chain (band-split -> EFM -> CIRC -> subcode).
    Returns the decode dict, or None if nothing is readable."""
    from ld_decode_tpu_torch.io.loaders import load_available
    data = load_available(loader, fd, int(start_sample), int(n_samples),
                          max(int(n_samples) // 64, 4096))
    if data is None:
        return None
    arr = np.asarray(data)
    if np.issubdtype(arr.dtype, np.signedinteger):
        arr = (arr.astype(np.int32) + 32768).astype(np.uint16)
    return decode_digital_audio_from_rf(arr, sample_rate_hz)


def write_digital_audio_outputs(dec, outbase: str) -> None:
    """Write <outbase>.efm.pcm (stereo s16) + <outbase>.subcode.log
    (CIRC stats header + CRC-valid Q packets)."""
    with open(outbase + '.efm.pcm', 'wb') as f:
        f.write(np.asarray(dec['samples'], '<i2').tobytes())
    with open(outbase + '.subcode.log', 'w') as f:
        f.write(f'# frames={len(dec["controls"])} '
                f'c1_ok={int(dec["c1_ok"].sum())} '
                f'c1_corrected='
                f'{int(np.sum(dec.get("c1_corrected", 0)))} '
                f'c2_ok={int(dec["c2_ok"].sum())} '
                f'c2_corrected='
                f'{int(np.sum(dec.get("c2_corrected", 0)))}\n')
        for q in dec['q']:
            f.write(repr(q) + '\n')


def encode_digital_audio(samples: np.ndarray, sample_rate_hz: float,
                         control: int = 0,
                         controls: Optional[np.ndarray] = None,
                         flush: bool = True) -> np.ndarray:
    """Stereo samples -> EFM RF waveform (test fixture for the full chain:
    CIRC encode -> F3 frames -> NRZI at the capture rate).

    `controls` optionally supplies the per-frame control-slot symbols
    (e.g. from subcode.subcode_symbols_for_section, with S0/S1
    sentinels); shorter streams repeat, longer ones truncate.

    flush=True appends 112 zero-audio frames so the CIRC interleave
    delay lines (2 + 4*27 + 1 frames deep) fully drain: without it the
    last ~108 frames of a finite stream are unrecoverable by design
    (C2 reads up to 108 frames ahead), which round 4's tests
    misread as a 39% C2 failure rate."""
    from ld_decode_tpu_torch.audio import circ as C

    if flush:
        samples = np.concatenate(
            [np.asarray(samples, np.int16),
             np.zeros((112 * 6, 2), np.int16)])
    audio = C.samples_to_audio(samples)
    chan = C.circ_encode(audio)                      # (nframes, 32)
    n = chan.shape[0]
    if controls is None:
        ctl = [control] * n
    else:
        ctl = [int(controls[i % len(controls)]) for i in range(n)]
    allbits = [encode_f3_frame(ctl[i], chan[i]) for i in range(n)]
    return nrzi_waveform(np.concatenate(allbits), sample_rate_hz)
