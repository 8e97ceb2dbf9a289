"""C++ filter-table code generation (reference filtermaker.py -> deemp.h).

The PyTorch port's copy of ld_decode_tpu/utils/filtermaker.py (the port
imports nothing of the JAX package); tests/test_torch_hostcopies.py holds
the two equal.  Its inventory reads the port's own designs (ops/filters.py,
audio/cx.py, comb/comb_ntsc.py), so that equality also holds those to the
JAX package's.

The reference designs its filters in scipy and code-generates `deemp.h`
(~40 named `std::vector<double>` tables + `Filter f_*` instances,
filtermaker.py:17-44, Makefile:28-29) for the C++ pipeline stages.  Our
decode path consumes the same designs as device-resident FFT banks
(ops/filters.py), but host-side native tooling still wants streaming
coefficient tables, so this module emits `ldd_filters.h`: the full
design inventory as `std::vector<double>` pairs plus `ldd::StreamFilter`
instances (native/filter.h).  Parity is enforced by compiling the
generated header and comparing impulse responses against scipy
(tests/test_filtermaker.py).
"""

from __future__ import annotations

import io
from typing import Dict, Iterable, Tuple

import numpy as np

from ld_decode_tpu_torch.utils.params import DecoderConfig

BA = Tuple[np.ndarray, np.ndarray]


def _as_ba(f) -> BA:
    if isinstance(f, tuple):
        b, a = f
    else:
        b, a = f, [1.0]
    return np.atleast_1d(np.asarray(b, np.float64)), \
        np.atleast_1d(np.asarray(a, np.float64))


def design_inventory(freq_mhz: float = 40.0) -> Dict[str, BA]:
    """Named (b, a) designs covering the reference deemp.h families that
    our pipeline realizes: deemphasis/emphasis (NTSC/PAL/VHS), the 0.5
    MHz video FIR, sync detector, burst/pilot bandpass, two-stage audio
    (bandpass implied by the FFT slice; LPF + 75 us deemp emitted), CX
    envelope filters, and the comb-side NR/color kernels."""
    from ld_decode_tpu_torch.ops import filters as F
    from ld_decode_tpu_torch.audio.cx import F500, F40
    from ld_decode_tpu_torch.comb.comb_ntsc import FILTERS as COMB

    inv: Dict[str, BA] = {}
    for system in ('NTSC', 'PAL', 'VHS'):
        cfg = DecoderConfig(system=system, freq_mhz=freq_mhz)
        key = system.lower()
        inv[f'deemp_{key}'] = _as_ba(F.deemp_ba(cfg))
        inv[f'emp_{key}'] = _as_ba(F.emp_ba(cfg))

    # the same design helpers the demod bank consumes (ops/filters.py) —
    # single source of truth, so the emitted C++ tables cannot drift
    cfg = DecoderConfig(system='NTSC', freq_mhz=freq_mhz)
    inv['v05'] = _as_ba(F.v05_ba(cfg))
    inv['psync'] = _as_ba(F.psync_ba(cfg))
    inv['burst_ntsc'] = _as_ba(F.burst_ba(cfg))
    inv['pilot_pal'] = _as_ba(F.pilot_ba(cfg))
    inv['audio_lpf'] = _as_ba(F.audio_lpf_ba(cfg))
    inv['audio_deemp'] = _as_ba(F.audio_deemp_ba(cfg))

    inv['cx_a500_48k'] = _as_ba(F500)
    inv['cx_a40h_48k'] = _as_ba(F40)

    inv['comb_nr'] = _as_ba(COMB['nr'])
    inv['comb_nrc'] = _as_ba(COMB['nrc'])
    inv['comb_colorlpi'] = _as_ba(COMB['lpi'])
    inv['comb_colorlpq'] = _as_ba(COMB['lpq'])
    inv['comb_lp3d'] = _as_ba(COMB['lp3d'])
    return inv


def reference_inventory() -> Dict[str, BA]:
    """The complete named-filter inventory of the reference's generated
    deemp.h (reference filtermaker.py:81-295): every family the legacy
    C++ decoders consume — boost, color/lpf, sync (sync/esync/psync/
    dsync/syncid at 8/4/10/32 fsc rates), NR (nr/nr28/lp18/nrc), color
    LPF/BPF, analog-audio bandpass + LPF + deemphasis chain, CX corner
    filters, Hilbert pair, PAL pilot, EFM bandpass, and line-length
    smoothing.  The designs are scipy one-liners; the (order, cutoff)
    specs below ARE the public design data (same scipy calls; parity vs
    the reference's own deemp.h tables is pinned by
    tests/test_filtermaker.py)."""
    import scipy.signal as sps

    freq = 4 * 315.0 / 88.0          # 8 fsc normalization
    freq4 = freq                      # 4 fsc uses the same constant
    freq10 = 5 * 315.0 / 88.0
    freq32 = 32.0

    fw = sps.firwin
    inv: Dict[str, BA] = {}

    inv['boost'] = _as_ba(fw(33, 3.5 / freq, window='hamming',
                             pass_zero=False))
    inv['boost10'] = _as_ba(fw(33, 3.5 / freq10, window='hamming',
                               pass_zero=False))
    inv['color'] = _as_ba(fw(33, 0.2 / freq, window='hamming'))
    inv['lpf'] = _as_ba(fw(31, 5.2 / freq, window='hamming'))
    inv['lpf42'] = _as_ba(fw(31, 4.2 / freq, window='hamming'))
    inv['lpf_comb'] = _as_ba(fw(33, 0.8 / freq, window='hamming'))
    inv['lpf4'] = _as_ba(fw(31, 5.2 / freq4, window='hamming'))
    inv['lpf10'] = _as_ba(fw(31, 5.2 / freq10, window='hamming'))
    inv['sync'] = _as_ba(fw(25, 0.1 / freq, window='hamming'))
    inv['ntscsyncbpf4'] = _as_ba(fw(17, [3.37955 / freq4, 3.77955 / freq4],
                                    window='hamming'))
    for name, fr in (('esync8', freq), ('esync4', freq4),
                     ('esync10', freq10), ('esync32', freq32)):
        inv[name] = _as_ba(fw(17, 2.0 / fr, window='hamming'))
    for name, fr in (('psync8', freq), ('psync4', freq4),
                     ('psync10', freq10)):
        inv[name] = _as_ba(fw(33, 2.0 / fr, window='hamming'))
    inv['dsync'] = _as_ba(fw(33, 0.1 / freq, window='hamming'))
    inv['dsync4'] = _as_ba(fw(21, 0.1 / freq4, window='hamming'))
    inv['dsync10'] = _as_ba(fw(33, 0.1 / freq10, window='hamming'))
    inv['dsync32'] = _as_ba(fw(33, 0.1 / freq32, window='hamming'))
    inv['sync4'] = _as_ba(fw(21, 0.1 / freq4, window='hamming'))
    inv['sync10'] = _as_ba(fw(33, 0.1 / freq10, window='hamming'))
    inv['nr'] = _as_ba(fw(25, 1.80 / (freq / 2.0), window='hamming',
                          pass_zero=False))
    inv['nr28'] = _as_ba(fw(25, [2.60 / (freq / 2.0), 2.9 / (freq / 2.0)],
                            window='hamming', pass_zero=False))
    inv['lp18'] = _as_ba(fw(25, 1.80 / (freq / 2.0), window='hamming',
                            pass_zero=True))
    inv['nrc'] = _as_ba(fw(17, 0.4 / (freq / 2.0), window='hamming',
                           pass_zero=False))
    inv['colorlpi'] = _as_ba(sps.butter(1, 1.3 / (freq4 / 2), 'low'))
    inv['colorlpq'] = _as_ba(sps.butter(1, 0.6 / (freq4 / 2), 'low'))
    inv['colorbp4'] = _as_ba(fw(9, [3.4006 / (freq / 2), 3.7585 / (freq / 2)],
                                window='hamming', pass_zero=False))
    inv['colorbp8'] = _as_ba(fw(17, [3.4006 / freq, 3.7585 / freq],
                                window='hamming', pass_zero=False))
    inv['audioin'] = _as_ba(sps.butter(8, 3.3 / freq))
    inv['leftbp'] = _as_ba(fw(33, [2.2 / (freq / 4), 2.4 / (freq / 4)],
                              window='hamming', pass_zero=False))
    inv['rightbp'] = _as_ba(fw(33, [2.7 / (freq / 4), 2.9 / (freq / 4)],
                               window='hamming', pass_zero=False))
    inv['audiolp'] = _as_ba(sps.butter(8, .10 / (freq / 4)))
    inv['audiolp20'] = _as_ba(sps.butter(8, .024 / (freq / 4 / 20)))
    inv['a500_48k'] = _as_ba(sps.butter(4, 500.0 / 24000.0,
                                        btype='highpass'))
    inv['a500_44k'] = _as_ba(fw(17, 500.0 / 22050.0, pass_zero=False))
    inv['a40h_48k'] = _as_ba(sps.butter(4, 40.0 / 24000.0,
                                        btype='highpass'))
    hilbert = np.fft.fftshift(np.fft.ifft([0] + [1] * 13 + [0] * 13))
    inv['hilbertr'] = _as_ba(hilbert.real)
    inv['hilberti'] = _as_ba(hilbert.imag)
    inv['pilot'] = _as_ba(fw(17, [3.74 / 7.5, 3.76 / 7.5],
                             window='hamming', pass_zero=False))
    # 75 us FM deemphasis from the response table (filtermaker.py:259-270)
    table = [[.000, 0], [.1, -.01], [.5, -.23], [1, -.87], [2, -2.76],
             [3, -4.77], [4, -6.58], [5, -8.16], [6, -9.54], [7, -10.75],
             [8, -11.82], [9, -12.78], [10, -13.66], [11, -14.45],
             [12, -15.18], [13, -15.86], [14, -16.49], [15, -17.07],
             [16, -17.62], [17, -18.14], [18, -18.63], [19, -19.09],
             [20, -19.53], [24, -20]]
    fr_ = np.array([t[0] / 24.0 for t in table])
    am = np.exp(np.array([t[1] for t in table]) / 9.0)
    inv['fmdeemp'] = _as_ba(sps.firwin2(33, fr_, am))
    inv['efm8'] = _as_ba(fw(49, [.05 / freq, 1.10 / freq], pass_zero=False))
    for name, wn in (('syncid8', 0.002), ('syncid4', 0.004),
                     ('syncid32', 0.0018), ('syncid10', 0.0016)):
        inv[name] = _as_ba(sps.butter(3, wn))
    inv['linelen'] = _as_ba(fw(17, 0.1))
    return inv


# group-delay constants the legacy consumers pair with the tables
# (reference filtermaker.py:190-193, 288-291)
REFERENCE_OFFSETS = {
    'f_colorlpi_offset': 2, 'f_colorlpq_offset': 2,
    'syncid4_offset': 165, 'syncid8_offset': 320,
    'syncid32_offset': 360, 'syncid10_offset': 400,
}


def _emit_vector(out: io.StringIO, name: str, vals: np.ndarray) -> None:
    out.write(f'const std::vector<double> {name} = {{\n')
    for i in range(0, len(vals), 4):
        row = ', '.join(f'{v:.17e}' for v in vals[i:i + 4])
        out.write(f'    {row},\n')
    out.write('};\n')


def cpp_filter_tables(inventory: Dict[str, BA],
                      freq_mhz: float = 40.0) -> str:
    """Render the inventory as a self-contained C++ header."""
    out = io.StringIO()
    out.write('// Generated by ld_decode_tpu.utils.filtermaker — do not '
              'edit.\n')
    out.write(f'// Design sample rate: {freq_mhz} MSa/s (audio/CX tables '
              'at their own rates).\n')
    out.write('#pragma once\n#include <vector>\n#include "filter.h"\n\n')
    for name, (b, a) in inventory.items():
        _emit_vector(out, f'c_{name}_b', b)
        _emit_vector(out, f'c_{name}_a', a)
        out.write(f'inline ldd::StreamFilter make_f_{name}() '
                  f'{{ return ldd::StreamFilter(c_{name}_b, c_{name}_a); '
                  f'}}\n\n')
    return out.getvalue()


def render_header(freq_mhz: float = 40.0) -> Tuple[str, Dict[str, BA]]:
    """Full ldd_filters.h text: the TPU-pipeline designs plus the
    complete reference deemp.h inventory (`ref_*` prefix) and its offset
    constants."""
    inv = dict(design_inventory(freq_mhz))
    for name, ba in reference_inventory().items():
        inv[f'ref_{name}'] = ba
    body = cpp_filter_tables(inv, freq_mhz)
    consts = ''.join(f'const int {k} = {v};\n'
                     for k, v in REFERENCE_OFFSETS.items())
    return body + '\n' + consts, inv


def generate(path: str, freq_mhz: float = 40.0) -> Dict[str, BA]:
    """Write ldd_filters.h; returns the combined inventory."""
    text, inv = render_header(freq_mhz)
    with open(path, 'w') as f:
        f.write(text)
    return inv


if __name__ == '__main__':
    import sys
    target = sys.argv[1] if len(sys.argv) > 1 else 'native/ldd_filters.h'
    inv = generate(target)
    print(f'wrote {target}: {len(inv)} filters')
