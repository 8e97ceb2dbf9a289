#!/usr/bin/env python3
"""Kernels K1 and K2 against an earlier version of their sources (and
against variants of the current design), on one card, timed in turns:
earlier, current, variants..., variants reversed, current, earlier.

    python3 scripts/kernel_ab.py --baseline DIR [--variant NAME=VDIR ...]

DIR holds the earlier resample_lines.cu and take_along_axis.cu, for
example written there from git history with `git show
<commit>:ld_decode_tpu_torch/csrc/<file>` into a git-ignored directory.
They must export the earlier C entry points:
  resample_lines_launch(data, lli, llf, out, B, nsamp, nlines, ld, col0,
                        ncols, inv_w, st_nom, stream)  -- tables (B, ld)
                                                          contiguous;
  take_along_axis_launch(op, idx, out, rows_out, cols_out, op_rows,
                         op_cols, is0, is1, axis, stream).
A variant directory holds either or both sources with the current C
entry points; it is called through the current wrappers.  Every version
is built by utils/cuda_build.py with the same flags and run on the inputs
of chip_smoke.py phase 3 at the main paths' shapes; every output must
equal the current one bit for bit.  Beside them, two yardsticks timed the
same way: a device-to-device copy moving the bound's bytes (half read,
half written) and a one-element fill (the floor of one kernel in the
graph).  Prints the card's name and power limit, each build's ptxas
report, each turn's device time with a cold L2 (chip_smoke.MS_METHOD)
beside the bound, and a JSON summary as the last line.  Fails without a
CUDA device.
"""

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as CS  # noqa: E402
from ld_decode_tpu_torch.ops import cuda_gather as CG  # noqa: E402
from ld_decode_tpu_torch.tbc import cuda_resample as CR  # noqa: E402
from ld_decode_tpu_torch.utils import cuda_build  # noqa: E402


def _baseline_libs(base: str):
    k1 = cuda_build.build(os.path.abspath(os.path.join(
        base, 'resample_lines.cu')), name='resample_lines_baseline')
    fn = k1.resample_lines_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 \
        + [ctypes.c_float, ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    k2 = cuda_build.build(os.path.abspath(os.path.join(
        base, 'take_along_axis.cu')), name='take_along_axis_baseline')
    fn = k2.take_along_axis_launch
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 \
        + [ctypes.c_longlong] * 2 + [ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return k1, k2


def _variant_libs(spec: str):
    """NAME=DIR -> (name, {'K1': lib or None, 'K2': lib or None})."""
    name, path = spec.split('=', 1)
    libs = {}
    for kid, src, mod in (('K1', 'resample_lines.cu', CR),
                          ('K2', 'take_along_axis.cu', CG)):
        f = os.path.abspath(os.path.join(path, src))
        libs[kid] = mod._bind(cuda_build.build(
            f, name=f'{src[:-3]}_{name}')) if os.path.exists(f) else None
    return name, libs


def _with_lib(mod, lib, fn):
    """fn() with the wrapper module's library swapped for `lib`."""
    def call():
        saved, mod._LIB = mod._LIB, lib
        try:
            return fn()
        finally:
            mod._LIB = saved
    return call


def _check(rc: int, what: str):
    if rc != 0:
        sys.exit(f'{what}: launch failed, cudaError {rc}')


def k1_pair(lib, data, lli, llf, W, nlines, st_nom, col0=0, ncols=None):
    """(earlier, current) calls of K1 on one input; the earlier kernel
    gets its contiguous tables made once, outside the timed call."""
    ncols = ncols or W
    B, nsamp = data.shape
    lli_c = lli[:, :nlines + 1].contiguous()
    llf_c = llf[:, :nlines + 1].contiguous()

    def earlier():
        out = torch.empty((B, nlines, ncols), device=data.device)
        _check(lib.resample_lines_launch(
            data.data_ptr(), lli_c.data_ptr(), llf_c.data_ptr(),
            out.data_ptr(), B, nsamp, nlines, nlines + 1, col0, ncols,
            1.0 / W, float(st_nom),
            torch.cuda.current_stream().cuda_stream), 'earlier K1')
        return out

    def current():
        return CR.resample_lines_batch(data, lli, llf, W, nlines, st_nom,
                                       col0=col0, ncols=ncols)
    return earlier, current


def k2_pair(lib, op, idx, axis):
    def earlier():
        out = torch.empty(idx.shape, device=op.device)
        _check(lib.take_along_axis_launch(
            op.data_ptr(), idx.data_ptr(), out.data_ptr(), idx.shape[0],
            idx.shape[1], op.shape[0], op.shape[1], idx.stride(0),
            idx.stride(1), axis, torch.cuda.current_stream().cuda_stream),
            'earlier K2')
        return out

    def current():
        return CG.take_along_axis(op, idx, axis)
    return earlier, current


def turns(name, versions, bound_ms):
    """versions: [(label, fn)], the first the earlier sources, the second
    the current ones.  Times them forward then backward."""
    ref = versions[1][1]()
    for label, fn in versions:
        got = fn()
        torch.cuda.synchronize()
        if not torch.equal(got, ref):
            sys.exit(f'{name}: {label} differs from the current version, '
                     f'max|d| {float((got - ref).abs().max())}')
    ms = {label: [] for label, _ in versions}
    for label, fn in versions + versions[::-1]:
        ms[label].append(CS._times(torch, fn)['ms'])
    nbytes = int(bound_ms * 1e-3 * CS.HBM_BYTES_S) // 8 * 4
    src = torch.ones(nbytes // 4, device='cuda')
    dst = torch.empty_like(src)
    one = torch.empty(1, device='cuda')
    ms['copy'] = [CS._times(torch, lambda: dst.copy_(src))['ms']]
    ms['fill1'] = [CS._times(torch, lambda: one.fill_(1.0))['ms']]
    print(f'{name}: bound {bound_ms:.4f} ms; ' + '; '.join(
        f'{label} ' + ' / '.join(f'{t:.4f}' for t in ts) + ' ms ('
        f'{bound_ms / statistics.mean(ts):.3f} of bound)'
        for label, ts in ms.items()) + ' -- all bit-equal', flush=True)
    return dict(bound_ms=bound_ms, **{f'{k}_ms': v for k, v in ms.items()})


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--baseline', required=True,
                    help='directory of the earlier kernel sources')
    ap.add_argument('--variant', action='append', default=[],
                    help='NAME=DIR of variant sources (current entry points)')
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit('no CUDA device: this script times kernels on the card')
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0])
    print(f'method: {CS.MS_METHOD}; each version timed in turns, forward '
          f'then backward')
    k1_lib, k2_lib = _baseline_libs(args.baseline)
    CR._lib(), CG._lib()
    variants = [_variant_libs(v) for v in args.variant]
    for name, info in cuda_build.BUILDS.items():
        for line in info.log.splitlines():
            if 'registers' in line or 'spill' in line or 'Compiling' in line:
                print(f'ptxas {name}: {line.strip()}')
    out = {}
    for name, a, kw in CS.k1_inputs(torch, np):
        earlier, current = k1_pair(k1_lib, *a, **kw)
        got = current()
        nbytes = CS._k1_bytes(torch, got, a[1], a[4], a[3])
        versions = [('earlier', earlier), ('current', current)] + [
            (v, _with_lib(CR, libs['K1'], current))
            for v, libs in variants if libs['K1']]
        out[f'K1 {name}'] = turns(f'K1 {name}', versions,
                                  CS._bound(nbytes, 30 * got.numel())[0])
    for name, op, idx, axis, _path in CS.k2_inputs(torch, np):
        earlier, current = k2_pair(k2_lib, op, idx, axis)
        got = current()
        nbytes = CS._k2_bytes(torch, op, idx, axis, got)
        versions = [('earlier', earlier), ('current', current)] + [
            (v, _with_lib(CG, libs['K2'], current))
            for v, libs in variants if libs['K2']]
        out[f'K2 {name}'] = turns(f'K2 {name}', versions,
                                  CS._bound(nbytes, 0)[0])
    print(json.dumps(out))


if __name__ == '__main__':
    main()
