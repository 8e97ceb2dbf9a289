"""The CX envelope followers over lanes: the hand-written CUDA kernel K3, its
plain version and its dispatcher.

K3 (csrc/cx_envelope.cu) stands behind no Pallas kernel: the JAX package
runs the envelope recurrence (ld_decode_tpu/audio/cx.py `_env_step`) as
`lax.scan` -- one lane over the input in `_envelope_scan`, a lower- and an
upper-bound lane per block in `_blocked_envelopes` -- and PyTorch has no
operator for a sequential scan.  One thread runs one lane; a step is a
dependent chain of three float32 operations, so the kernel is bound by that
chain's latency, not by bytes (see the note in the source).

A lane: a start position in menv (negative positions are a block's head
padding and hold the state; positions past the end read 0), a start state
(fast, slow), `nwarm` steps whose states are not kept, then `ncore` steps
whose (fast, slow) trajectory is returned.  Each step is the JAX package's
`_env_step` as XLA:CPU compiles it: the multiply-adds `fast + m*.040` and
`slow + m*.0020` are fused (tests/test_torch_cx_file.py shows JAX's scan
equal to the fused form bit for bit, and not to the unfused one), so the
kernel uses fmaf and the plain version rounds each sum once.

Dispatch follows menv's device: a CPU tensor takes the plain version
(`envelope_lanes_plain`, a numpy loop over steps vectorised over lanes); a
CUDA tensor launches K3 or raises.  Each launch adds one to
``envelope_lanes.launches``.  The kernel is built at first use by
utils/cuda_build.py.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import numpy as np
import torch

from ld_decode_tpu_torch.utils.graphs import register_counter

# the step's constants, float32 as JAX rounds its weak-typed literals
FAST_DECAY, FAST_ATTACK = np.float32(.9998), np.float32(.040)
SLOW_DECAY, SLOW_ATTACK = np.float32(.999985), np.float32(.0020)

_PAD = 256          # zeros past the last position: the kernel's read-ahead
_LIB = None


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C entry point's signature on a loaded library."""
    fn = lib.cx_envelope_launch
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 \
        + [ctypes.c_void_p] * 2 + [ctypes.c_float] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def _lib():
    global _LIB
    if _LIB is None:
        from ld_decode_tpu_torch.utils import cuda_build
        _LIB = _bind(cuda_build.build('cx_envelope.cu'))
    return _LIB


def _lanes(starts: Sequence[int], state0) -> Tuple[np.ndarray, np.ndarray]:
    starts = np.asarray(starts, np.int64).reshape(-1)
    state0 = np.asarray(state0, np.float32).reshape(-1, 2)
    if state0.shape[0] != starts.shape[0]:
        raise ValueError(f'envelope_lanes: {starts.shape[0]} starts but '
                         f'{state0.shape[0]} start states')
    if (state0 < 0).any() or np.isnan(state0).any():
        raise ValueError('envelope_lanes: start states must be >= 0 '
                         '(envelope levels)')
    return starts, state0


def _fma(a: np.ndarray, p: np.ndarray) -> np.ndarray:
    """float32(a + p) rounded once, as fmaf(m, k, a) rounds: a float32, p
    the exact float64 product m*k of two float32 values.  The float64 sum
    rounds at most once more; a double rounding can differ from a single
    one only where that sum falls exactly halfway between two float32
    values with a nonzero rounding error, which is settled by the error's
    sign."""
    s = a + p
    r = s.astype(np.float32)
    tie = (s.view(np.int64) & 0x1FFFFFFF) == 0x10000000
    if tie.any():
        bb = s - a
        err = (a - (s - bb)) + (p - bb)
        up = tie & (err > 0) & (r.astype(np.float64) < s)
        down = tie & (err < 0) & (r.astype(np.float64) > s)
        r = np.where(up, np.nextafter(r, np.float32(np.inf)), r)
        r = np.where(down, np.nextafter(r, np.float32(-np.inf)), r)
    return r


def envelope_lanes_plain(menv: torch.Tensor, starts: Sequence[int], state0,
                         nwarm: int, ncore: int
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version: the JAX package's `_env_step` in float32, one
    step at a time for all lanes at once.  Returns (fast, slow), each
    (lanes, ncore) float32 on menv's device."""
    starts, state0 = _lanes(starts, state0)
    m_all = menv.detach().cpu().numpy().astype(np.float32).reshape(-1)
    n = m_all.shape[0]
    nsteps = nwarm + ncore
    pos = starts[None, :] + np.arange(nsteps)[:, None]       # (T, L)
    valid = pos >= 0
    m = np.where(valid & (pos < n), m_all[np.clip(pos, 0, max(n - 1, 0))]
                 if n else 0, 0).astype(np.float32)
    pf = m.astype(np.float64) * np.float64(FAST_ATTACK)      # exact products
    ps = m.astype(np.float64) * np.float64(SLOW_ATTACK)
    held = ~valid.all(axis=1)
    f = state0[:, 0].copy()
    s = state0[:, 1].copy()
    out_f = np.empty((ncore, len(starts)), np.float32)
    out_s = np.empty((ncore, len(starts)), np.float32)
    for j in range(nsteps):
        mj = m[j]
        fd = f * FAST_DECAY
        nf = np.where(mj > fd, np.minimum(mj, _fma(fd, pf[j])), fd)
        sd = s * SLOW_DECAY
        ns = np.where(mj > sd, np.minimum(mj, _fma(sd, ps[j])), sd)
        if held[j]:
            nf = np.where(valid[j], nf, f)
            ns = np.where(valid[j], ns, s)
        f, s = nf, ns
        if j >= nwarm:
            out_f[j - nwarm] = f
            out_s[j - nwarm] = s
    dev = menv.device
    return (torch.from_numpy(np.ascontiguousarray(out_f.T)).to(dev),
            torch.from_numpy(np.ascontiguousarray(out_s.T)).to(dev))


def envelope_lanes(menv: torch.Tensor, starts: Sequence[int], state0,
                   nwarm: int, ncore: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The envelope followers over lanes: K3 for a CUDA menv, the plain
    version for a CPU one.

    menv: (n,) float32 envelope input (>= 0); starts: each lane's first
    position (host ints); state0: each lane's (fast, slow) start state
    (host values >= 0); nwarm, ncore: steps per lane not kept, then kept.
    Returns (fast, slow), each (lanes, ncore) float32 on menv's device.
    On the card, starts and nwarm must be multiples of 4 (the kernel moves
    whole float4s); ncore is rounded up to one internally."""
    if menv.device.type == 'cpu':
        return envelope_lanes_plain(menv, starts, state0, nwarm, ncore)
    if menv.device.type != 'cuda':
        raise ValueError(f'envelope_lanes: no kernel for device '
                         f'{menv.device}')
    starts, state0 = _lanes(starts, state0)
    if menv.dim() != 1 or menv.dtype != torch.float32:
        raise ValueError(f'envelope_lanes: menv must be a 1-D float32 '
                         f'tensor, got {menv.dtype} {tuple(menv.shape)}')
    if nwarm % 4 or (starts % 4).any() or nwarm < 0 or ncore < 0:
        raise ValueError(f'envelope_lanes: starts and nwarm must be '
                         f'multiples of 4 on the card, got nwarm {nwarm}, '
                         f'starts {starts.tolist()}')
    nlanes = starts.shape[0]
    ncore4 = -(-ncore // 4) * 4
    n = menv.shape[0]
    end = int(max(starts.max() + nwarm + ncore4, n)) if nlanes else n
    if end + _PAD >= 2 ** 31:
        raise ValueError('envelope_lanes: positions past 2^31')
    dev = menv.device
    padded = torch.zeros(end + _PAD, dtype=torch.float32, device=dev)
    padded[:n] = menv
    st = torch.from_numpy(starts.astype(np.int32)).to(dev)
    s0 = torch.from_numpy(state0).to(dev)
    out_f = torch.empty((nlanes, ncore4), dtype=torch.float32, device=dev)
    out_s = torch.empty((nlanes, ncore4), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _lib().cx_envelope_launch(
            padded.data_ptr(), st.data_ptr(), s0.data_ptr(), nlanes, nwarm,
            ncore4, out_f.data_ptr(), out_s.data_ptr(), float(FAST_DECAY),
            float(FAST_ATTACK), float(SLOW_DECAY), float(SLOW_ATTACK),
            stream)
    if rc != 0:
        raise RuntimeError(f'cx_envelope kernel launch failed: cudaError '
                           f'{rc}')
    envelope_lanes.launches += 1
    return out_f[:, :ncore], out_s[:, :ncore]


envelope_lanes.launches = 0
register_counter(envelope_lanes, 'launches')
