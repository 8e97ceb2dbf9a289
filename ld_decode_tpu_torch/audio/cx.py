"""CX noise-reduction expander (torch port of ld_decode_tpu/audio/cx.py;
reference cx-expander.cxx).

The filters and the expander are the JAX package's host code (numpy/scipy;
the port imports nothing of the JAX package): tests/test_torch_hostcopies.py
holds the two equal.  The envelope followers run as a host loop for short
inputs (the chain feeds one frame of audio at a time, about 1,600 samples)
and, from CX_HOST_MAX samples on (file-level inputs: ldexport reads 1 MB
chunks), as the JAX package's block-parallel evaluation
(`envelope_followers_blocked`) on the device: each block scans a lower and
an upper bound of the state over a warm-up overlap, and where the two meet
on the gain input the block is exact, whatever the true carry was; the O(n)
scan is the fallback when that certificate fails.  Both scans run in the
hand-written kernel K3 (audio/cuda_cx.py) on the card.

Per-sample chain on 48 kHz stereo:
  * 500 Hz 4-pole butter HPF per channel feeds the envelope detector
    (filters a500_48k / a40h_48k from reference filtermaker.py:233-246)
  * dual-speed rectified envelope followers (cx-expander.cxx:53-60):
      fast' = fast*.9998;        if m > fast': fast' = min(m, fast' + m*.040)
      slow' = slow*.999985;      if m > slow': slow' = min(m, slow' + m*.0020)
  * gain 1 + val/(factor*m14db) with val = max(fast, slow) - factor*m14db,
    m14db = -14 dB, factor 6500 (cx-expander.cxx:62-75)
  * 40 Hz DC-block, x0.4 headroom (cx-expander.cxx:77-84)
"""

from __future__ import annotations

import numpy as np
import scipy.signal as sps
import torch

from ld_decode_tpu_torch.audio.cuda_cx import envelope_lanes
from ld_decode_tpu_torch.utils.device import DEFAULT as DEFAULT_DEVICE
from ld_decode_tpu_torch.utils.device import resolve as resolve_device
from ld_decode_tpu_torch.utils.spans import span

M14DB = 0.199526231496888
FACTOR = 6500.0
CX_HOST_MAX = 32768       # shorter inputs run the host loop


def _filters():
    b5, a5 = sps.butter(4, 500.0 / 24000.0, btype='highpass')
    b40, a40 = sps.butter(4, 40.0 / 24000.0, btype='highpass')
    return (np.asarray(b5), np.asarray(a5)), (np.asarray(b40), np.asarray(a40))


F500, F40 = _filters()


def envelope_followers(maxenv: np.ndarray, fast0: float = 0.0,
                       slow0: float = 0.0, device=DEFAULT_DEVICE):
    """The dual-speed envelope recurrences.

    Short inputs (a frame's worth of audio, ~1600 samples) run as a host
    loop; inputs of CX_HOST_MAX samples or more run the block-parallel
    evaluation on `device`, falling back to the O(n) scan only when its
    exactness certificate fails (envelope_followers_blocked)."""
    if len(maxenv) >= CX_HOST_MAX:
        fast, slow, ok = envelope_followers_blocked(maxenv, fast0, slow0,
                                                    device=device)
        if not ok:
            return _envelope_scan(maxenv, fast0, slow0, device=device)
        return fast, slow
    fast, slow = float(fast0), float(slow0)
    out_f = np.empty(len(maxenv))
    out_s = np.empty(len(maxenv))
    for i, m in enumerate(np.asarray(maxenv, np.float64)):
        fast *= .9998
        if m > fast:
            fast = min(m, fast + m * .040)
        slow *= .999985
        if m > slow:
            slow = min(m, slow + m * .0020)
        out_f[i] = fast
        out_s[i] = slow
    return out_f, out_s


def _menv(maxenv, device) -> torch.Tensor:
    return torch.from_numpy(np.asarray(maxenv, np.float32)).to(
        resolve_device(device))


def _envelope_scan(maxenv: np.ndarray, fast0: float, slow0: float,
                   device=DEFAULT_DEVICE):
    """The exact O(n) recurrence (cx-expander.cxx:53-60) as one lane of K3;
    the fallback when the blocked certificate fails."""
    menv = _menv(maxenv, device)
    n = menv.shape[0]
    fast, slow = envelope_lanes(menv, [0], [(fast0, slow0)], 0, n)
    return fast[0].cpu().numpy(), slow[0].cpu().numpy()


# ---------------------------------------------------------------------------
# block-parallel envelopes: O(warm+core) depth instead of O(n)
#
# The followers are monotone in their state: running a block from a state
# BELOW the true entry state lower-bounds every subsequent value, from a
# state above upper-bounds it.  Each block therefore scans from both
# bounds (lo = 0, up = the global envelope ceiling) across a `warm`
# sample overlap; wherever the two runs agree on the gain-relevant
# quantity val = relu(max(fast, slow) - FACTOR*M14DB), the true value is
# pinned between them and the block result is exact to that tolerance --
# no matter what the real carry was.  Decay contracts the bounds at
# 0.9998/0.999985 per sample and any attack clamp (state pulled to the
# input) collapses them instantly, so real programme material converges
# in far fewer than `warm` samples; a genuinely unconverged block (an
# envelope decaying at exactly the slow-follower rate for seconds) is
# detected and the caller falls back to the sequential scan.

CX_BLOCK_CORE = 131072            # emitted samples per block (2.7 s)
CX_BLOCK_WARM = 262144            # overlap: 65536*0.999985^262144 < pivot
_ENV_CEIL = 65536.0               # >= any |500 Hz HPF| of int16 audio


def _blocked_envelopes(menv: torch.Tensor, fast0, slow0, core: int,
                       warm: int, nb: int):
    """Both bounds of every block as 2*nb lanes of K3 (lane 2k the lower
    bound of block k, lane 2k+1 its upper bound), then the certificate
    reduction on their output.  Returns (fast, slow) of the lower bounds,
    the largest gain-input gap and the end-state gap."""
    n = menv.shape[0]
    starts, state0 = [], []
    for k in range(nb):
        start = k * core - warm
        # any block whose warm window reaches back to sample 0 sees the
        # ENTIRE history from the known initial state -> its bounds can
        # both start there and the block is exact by construction (not
        # just block 0: block 1's warm region is truncated by the file
        # start, and seeding it from (0, ceiling) would leave its bounds
        # apart after only warm/2 decay steps)
        first = start <= 0
        starts += [start, start]
        state0 += [(fast0, slow0) if first else (0.0, 0.0),
                   (fast0, slow0) if first else (_ENV_CEIL, _ENV_CEIL)]
    fast, slow = envelope_lanes(menv, starts, state0, warm, core)
    flo, slo = fast[0::2].reshape(-1)[:n], slow[0::2].reshape(-1)[:n]
    fup, sup = fast[1::2].reshape(-1)[:n], slow[1::2].reshape(-1)[:n]
    pivot = torch.tensor(FACTOR * M14DB, dtype=torch.float32,
                         device=menv.device)
    dval = (torch.clamp(torch.maximum(fup, sup) - pivot, min=0.0)
            - torch.clamp(torch.maximum(flo, slo) - pivot, min=0.0))
    # end-state gap: once the bounds meet they stay met (the recurrence
    # is deterministic), so a tiny final gap certifies the LAST state as
    # exact -- required when the caller carries it into a next chunk
    end_gap = torch.maximum((fup[-1] - flo[-1]).abs(),
                            (sup[-1] - slo[-1]).abs())
    return flo, slo, dval.max(), end_gap


def envelope_followers_blocked(maxenv: np.ndarray, fast0: float = 0.0,
                               slow0: float = 0.0, core: int = CX_BLOCK_CORE,
                               warm: int = CX_BLOCK_WARM,
                               tol: float = 0.05, device=DEFAULT_DEVICE):
    """Block-parallel envelope followers on `device`.  Returns (fast, slow,
    converged); converged=False means the bound certificate exceeded `tol`
    on the gain input somewhere (or the final carry state is not pinned)
    and the caller must use `_envelope_scan` instead."""
    # the non-first blocks seed their upper bound at _ENV_CEIL, which is
    # only a valid bound if the entry state is <= the ceiling -- a wild
    # caller-supplied state above it could keep the true state over the
    # bound past the warm window, passing the certificate on a wrong
    # result (in-tree callers always satisfy this; assert it)
    assert fast0 <= _ENV_CEIL and slow0 <= _ENV_CEIL, (fast0, slow0)
    menv = _menv(maxenv, device)
    n = int(menv.shape[0])
    nb = -(-n // core)
    fast, slow, dval, end_gap = _blocked_envelopes(
        menv, np.float32(fast0), np.float32(slow0), core, warm, nb)
    # converged = every output's gain input certified AND the final
    # state exact (a streaming caller carries it into its next chunk as
    # truth; real audio clamps the bounds together long before the end,
    # a quiet tail falls back to the exact scan instead)
    ok = bool(dval <= tol) and bool(end_gap <= 1e-3)
    return fast.cpu().numpy(), slow.cpu().numpy(), ok


class CXExpander:
    """Streaming CX expansion with carried filter/envelope state
    (bit-stream compatible with `cx <in.pcm >out.pcm`).  Chunks of
    CX_HOST_MAX samples or more run their envelopes on `device` (default
    the card); shorter ones never touch it."""

    def __init__(self, device=DEFAULT_DEVICE):
        self.device = device
        self.zi500_l = sps.lfilter_zi(*F500) * 0.0
        self.zi500_r = self.zi500_l.copy()
        self.zi40_l = sps.lfilter_zi(*F40) * 0.0
        self.zi40_r = self.zi40_l.copy()
        self.fast = 0.0
        self.slow = 0.0

    def process(self, pcm: np.ndarray) -> np.ndarray:
        """pcm: interleaved uint16 (offset-32768) or int16 stereo samples.
        Returns expanded interleaved uint16 like the reference tool.  The
        `cx.process` span (utils/spans.py)."""
        with span('cx.process'):
            return self._process(pcm)

    def _process(self, pcm: np.ndarray) -> np.ndarray:
        pcm = np.asarray(pcm)
        if pcm.dtype == np.int16:
            left = pcm[0::2].astype(np.float64)
            right = pcm[1::2].astype(np.float64)
        else:
            left = pcm[0::2].astype(np.float64) - 32768.0
            right = pcm[1::2].astype(np.float64) - 32768.0

        fl, self.zi500_l = sps.lfilter(*F500, left, zi=self.zi500_l)
        frr, self.zi500_r = sps.lfilter(*F500, right, zi=self.zi500_r)
        menv = np.maximum(np.abs(fl), np.abs(frr))

        fast, slow = envelope_followers(menv, self.fast, self.slow,
                                        device=self.device)
        if len(fast):
            self.fast = float(fast[-1])
            self.slow = float(slow[-1])

        val = np.maximum(fast, slow) - (FACTOR * M14DB)
        val = np.maximum(val, 0.0)
        gain = M14DB * (1.0 + val / (FACTOR * M14DB))

        ol = left * gain
        orr = right * gain
        ol, self.zi40_l = sps.lfilter(*F40, ol, zi=self.zi40_l)
        orr, self.zi40_r = sps.lfilter(*F40, orr, zi=self.zi40_r)
        ol *= .4
        orr *= .4

        out = np.empty(len(ol) * 2, np.float64)
        out[0::2] = ol
        out[1::2] = orr
        return np.clip(out + 32768.0, 0, 65535).astype(np.uint16)
