"""Second-stage audio filtering + decimation (torch port of
ld_decode_tpu/audio/stage2.py).

16384-sample FFT blocks over the stage-1 audio stream, a frequency-domain
slice to 1/4 rate, the 21 kHz LPF, overlap-assembled with a 64-sample head
skip.  The block layout (including the reference's final block at
`end - blocklen - 1`) is replicated exactly; block indices past the stream
end clamp to its last sample, as the JAX gather does.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from ld_decode_tpu_torch.ops.filters import DemodBank

# Rows of one inverse transform call.  On the H100 (CUDA 12.8) cuFFT takes
# another kernel for an irfft of 64 rows or more, whose roundings differ
# from those of smaller calls; up to 56 rows a row's result equals a
# one-row call's (scripts/audio_batch_probe_torch.py).  Calls of at most
# this many rows keep a field's audio independent of the number of fields
# decoded together (the sharded batch decodes fewer fields a rank).
IRFFT_ROWS = 32


def _block_starts(n: int, blocklen: int, askip: int, fdiv2: int):
    sjump = blocklen - askip * fdiv2
    starts = [0] + list(range(sjump, n - sjump, sjump))
    starts.append(n - blocklen - 1)
    return starts, sjump


def _irfft_rows(spec: torch.Tensor, n: int) -> torch.Tensor:
    """irfft over the last axis, at most IRFFT_ROWS rows a call."""
    flat = spec.reshape(-1, spec.shape[-1])
    parts = [torch.fft.irfft(c, n) for c in flat.split(IRFFT_ROWS)]
    out = parts[0] if len(parts) == 1 else torch.cat(parts)
    return out.reshape(*spec.shape[:-1], n)


def audio_stage2(left: torch.Tensor, right: torch.Tensor, bank: DemodBank,
                 n: int, blocklen: int = 16384
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stage-2 filter both channels, (..., n) -> (..., n // fdiv2)."""
    fdiv2 = bank.a_fdiv2
    askip = 64
    starts, sjump = _block_starts(n, blocklen, askip, fdiv2)
    nb = len(starts)
    outlen_blk = blocklen // fdiv2
    n_out = n // fdiv2
    dev = left.device

    # block start j*sjump for all but the last block, which starts at
    # n-blocklen-1 (built on the device: no host->device copy)
    j = torch.arange(nb, device=dev)
    st = torch.where(j == nb - 1, starts[-1], j * sjump)
    idx = (st[:, None] + torch.arange(blocklen, device=dev)).clamp(0, n - 1)
    nbins = blocklen // (fdiv2 * 2) + 1
    lpf = bank.a_lpf2_os[:nbins]

    def run(chan):
        lead = chan.shape[:-1]
        blocks = chan.index_select(-1, idx.reshape(-1)).reshape(
            *lead, nb, blocklen)
        spec = torch.fft.rfft(blocks)[..., :nbins] * lpf
        out = _irfft_rows(spec, outlen_blk) / fdiv2
        parts = [out[..., 0, :]] + [out[..., bi, askip:]
                                    for bi in range(1, nb - 1)]
        head = torch.cat(parts, dim=-1)[..., :n_out]
        head = F.pad(head, (0, max(0, n_out - head.shape[-1])))
        tail = out[..., -1, askip:]
        return torch.cat([head[..., :n_out - tail.shape[-1]], tail], dim=-1)

    return run(left), run(right)
