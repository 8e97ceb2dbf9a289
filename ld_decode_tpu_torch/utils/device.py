"""Device selection, device constants and device-to-host copies.

The port's entry points run on the card by default.  A caller that wants
the CPU asks for it (`device='cpu'`); asking for a CUDA device on a machine
without one raises instead of running somewhere else.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

DEFAULT = 'cuda'


def resolve(device=DEFAULT, hint: str = "device='cpu'") -> torch.device:
    """`device` as a torch.device; raises if it is a CUDA device and there
    is none.  `hint` names how the caller asks for the CPU instead."""
    dev = torch.device(device)
    if dev.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(f'no CUDA device for {str(dev)!r}: pass {hint} '
                           f'to run on the CPU')
    return dev


_CONSTANTS: Dict[tuple, torch.Tensor] = {}


def constant(array, dtype: torch.dtype, device) -> torch.Tensor:
    """A host array's values as a tensor on `device`, copied there once per
    (values, dtype, device) and reused after: a call that runs inside a
    CUDA graph capture may not copy from pageable host memory, and a
    replay would not repeat the copy anyway.  For small arrays (filter
    taps, index vectors); the values key the cache."""
    a = np.ascontiguousarray(array)
    dev = torch.device(device)
    key = (a.tobytes(), a.shape, a.dtype.str, dtype, str(dev))
    t = _CONSTANTS.get(key)
    if t is None:
        t = torch.from_numpy(a.copy()).to(dtype=dtype, device=dev)
        _CONSTANTS[key] = t
    return t


def to_host_async(tensors: Dict[str, torch.Tensor]
                  ) -> Tuple[Dict[str, torch.Tensor], Optional[torch.cuda.Event]]:
    """Start copying CUDA tensors into pinned host buffers on the current
    stream; returns the host tensors and the event to wait on before
    reading them.  CPU tensors come back as copies, with no event: either
    way the host tensors keep the values of the call, whatever later
    writes the sources (a graph replay's static outputs, utils/graphs.py).
    """
    if not tensors or next(iter(tensors.values())).device.type != 'cuda':
        return {k: v.clone() for k, v in tensors.items()}, None
    host = {}
    for k, v in tensors.items():
        h = torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
        h.copy_(v, non_blocking=True)
        host[k] = h
    event = torch.cuda.Event()
    event.record()
    return host, event
