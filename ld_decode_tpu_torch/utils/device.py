"""Device selection and device-to-host copies.

The port's entry points run on the card by default.  A caller that wants
the CPU asks for it (`device='cpu'`); asking for a CUDA device on a machine
without one raises instead of running somewhere else.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

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


def to_host_async(tensors: Dict[str, torch.Tensor]
                  ) -> Tuple[Dict[str, torch.Tensor], Optional[torch.cuda.Event]]:
    """Start copying CUDA tensors into pinned host buffers on the current
    stream; returns the host tensors and the event to wait on before
    reading them.  CPU tensors come back as they are, with no event."""
    if not tensors or next(iter(tensors.values())).device.type != 'cuda':
        return tensors, None
    host = {}
    for k, v in tensors.items():
        h = torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
        h.copy_(v, non_blocking=True)
        host[k] = h
    event = torch.cuda.Event()
    event.record()
    return host, event
