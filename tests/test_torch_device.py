"""PyTorch port: utils/device.py.  `to_host_async` is the one route by
which the batch call's outputs, the pictures among them, and the combs'
RGB windows reach the host: the host copies keep the values of the call
whatever later writes their sources, as a CUDA graph's replay writes its
static outputs.  `constant` copies a host array to the device once, and
`resolve` refuses a CUDA device where there is none."""

import numpy as np
import pytest
import torch

from ld_decode_tpu_torch.utils.device import (constant, resolve,
                                              to_host_async)


def _sources(dtype, device='cpu'):
    g = torch.Generator().manual_seed(3)
    a = torch.randint(0, 200, (4, 263, 16), generator=g).to(dtype)
    b = torch.randint(0, 200, (7,), generator=g).to(dtype)
    return {'picture': a.to(device), 'meta': b.to(device)}


@pytest.mark.parametrize('dtype', [torch.int32, torch.float32, torch.uint8],
                         ids=['int32', 'float32', 'uint8'])
def test_copies_outlive_their_sources(dtype):
    src = _sources(dtype)
    want = {k: v.clone() for k, v in src.items()}
    host, event = to_host_async(src)
    assert event is None and list(host) == list(src)
    for v in src.values():
        v.fill_(7)
    for k, v in host.items():
        assert v.dtype == dtype and v.device.type == 'cpu'
        assert torch.equal(v, want[k])
        assert v.data_ptr() != src[k].data_ptr()


def test_empty_dict():
    assert to_host_async({}) == ({}, None)


@pytest.mark.cuda
def test_card_copies_are_pinned_and_ordered():
    """On the card: pinned host buffers, an event to wait on, and the
    values of the call although the sources are overwritten right after
    on the same stream."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device: pinned copies and events')
    src = _sources(torch.int32, 'cuda')
    want = {k: v.cpu() for k, v in src.items()}
    host, event = to_host_async(src)
    for v in src.values():
        v.fill_(7)
    assert event is not None
    event.synchronize()
    for k, v in host.items():
        assert v.is_pinned() and torch.equal(v, want[k])


def test_constant_is_copied_once():
    """One tensor a (values, dtype, device): a capture may not copy from
    pageable memory, so a second call must not copy again."""
    a = constant([1.5, 2.0, 3.0], torch.float32, 'cpu')
    assert constant(np.array([1.5, 2.0, 3.0]), torch.float32, 'cpu') is a
    assert torch.equal(a, torch.tensor([1.5, 2.0, 3.0]))
    b = constant([1.5, 2.0, 4.0], torch.float32, 'cpu')
    c = constant([1.5, 2.0, 3.0], torch.float64, 'cpu')
    assert b is not a and c is not a and c.dtype == torch.float64
    src = np.array([7, 8], np.int32)
    d = constant(src, torch.int32, 'cpu')
    src[0] = 9                                  # the cache holds a copy
    assert d.tolist() == [7, 8]


def test_resolve():
    assert resolve('cpu') == torch.device('cpu')
    if torch.cuda.is_available():
        assert resolve().type == 'cuda'
        return
    with pytest.raises(RuntimeError, match="pass device='cpu'"):
        resolve()
    with pytest.raises(RuntimeError, match='--device cpu'):
        resolve('cuda:0', hint='--device cpu')
