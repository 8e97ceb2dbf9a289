"""PyTorch port, kernel K2: take_along_axis over a 2-D float32 operand
(scripts/probe_warp.py:118, probe_dyngather's `kern`).

The plain version must equal numpy's and JAX's take_along_axis and an
interpret-mode pallas_call of the probe's kernel body bit for bit -- a
gather moves values and computes nothing.  Shapes: the probe's six, and
the Farneback warp's full level (both fields' 2 x 252 x 840 rows of 20 in
one call, axis 0, one index per row broadcast as a stride-0 view)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from ld_decode_tpu_torch.ops import cuda_gather
from ld_decode_tpu_torch.ops import gather as G

torch.set_num_threads(2)

# scripts/probe_warp.py:112-113
PROBE = [((8, 128), 1), ((64, 128), 1), ((256, 128), 1), ((8, 128), 0),
         ((128, 128), 0), ((512, 512), 1)]
WARP_ROWS = 2 * 252 * 840       # both fields of the warp's full level


def _probe_case(shape, axis, seed=2):
    rng = np.random.default_rng(seed)
    op = rng.normal(0, 1, shape).astype(np.float32)
    # indices in [0, min(dim, 128)) as the probe draws them (:115-116)
    idx = rng.integers(0, min(shape[axis], 128), shape).astype(np.int32)
    return op, idx


def _pallas_take(op, idx, axis):
    """The probe's kernel body (a closure there, so rebuilt here) run by
    pallas_call in interpret mode on the CPU."""
    def kern(op_ref, idx_ref, out_ref):
        out_ref[...] = jnp.take_along_axis(op_ref[...], idx_ref[...],
                                           axis=axis)
    return np.asarray(pl.pallas_call(
        kern, out_shape=jax.ShapeDtypeStruct(idx.shape, jnp.float32),
        interpret=True)(op, idx))


@pytest.mark.parametrize('shape,axis', PROBE)
def test_plain_equals_numpy_jax_and_pallas(shape, axis):
    op, idx = _probe_case(shape, axis)
    got = G.take_along_axis(torch.from_numpy(op), torch.from_numpy(idx),
                            axis).numpy()
    want = np.take_along_axis(op, idx, axis)
    np.testing.assert_array_equal(got, want)
    with jax.enable_x64(False):
        np.testing.assert_array_equal(
            got, np.asarray(jnp.take_along_axis(jnp.asarray(op),
                                                jnp.asarray(idx), axis)))
        np.testing.assert_array_equal(got, _pallas_take(op, idx, axis))


def test_plain_warp_gather_stride0_index():
    """The warp's gather: (423,360, 20) rows, one index per row broadcast
    across the row without materialising it, equal to the JAX warp's flat
    `jnp.take(Rq, rows, axis=0)` (comb/optflow.py:160)."""
    rng = np.random.default_rng(5)
    op = rng.normal(0, 1, (WARP_ROWS, 20)).astype(np.float32)
    rows = rng.integers(0, WARP_ROWS, WARP_ROWS).astype(np.int32)
    idx = torch.from_numpy(rows)[:, None].expand(WARP_ROWS, 20)
    assert idx.stride() == (1, 0)
    got = G.take_along_axis(torch.from_numpy(op), idx, 0).numpy()
    np.testing.assert_array_equal(got, op[rows])
    with jax.enable_x64(False):
        np.testing.assert_array_equal(
            got, np.asarray(jnp.take(jnp.asarray(op), jnp.asarray(rows),
                                     axis=0)))


def test_plain_clamps_stray_indices():
    op = np.arange(12, dtype=np.float32).reshape(3, 4)
    idx = np.array([[-1, 0, 3, 9]], np.int32)
    got = G.take_along_axis(torch.from_numpy(op), torch.from_numpy(idx),
                            0).numpy()
    np.testing.assert_array_equal(got, [[0, 1, 10, 11]])


def test_dispatch_cpu_plain_and_other_devices_raise():
    op, idx = _probe_case((64, 128), 1)
    before = cuda_gather.take_along_axis.launches
    G.take_along_axis(torch.from_numpy(op), torch.from_numpy(idx), 1)
    assert cuda_gather.take_along_axis.launches == before
    with pytest.raises(ValueError, match='no kernel'):
        G.take_along_axis(torch.zeros((4, 4), device='meta'),
                          torch.zeros((4, 4), dtype=torch.int32,
                                      device='meta'), 0)
    with pytest.raises(ValueError, match='not a CUDA device'):
        cuda_gather.take_along_axis(torch.from_numpy(op),
                                    torch.from_numpy(idx), 1)


@pytest.mark.cuda
@pytest.mark.parametrize('shape,axis', PROBE + [((WARP_ROWS, 20), 0)])
def test_kernel_equals_plain_on_card(shape, axis):
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device: the kernel has no CPU mode')
    op, idx = _probe_case(shape, axis)
    op_d = torch.from_numpy(op).cuda()
    idx_d = torch.from_numpy(idx).cuda()
    if shape[0] == WARP_ROWS:
        idx_d = idx_d[:, :1].expand(shape)
    before = cuda_gather.take_along_axis.launches
    got = G.take_along_axis(op_d, idx_d, axis)
    assert cuda_gather.take_along_axis.launches == before + 1
    want = G.take_along_axis_plain(op_d, idx_d, axis)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert torch.equal(got, torch.take_along_dim(op_d, idx_d.long(), axis))
