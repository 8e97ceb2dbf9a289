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


def _row_case(n, cols, view, seed=9, device='cpu'):
    """An axis-0 gather of n rows with one index per row broadcast
    (stride 0), indices a little past both ends (clamped); the operand
    (n, cols) is a fresh tensor ('warp'), a view 3 rows into a larger one
    ('offset', still 16-byte aligned) or a view 4 bytes off alignment
    ('unaligned')."""
    rng = np.random.default_rng(seed)
    big = torch.from_numpy(rng.normal(0, 1, (n + 3) * cols + 1)
                           .astype(np.float32)).to(device)
    if view == 'warp':
        op = big[:n * cols].view(n, cols).clone()
    elif view == 'offset':
        op = big[:(n + 3) * cols].view(n + 3, cols)[3:]
    else:
        op = big[1:].view(n + 3, cols)[:n]
    rows = rng.integers(-3, n + 3, (n, 1)).astype(np.int32)
    return op, torch.from_numpy(rows).to(device).expand(n, cols)


@pytest.mark.parametrize('view,cols,axis,rows_path', [
    ('warp', 20, 0, True),           # the warp's call
    ('offset', 20, 0, True),         # aligned view
    ('unaligned', 20, 0, False),     # 4 bytes off a 16-byte boundary
    ('warp', 18, 0, False),          # width not a multiple of 4
    ('warp', 20, 1, False),          # axis 1
    ('full', 20, 0, False),          # an index per element
    ('strided', 20, 0, False),       # a non-contiguous operand
    ('out4', 20, 0, False),          # output 4 bytes off alignment
])
def test_row_gather_path_choice(view, cols, axis, rows_path):
    """The wrapper's path choice reads only shapes, strides and
    addresses, so it is decided here on the CPU as on the card."""
    op, idx = _row_case(40, cols, view if view in ('offset', 'unaligned')
                        else 'warp')
    out = torch.empty(idx.shape)
    if view == 'full':
        idx = idx.contiguous()
    elif view == 'strided':
        op = torch.zeros((40, 2 * cols))[:, :cols]
    elif view == 'out4':
        out = torch.empty(40 * cols + 1)[1:].view(40, cols)
    assert cuda_gather.row_gather_ok(op, idx, axis, out) == rows_path


def test_warp_gather_takes_row_path(monkeypatch):
    """The Farneback warp's own call (comb/optflow.py::_bilinear_gather_quad,
    both fields in one gather) qualifies for the row-gather path."""
    from ld_decode_tpu_torch.comb import optflow as TO
    rng = np.random.default_rng(4)
    b, h, w, c = 2, 6, 8, 5
    Rq = torch.from_numpy(rng.normal(0, 1, (b, h * w, 4 * c))
                          .astype(np.float32))
    fx = torch.from_numpy(rng.uniform(0, w, (b, h, w)).astype(np.float32))
    fy = torch.from_numpy(rng.uniform(0, h, (b, h, w)).astype(np.float32))
    calls = []

    def spy(op, idx, axis):
        calls.append((op, idx, axis))
        return G.take_along_axis(op, idx, axis)

    monkeypatch.setattr(TO, 'take_along_axis', spy)
    TO._bilinear_gather_quad(Rq, h, w, c, fx, fy)
    (op, idx, axis), = calls
    assert cuda_gather.row_gather_ok(op, idx, axis, torch.empty(idx.shape))


# the card cases: the probe's shapes (a full index), the warp's three
# pyramid levels, and the row path's edges
CARD = [(shape, axis, 'full') for shape, axis in PROBE] + [
    ((2 * 252 * 840, 20), 0, 'warp'), ((2 * 126 * 420, 20), 0, 'warp'),
    ((2 * 63 * 210, 20), 0, 'warp'),
    ((4099, 20), 0, 'warp'),           # not a whole number of tiles
    ((4099, 20), 0, 'offset'),         # width 20 on an offset view
    ((4099, 20), 0, 'unaligned'),      # general path
    ((4099, 18), 0, 'warp'),           # general path
]


@pytest.mark.cuda
@pytest.mark.parametrize('shape,axis,view', CARD)
def test_kernel_equals_plain_on_card(shape, axis, view):
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device: the kernel has no CPU mode')
    if view == 'full':
        op_d, idx_d = (torch.from_numpy(a).cuda()
                       for a in _probe_case(shape, axis))
    else:
        op_d, idx_d = _row_case(shape[0], shape[1], view, device='cuda')
    expect_rows = cuda_gather.row_gather_ok(
        op_d, idx_d, axis, torch.empty(idx_d.shape, device='cuda'))
    assert expect_rows == (view in ('warp', 'offset')
                           and shape[1] % 4 == 0)
    before = cuda_gather.take_along_axis.launches
    rows0 = cuda_gather.take_along_axis.row_launches
    got = G.take_along_axis(op_d, idx_d, axis)
    assert cuda_gather.take_along_axis.launches == before + 1
    assert cuda_gather.take_along_axis.row_launches == rows0 + expect_rows
    want = G.take_along_axis_plain(op_d, idx_d, axis)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    lidx = idx_d.long().clamp(0, op_d.shape[axis] - 1)
    assert torch.equal(got, torch.take_along_dim(op_d, lidx, axis))
