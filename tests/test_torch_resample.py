"""PyTorch port: the line resample (kernel K1's plain version and its
dispatcher) against the JAX XLA gather and the interpret-mode Pallas
kernel; the CUDA kernel against the plain version on a card."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ld_decode_tpu.tbc import resample as JR
from ld_decode_tpu.tbc.pallas_resample import resample_lines_batch as pallas
from ld_decode_tpu_torch.tbc import cuda_resample as CR
from ld_decode_tpu_torch.tbc import resample as TR

torch.set_num_threads(2)

# K1 vs JAX: the budget of tests/test_pallas_resample.py
TOL_MAX = 1e-2
TOL_MEAN = 1e-4


def _case(seed, B, nsamp, nlines, linelen):
    rng = np.random.default_rng(seed)
    data = rng.standard_normal((B, nsamp)).astype(np.float32)
    ll = (np.arange(nlines + 4) * linelen + 1500.0
          + np.cumsum(rng.uniform(-1, 1, nlines + 4)) * 0.2)
    ll = np.tile(ll[None], (B, 1)) + rng.uniform(0, 1, (B, 1))
    lli = np.floor(ll).astype(np.int32)
    llf = (ll - np.floor(ll)).astype(np.float32)
    return data, lli, llf


def _jax_refs(data, lli, llf, outwidth, nlines, linelen, col0, ncols):
    with jax.enable_x64(False):
        def one(d, i_, f_):
            gaps = (i_[1:] - i_[:-1]).astype(jnp.float32) + (f_[1:] - f_[:-1])
            wow = (gaps[:nlines] / linelen).astype(jnp.float32)
            return JR.downscale_lines_split(d, i_, f_, outwidth, nlines, wow,
                                            col0=col0, ncols=ncols)
        xla = np.asarray(jax.vmap(one)(jnp.asarray(data), jnp.asarray(lli),
                                       jnp.asarray(llf)))
        pl = np.asarray(pallas(jnp.asarray(data), jnp.asarray(lli),
                               jnp.asarray(llf), outwidth, nlines, linelen,
                               interpret=True, col0=col0, ncols=ncols))
    return xla, pl


@pytest.mark.parametrize('outwidth,linelen,col0,ncols', [
    (910, 2542.27, 0, None),       # NTSC picture
    (1135, 2560.0, 0, None),       # PAL width
    (910, 2542.27, 16, 48),        # the burst refiner's 48-column window
])
def test_plain_matches_jax(outwidth, linelen, col0, ncols):
    nlines = 40
    data, lli, llf = _case(7, 2, 1 << 18, nlines, linelen)
    xla, pl = _jax_refs(data, lli, llf, outwidth, nlines, linelen, col0,
                        ncols)
    got = CR.resample_lines_batch(torch.from_numpy(data),
                                  torch.from_numpy(lli),
                                  torch.from_numpy(llf), outwidth, nlines,
                                  linelen, col0=col0, ncols=ncols).numpy()
    assert got.shape == xla.shape == pl.shape \
        == (2, nlines, ncols or outwidth)
    for ref in (xla, pl):
        d = np.abs(got - ref)
        assert d.max() < TOL_MAX and d.mean() < TOL_MEAN


def test_window_equals_slice_of_full_resample():
    """col0/ncols positions are identical to slicing the full resample."""
    data, lli, llf = _case(3, 2, 1 << 17, 20, 2542.27)
    args = (torch.from_numpy(data), torch.from_numpy(lli),
            torch.from_numpy(llf), 910, 20, 2542.0)
    full = CR.resample_lines_batch(*args)
    win = CR.resample_lines_batch(*args, col0=16, ncols=48)
    assert torch.equal(win, full[..., 16:64])


def test_edge_lines_clipped_not_crashing():
    """Lines whose windows fall outside the stream give finite output."""
    nsamp, nlines, linelen = 1 << 15, 8, 2542.27
    data = torch.ones((1, nsamp))
    ll = np.arange(nlines + 2) * linelen + (nsamp - 3 * linelen)
    lli = torch.from_numpy(np.floor(ll).astype(np.int32))[None]
    llf = torch.from_numpy((ll - np.floor(ll)).astype(np.float32))[None]
    got = CR.resample_lines_batch(data, lli, llf, 910, nlines, linelen)
    assert torch.isfinite(got).all()


def test_cpu_dispatch_takes_plain_version():
    """A CPU tensor takes the plain version and launches nothing."""
    data, lli, llf = _case(1, 2, 1 << 16, 10, 2542.27)
    before = CR.resample_lines_batch.launches
    wbefore = CR.resample_lines_batch.window_launches
    args = (torch.from_numpy(data), torch.from_numpy(lli),
            torch.from_numpy(llf), 910, 10, 2542.0)
    got = CR.resample_lines_batch(*args)
    CR.resample_lines_batch(*args, col0=16, ncols=48)
    assert CR.resample_lines_batch.launches == before
    assert CR.resample_lines_batch.window_launches == wbefore
    assert torch.equal(got, CR.resample_lines_batch_plain(*args))


def test_other_devices_raise():
    """No device other than the CPU and CUDA falls back to anything."""
    data = torch.zeros((1, 4096), device='meta')
    lli = torch.zeros((1, 12), dtype=torch.int32, device='meta')
    llf = torch.zeros((1, 12), device='meta')
    with pytest.raises(ValueError, match='no kernel for device'):
        CR.resample_lines_batch(data, lli, llf, 910, 10, 2542.0)


def test_catmull_rom_weights_partition_unity():
    t = torch.linspace(0, 1, 101)
    w = TR.catmull_rom_weights(t)
    assert torch.allclose(sum(w), torch.ones_like(t), atol=1e-6)


def test_strided_tables_equal_contiguous():
    """Line tables read through views (the picture call's lli[:, 1:],
    llf[:, 1:]) give what contiguous copies give."""
    data, lli, llf = _case(5, 2, 1 << 17, 30, 2542.27)
    data, lli, llf = (torch.from_numpy(a) for a in (data, lli, llf))
    view_i, view_f = lli[:, 1:], llf[:, 1:]
    assert not view_i.is_contiguous()
    for kw in ({}, dict(col0=16, ncols=48)):
        got = CR.resample_lines_batch(data, view_i, view_f, 910, 30, 2542.0,
                                      **kw)
        want = CR.resample_lines_batch(data, view_i.contiguous(),
                                       view_f.contiguous(), 910, 30, 2542.0,
                                       **kw)
        assert torch.equal(got, want)


@pytest.mark.parametrize('ncols,outwidth,st_nom,group', [
    (910, 910, 2542.0, 128),       # NTSC picture: 4 warps a line
    (48, 910, 2542.0, 32),         # burst window: a warp a line
    (1135, 1135, 2560.0, 128),     # PAL width
    (200, 910, 2542.0, 64),
])
def test_launch_plan_stages_nominal_lines(ncols, outwidth, st_nom, group):
    """A group of warps a line, a whole number of lines a block, and a
    span buffer that holds a line up to 1.25x nominal length (its taps
    and the widening to 16-byte chunks) within the 48 KB a block has."""
    g, cap = CR.launch_plan(ncols, outwidth, st_nom)
    assert g == group and 128 % g == 0 and cap % 4 == 0
    assert cap >= 1.25 * st_nom * (ncols - 1) / outwidth + 11
    assert (128 // g) * cap * 4 <= 48 * 1024


def _card_case(name):
    """Inputs of a card case: the main paths' shapes, or tables that leave
    the staged path (broken lines, lines past both row ends) or are read
    through views."""
    linelen, W, nlines = 2542.0, 910, 263
    if name == 'pal':
        linelen, W, nlines = 2560.0, 1135, 313
    nsamp = 52 * 15328
    data, lli, llf = _case(11, 4, nsamp, nlines, linelen)
    if name == 'broken':
        lli[:, [5, 6]] = lli[:, [6, 5]]          # steplen < 0
        lli[:, 21:] += int(2 * linelen)          # a span past the buffer
        llf[:, 40] = 7.5
    if name == 'ends':
        ll = np.arange(nlines + 4) * linelen - 1.5 * linelen
        ll[nlines // 2:] += nsamp - nlines * linelen + 6000
        lli = np.tile(np.floor(ll).astype(np.int32), (4, 1))
        llf = np.tile((ll - np.floor(ll)).astype(np.float32), (4, 1))
    t = [torch.from_numpy(a).cuda() for a in (data, lli, llf)]
    if name == 'views':
        t[1], t[2] = t[1][:, 1:], t[2][:, 1:]
    return t, W, nlines, linelen


@pytest.mark.cuda
@pytest.mark.parametrize('name,col0,ncols', [
    ('picture', 0, None), ('burst', 16, 48), ('pal', 0, None),
    ('broken', 0, None), ('broken', 16, 48), ('ends', 0, None),
    ('ends', 16, 48), ('views', 0, None)])
def test_cuda_kernel_matches_plain(name, col0, ncols):
    """On a card: the kernel against the plain version on the same
    inputs, bit for bit, at the main paths' shapes and where lines leave
    the staged path."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device (the kernel has no CPU mode)')
    (data, lli, llf), W, nlines, linelen = _card_case(name)
    args = (data, lli, llf, W, nlines, linelen)
    before = CR.resample_lines_batch.launches
    wbefore = CR.resample_lines_batch.window_launches
    got = CR.resample_lines_batch(*args, col0=col0, ncols=ncols)
    ref = CR.resample_lines_batch_plain(*args, col0=col0, ncols=ncols)
    torch.cuda.synchronize()
    assert CR.resample_lines_batch.launches == before + 1
    assert CR.resample_lines_batch.window_launches == \
        wbefore + (ncols is not None)
    assert torch.equal(got, ref)
