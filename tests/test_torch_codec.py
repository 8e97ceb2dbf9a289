"""PyTorch port: the lossless transport codec (tbc/codec.py) against the
JAX package's (ld_decode_tpu/tbc/fused.py), and its decoders.

Budgets: every device output exactly equal to JAX's on seeded images:
the planes, the 6-bit tables, the quotient streams and their used words,
the packed tables, the block ranks and the compacted buffers with their
counts; the numpy decode copied from JAX and the native decoder built from
csrc/codec_decode.cpp invert the encode losslessly.  The images: NTSC-like
(k=2) and PAL-like (k=4) pictures, RGB (k=1 with the horizontal pass),
white noise, a flat image and blocks whose outliers take the Rice
escape."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ld_decode_tpu.tbc import fused as JFU
from ld_decode_tpu_torch.tbc import codec as TC
from ld_decode_tpu_torch.tbc import fused as TFU
from ld_decode_tpu_torch.tbc import native_codec as NC

torch.set_num_threads(2)


def _image(kind: str, R: int, C: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if kind == 'noise':
        return rng.integers(0, 65536, (R, C)).astype(np.int32)
    if kind == 'flat':
        return np.full((R, C), 0x3000, np.int32)
    if kind == 'outlier':
        x = 0x3000 + rng.integers(-3, 4, (R, C))
        x[::7, ::31] += 3000                    # sparse 12-bit spikes
        return x.astype(np.int32)
    # a picture-like image: sync, a 4fsc subcarrier, a ramp, mild noise
    w = np.arange(C)
    line = 0x3C00 + (w * 45) % 9000 \
        + (7000 * np.sin(w * np.pi / 2 + 0.3)).astype(np.int64)
    line[:20] = 0x0400
    x = np.tile(line, (R, 1)) + rng.integers(-40, 40, (R, C))
    return (x & 0xFFFF).astype(np.int32)


# name: (kind, rows, columns, lag k, horizontal pass)
CASES = {
    'ntsc': ('picture', 42, 912, 2, False),
    'pal': ('picture', 40, 1136, 4, False),
    'rgb': ('picture', 3 * 16, 752, 1, True),
    'noise': ('noise', 24, 96, 2, False),
    'flat': ('flat', 20, 48, 2, False),
    'outlier': ('outlier', 40, 96, 2, False),
}


_j_encode = jax.jit(JFU.encode_image_planes, static_argnums=(1, 2))


def _jax_encode(x, k, hpass):
    with jax.enable_x64(False):
        out = _j_encode(jnp.asarray(x), k, hpass)
        return [np.asarray(a) for a in out]


@pytest.mark.parametrize('name', list(CASES))
def test_encode_image_planes_equal(name):
    kind, R, C, k, hpass = CASES[name]
    x = _image(kind, R, C, seed=len(name))
    planes, tab, qstream, qwords = TC.encode_image_planes(
        torch.from_numpy(x), k, hpass)
    jp, jt, jq, jw = _jax_encode(x, k, hpass)
    np.testing.assert_array_equal(planes.numpy().astype(np.uint16), jp)
    np.testing.assert_array_equal(tab.numpy(), jt)
    np.testing.assert_array_equal(qstream.numpy().astype(np.uint16), jq)
    assert int(qwords) == int(jw)
    with jax.enable_x64(False):
        jpt = np.asarray(jax.jit(JFU.pack_tab)(jnp.asarray(jt)))
    np.testing.assert_array_equal(
        TC.pack_tab(tab).numpy().astype(np.uint16), jpt)
    if name == 'outlier':
        assert (jt >> 5).sum() > 100            # the Rice escape taken
    if name == 'noise':
        assert ((jt & 0x1F) >= 15).mean() > 0.9     # ~all 16 planes


def test_bit_transpose_popcount_and_rice_costs():
    rng = np.random.default_rng(3)
    zb = rng.integers(0, 65536, (50, 16)).astype(np.int32)
    zb[0] = 0
    zb[1] = 0xFFFF
    with jax.enable_x64(False):
        jt = np.asarray(jax.jit(JFU._bit_transpose16)(jnp.asarray(zb)))
        jc = np.asarray(jax.jit(JFU._popcount16)(jnp.asarray(jt)))
    tt = TC._bit_transpose16(torch.from_numpy(zb))
    np.testing.assert_array_equal(tt.numpy(), jt)
    np.testing.assert_array_equal(TC._popcount16(tt).numpy(), jc)
    # the definition: out[p] bit i = input i's bit p
    want = sum(((zb >> np.arange(16)[:, None, None]).transpose(1, 0, 2)
                & 1)[..., i] << i for i in range(16))
    np.testing.assert_array_equal(jt, want)
    c = rng.integers(0, 17, (40, 16)).astype(np.int32)
    np.testing.assert_array_equal(
        TC._rice_costs(torch.from_numpy(c)).numpy(),
        16 * (np.arange(16) + 1) + c @ TC._RICE_M.T)
    np.testing.assert_array_equal(TC._RICE_M, JFU._RICE_M)


@pytest.mark.parametrize('n', [1, 300, 1000])
def test_block_rank_equal(n):
    rng = np.random.default_rng(n)
    nw = rng.integers(0, 17, n).astype(np.int32)
    nw[: n // 3] = 16
    with jax.enable_x64(False):
        jr, jg = [np.asarray(a)
                  for a in jax.jit(JFU._block_rank)(jnp.asarray(nw))]
    tr, tg = TC._block_rank(torch.from_numpy(nw)[None])
    nr, ng = TC._block_rank_np(nw)
    for got in ((tr[0].numpy(), tg[0].numpy()), (nr, ng)):
        np.testing.assert_array_equal(got[0], jr)
        np.testing.assert_array_equal(got[1], jg)
    assert sorted(jr.tolist()) == list(range(n))


def _batch(names, seed=5):
    """Images of one shape (B, R, C) from the picture-like generator with
    other kinds mixed in."""
    R, C = 40, 96
    return np.stack([_image(k, R, C, seed + i) for i, k in enumerate(names)])


def test_compactions_equal():
    imgs = _batch(['picture', 'noise', 'flat', 'outlier'])
    B, R, C = imgs.shape
    NB = C // 16
    planes, tab, qs, qw = TC.encode_image_planes(torch.from_numpy(imgs), 2)
    cap = TC.codec_cap_words(R * NB, B)
    qcap = TC.codec_qcap_words(R, NB) * B
    dense, rows = TC.compact_planes(planes, tab, cap)
    dq, qw2 = TC.compact_qstreams(qs, qw, qcap)

    @jax.jit
    def jax_side(x):
        jp, jt, jq, jw = jax.vmap(lambda im: JFU.encode_image_planes(
            im, 2))(x)
        return JFU.compact_planes(jp, jt, cap) \
            + JFU.compact_qstreams(jq, jw, qcap)

    with jax.enable_x64(False):
        jd, jr, jdq, jqw = (np.asarray(a)
                            for a in jax_side(jnp.asarray(imgs)))
    np.testing.assert_array_equal(rows.numpy(), jr)
    np.testing.assert_array_equal(qw2.numpy(), jqw)
    n, nq = int(jr.sum()), int(jqw.sum())
    assert 0 < n < cap and 0 < nq < qcap
    # the used prefixes (the host reads nothing past them) ...
    np.testing.assert_array_equal(dense.numpy()[:n].astype(np.uint16),
                                  jd[:n])
    np.testing.assert_array_equal(dq.numpy()[:nq].astype(np.uint16),
                                  jdq[:nq])
    # ... and the fill past them, unit 0 repeated as nonzero(fill_value=0)
    np.testing.assert_array_equal(dense.numpy().astype(np.uint16), jd)
    np.testing.assert_array_equal(dq.numpy().astype(np.uint16), jdq)
    # the wire payload: 16-bit words as int16
    pay = TC.encode_image_payload(torch.from_numpy(imgs), 2)
    assert {k: v.dtype for k, v in pay.items()} == {
        'tab': torch.int16, 'dense': torch.int16, 'dense_q': torch.int16,
        'rows2': torch.int32}
    np.testing.assert_array_equal(pay['dense'].numpy().view(np.uint16), jd)
    np.testing.assert_array_equal(pay['rows2'].numpy(), np.stack([jr, jqw]))


def _roundtrip(imgs, k, hpass, route):
    """Encode a batch, then decode each image from its region of the
    buffers through decode_payload on `route`."""
    NC.set_native(route == 'native')
    try:
        assert NC.route() == route
        pay = {key: v.numpy() for key, v in TC.encode_image_payload(
            torch.from_numpy(imgs), k, hpass).items()}
        rows2 = pay['rows2'].astype(np.int64)
        dense = pay['dense'].view(np.uint16)
        dq = pay['dense_q'].view(np.uint16)
        offs = np.concatenate([[0], np.cumsum(rows2[0])])
        offs_q = np.concatenate([[0], np.cumsum(rows2[1])])
        for b in range(imgs.shape[0]):
            img, got = TC.decode_payload(
                pay['tab'][b].view(np.uint16), dense[offs[b]:offs[b + 1]],
                dq[offs_q[b]:offs_q[b + 1]], imgs.shape[1:], k, hpass,
                int(rows2[0, b]))
            assert got == route
            np.testing.assert_array_equal(img, imgs[b].astype(np.uint16))
        # a count that disagrees with the table fails the gate
        img, _ = TC.decode_payload(
            pay['tab'][0].view(np.uint16), dense[:offs[1]],
            dq[:offs_q[1]], imgs.shape[1:], k, hpass, int(rows2[0, 0]) + 32)
        assert img is None
    finally:
        NC.set_native(True)


@pytest.mark.parametrize('route', ['native', 'numpy'])
@pytest.mark.parametrize('name', ['ntsc', 'pal', 'rgb', 'outlier'])
def test_roundtrip_lossless(name, route):
    kind, R, C, k, hpass = CASES[name]
    imgs = np.stack([_image(kind, R, C, 11), _image('noise', R, C, 12),
                     _image('flat', R, C, 13)])
    _roundtrip(imgs, k, hpass, route)


def test_cap_words_rounds_up_to_the_unit():
    """nblocks % 32 != 0: the capacity rounds each image's blocks up to
    the 32-word unit (an unrounded cap would cut a white-noise image's
    trailing units), and white noise at that size round-trips."""
    R, C = 7, 48                                   # 21 blocks
    assert TC.codec_cap_words(21) == 16 * 32 == JFU.codec_cap_words(21)
    assert TC.codec_cap_words(21, 3) == JFU.codec_cap_words(21, 3)
    assert TC.codec_cap_words(64, 2) == 16 * 64 * 2
    imgs = np.stack([_image('noise', R, C, 20 + i) for i in range(3)])
    _roundtrip(imgs, 2, False, 'native')


@pytest.mark.parametrize('system', ['NTSC', 'PAL'])
def test_picture_params_and_decode_equal(system):
    """The picture geometry, the capacities and the copied host decoders
    against JAX's on one field-sized picture."""
    from ld_decode_tpu.utils.params import DecoderConfig as JConfig
    from ld_decode_tpu_torch.utils.params import DecoderConfig as TConfig
    jcfg, tcfg = JConfig(system=system), TConfig(system=system)
    assert TFU.pic_codec_params(tcfg) == JFU.pic_codec_params(jcfg)
    assert TFU.codec_cap_rows(tcfg, 3) == JFU.codec_cap_rows(jcfg, 3)
    L, W, Wp, _, k = TFU.pic_codec_params(tcfg)
    NB = Wp // 16
    assert TFU.codec_qcap_words(L, NB) == JFU.codec_qcap_words(L, NB)
    assert TFU.bcls_words(L, NB) == JFU.bcls_words(L, NB)
    pic = _image('picture', L, W, 30)
    planes, tab, qs, qw = TFU.encode_picture_planes(
        torch.from_numpy(pic), tcfg)
    dense, rows = TFU.compact_planes(planes, tab, TFU.codec_cap_rows(tcfg, 1))
    dq, _ = TFU.compact_qstreams(qs, qw, TFU.codec_qcap_words(L, NB))
    tabw = TFU.pack_tab(tab[0]).numpy().astype(np.uint16)
    t_tab = TFU.unpack_tab(tabw, L, NB)
    np.testing.assert_array_equal(t_tab, JFU.unpack_tab(tabw, L, NB))
    np.testing.assert_array_equal(t_tab, tab[0].numpy())
    d = dense.numpy().astype(np.uint16)[:int(rows[0])]
    q = dq.numpy().astype(np.uint16)[:int(qw[0])]
    got = TFU.decode_picture_planes(t_tab, d, q, tcfg)
    np.testing.assert_array_equal(got, pic.reshape(-1).astype(np.uint16))
    np.testing.assert_array_equal(
        got, JFU.decode_picture_planes(t_tab, d, q, jcfg))
    assert TFU.shipped_plane_words_np(t_tab & 0x1F) == int(rows[0]) \
        == JFU.shipped_plane_words_np(t_tab & 0x1F)
