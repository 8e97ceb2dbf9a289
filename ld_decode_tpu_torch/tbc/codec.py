"""The lossless transport codec of pictures and RGB frames (torch port of
the codec in ld_decode_tpu/tbc/fused.py; `fused.py` re-exports it).

The JAX package built it for a slow device link: a picture leaves the
device as per-16-sample-block bit planes plus a Rice escape, and the host
copies only the used prefix of the compacted buffers.  The wire format is
fixed by csrc/codec_decode.cpp (a copy of the JAX package's
native/codec_decode.cpp), so every device step here produces the JAX
package's integers exactly:

  transform   zigzagged mod-2^16 vertical delta against line l-k (k=2 NTSC,
              4 PAL, 1 for RGB); the first k lines a horizontal lag-1 delta;
              `hpass` adds a horizontal pass over the body rows;
  blocks      each 16-sample block ships either its bits(max z) one-bit
              planes or, when the exact Rice cost is lower and fits 64
              quotient bits, k* low planes plus unary quotients on a
              per-image bitstream; a 6-bit table value a block says which;
  compaction  blocks ranked by (planes DESC, index ASC), so plane p is the
              prefix of cnt[p] ranked blocks; the used 32-word units of a
              whole batch (8-word units of the quotient streams) land in one
              contiguous buffer.

Device encode (batched over images; 16-bit wire words leave the device as
int16 and are read as np.uint16 on the host):
  * the quotient-stream merge works on unsigned 32-bit words, carried here
    in int64 and masked to 32 bits (the windows of different blocks share
    no bit, so the scatter-add is an OR); the dropped scatter of JAX writes
    into three spare words past the end;
  * the Rice costs for every k are suffix sums of c_t * 2^t shifted right
    by k, the same integers as JAX's `einsum` with _RICE_M (cuBLAS has no
    integer matmul);
  * `_block_rank` inverts a stable sort (JAX's float32 MXU prefix is a
    TPU layout trick), and the 16-long prefix sums are 4 shifted adds;
  * the compactions take the j-th used unit by a searchsorted over the
    mask's cumsum, JAX's `nonzero(size=, fill_value=0)` with fixed shapes
    and no read-back to the host.

The host decode (numpy) is a copy of the JAX package's; `decode_payload`
takes the native decoder (tbc/native_codec.py) where it builds.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

CODEC_BW = 16                     # block width in samples = bits a plane word
CODEC_NPLANES = 16                # bit-granular plane classes
CODEC_QCAP_BITS = 64              # most quotient bits a rice block ships
_CODEC_UNIT = 32                  # plane compaction unit in words
_QUNIT = 8                        # quotient-stream compaction unit in words

# cost matrix: sum_i(z_i >> k) = sum_{t>=k} 2^(t-k) * c_t, c_t the block's
# count of samples with bit t set (`_rice_costs` computes the same integers)
_RICE_M = np.array([[1 << (t - k) if t >= k else 0 for t in range(16)]
                    for k in range(16)], np.int32)

_M32 = 0xFFFFFFFF


def pic_codec_params(cfg):
    """(lines, width, padded width, words per compaction unit, lag)."""
    W = cfg.sys.outlinelen
    Wp = -(-W // CODEC_BW) * CODEC_BW
    L = cfg.sys.frame_lines // 2 + 1          # fused.max_linecount
    k = 2 if cfg.system == 'NTSC' else 4
    return L, W, Wp, 1, k


def codec_cap_words(nblocks: int, count: int = 1) -> int:
    """Dense plane-buffer capacity in words for `count` images of `nblocks`
    16-sample blocks each: all 16 one-bit planes, each plane's prefix
    padded to the 32-word compaction unit (the worst case compact_planes
    ships), so the codec has no overflow path."""
    return CODEC_NPLANES * (-(-nblocks // _CODEC_UNIT) * _CODEC_UNIT) \
        * count


def codec_cap_rows(cfg, batch: int) -> int:
    """Dense plane-buffer capacity in words of a batch of pictures."""
    L, W, Wp, W4, k = pic_codec_params(cfg)
    return codec_cap_words(L * (Wp // CODEC_BW), batch)


def codec_qcap_words(R: int, NB: int) -> int:
    """Per-image quotient-stream capacity in u16 words (a multiple of the
    8-word compaction unit)."""
    return -(-R * NB * (CODEC_QCAP_BITS // 16) // _QUNIT) * _QUNIT


def tab_words(nblocks: int) -> int:
    return -(-(nblocks * 6) // 16)


def bcls_words(R: int, NB: int) -> int:
    """Packed table words for an (R, NB) block grid."""
    return tab_words(R * NB)


# ---------------------------------------------------------------------------
# device encode

def _codec_residual(x: torch.Tensor, k: int,
                    hpass: bool = False) -> torch.Tensor:
    """(..., R, C) integer image -> (..., R, C) int32 zigzagged mod-2^16
    residual.  `ds >> 15` is arithmetic on int32, as the zigzag needs."""
    x = x.to(torch.int32)
    head = torch.cat([x[..., :k, :1], x[..., :k, 1:] - x[..., :k, :-1]],
                     dim=-1)
    body = x[..., k:, :] - x[..., :-k, :]
    if hpass:
        body = torch.cat([body[..., :1], body[..., 1:] - body[..., :-1]],
                         dim=-1)
    r = torch.cat([head, body], dim=-2)
    ds = ((r + 0x8000) & 0xFFFF) - 0x8000
    return ((ds << 1) ^ (ds >> 15)) & 0xFFFF


def _bit_transpose16(zb: torch.Tensor) -> torch.Tensor:
    """(..., 16) u16 values (int32) -> (..., 16) where out[..., p] packs
    bit p of the 16 inputs (bit i = input i's bit p): the 16x16 bit-matrix
    transpose as 4 butterfly stages, with the lane reversal on entry and
    exit that turns the butterfly's anti-transpose into the transpose."""
    x = zb.flip(-1)
    s = zb.shape[:-1]
    for j, m in ((8, 0x00FF), (4, 0x0F0F), (2, 0x3333), (1, 0x5555)):
        x = x.reshape(*s, CODEC_BW // (2 * j), 2, j)
        lo, hi = x[..., 0, :], x[..., 1, :]
        t = (lo ^ (hi >> j)) & m
        x = torch.stack([lo ^ t, hi ^ (t << j)], dim=-2).reshape(
            *s, CODEC_BW)
    return x.flip(-1)


def _popcount16(v: torch.Tensor) -> torch.Tensor:
    """Per-element popcount of 16-bit values (int32 carrier)."""
    v = v - ((v >> 1) & 0x5555)
    v = (v & 0x3333) + ((v >> 2) & 0x3333)
    v = (v + (v >> 4)) & 0x0F0F
    return (v + (v >> 8)) & 0x1F


def _prefix16(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum over a last axis of 16, as 4 shifted adds
    (a scan kernel over millions of 16-long rows takes milliseconds)."""
    for s in (1, 2, 4, 8):
        x = x + F.pad(x, (s, 0))[..., :-s]
    return x


def _rice_costs(c: torch.Tensor) -> torch.Tensor:
    """(..., 16) per-bit sample counts -> (..., 16) Rice cost of every k:
    16k + 16 + sum_{t>=k} 2^(t-k) c_t.  Each term of the suffix sum of
    c_t 2^t from t = k is a multiple of 2^k, so shifting it right by k is
    exact: JAX's einsum('kt,rnt->krn', _RICE_M, c) in int32."""
    t = torch.arange(16, dtype=torch.int32, device=c.device)
    suf = _prefix16((c << t).flip(-1)).flip(-1)
    return CODEC_BW * (t + 1) + (suf >> t)


def encode_image_planes(x: torch.Tensor, k: int, hpass: bool = False):
    """Codec encode of (R, C) or (B, R, C) integer images (C % 16 == 0).

    Returns (planes (B, 16, R, NB) one-bit-plane words, tab (B, R, NB)
    6-bit table values `nwords | mode << 5`, qstream (B, qcap) unary
    quotient bitstream words, qwords (B,) used stream words), all int32
    with 16-bit values; without the batch dimension for a 2-D image.
    Also the comb's RGB encode (k=1, planar, hpass on RGB48)."""
    single = x.dim() == 2
    if single:
        x = x[None]
    B, R, C = x.shape
    NB = C // CODEC_BW
    dev = x.device
    i32 = torch.int32
    zb = _codec_residual(x, k, hpass).reshape(B, R, NB, CODEC_BW)

    pt = _bit_transpose16(zb)                       # (B, R, NB, 16)
    planes = pt.movedim(-1, 1)                      # (B, 16, R, NB)
    c = _popcount16(pt)
    nb = torch.where(c > 0, torch.arange(1, 17, dtype=i32, device=dev),
                     0).amax(-1)                    # bits(max z): 0..16
    costs = _rice_costs(c)                          # (B, R, NB, 16): k last
    kbest = costs.argmin(-1).to(i32)                # first minimum
    cmin = costs.amin(-1)
    qb = cmin - CODEC_BW * kbest                    # sum(q) + 16
    elig = (cmin < CODEC_BW * nb) & (qb <= CODEC_QCAP_BITS)
    nwords = torch.where(elig, kbest, nb)
    tab = nwords | (elig.to(i32) << 5)

    # per-image unary quotient stream: sample i (row-major) emits q_i zeros
    # then a stop 1, built per block in a local 64-bit window (4 u16 words)
    # and merged at exact bit offsets as 3 u32 words a block
    n = R * NB
    zb16 = zb.reshape(B, n, CODEC_BW)
    q = (zb16 >> kbest.reshape(B, n, 1)) + 1        # qlen per sample
    pcum = _prefix16(q)
    pos = pcum - 1                                  # local stop bit 0..63
    eligf = elig.reshape(B, n)
    bit = torch.ones_like(pos) << (pos & 15)
    lw = [torch.where(eligf, torch.where((pos >> 4) == j, bit, 0).sum(-1),
                      0) for j in range(CODEC_QCAP_BITS // 16)]
    qbits = torch.where(eligf, pcum[..., -1], 0).to(torch.int64)
    off = qbits.cumsum(-1) - qbits                  # exclusive bit offset
    lo32 = lw[0] | (lw[1] << 16)
    hi32 = lw[2] | (lw[3] << 16)
    sh = off & 31
    base = off >> 5
    qcap = codec_qcap_words(R, NB)
    # (x >> 1) >> (31 - sh) is x >> (32 - sh) without the undefined 32-bit
    # shift at sh == 0
    words = ((lo32 << sh) & _M32,
             ((lo32 >> 1) >> (31 - sh)) | ((hi32 << sh) & _M32),
             (hi32 >> 1) >> (31 - sh))
    out = torch.zeros((B, qcap // 2 + 3), dtype=torch.int64, device=dev)
    for j, wj in enumerate(words):
        out.scatter_add_(1, base + j, torch.where(eligf, wj, 0))
    out = out[:, :qcap // 2]                        # JAX's mode='drop'
    qstream = torch.stack([out & 0xFFFF, out >> 16], dim=-1).reshape(
        B, qcap).to(i32)
    total_bits = off[:, -1] + qbits[:, -1]
    # used words, rounded to the 8-word compaction unit (the pad is zeros,
    # which the unary decode ignores)
    qwords = ((((total_bits + 15) >> 4) + 7) // 8 * 8).to(i32)
    if single:
        return planes[0], tab[0], qstream[0], qwords[0]
    return planes, tab, qstream, qwords


def pack_tab(tab: torch.Tensor) -> torch.Tensor:
    """(..., R, NB) 6-bit table values -> (..., tab_words) u16 words as
    int32 (little-endian 6-bit fields straddling word boundaries): eight
    values make one 48-bit group of three words."""
    lead = tab.shape[:-2]
    flat = tab.reshape(*lead, -1).to(torch.int64)
    n = flat.shape[-1]
    m = -(-n // 8)
    flat = F.pad(flat, (0, 8 * m - n)).reshape(*lead, m, 8)
    sh = 6 * torch.arange(8, dtype=torch.int64, device=tab.device)
    v = (flat << sh).sum(-1)
    words = torch.stack([v & 0xFFFF, (v >> 16) & 0xFFFF, (v >> 32) & 0xFFFF],
                        dim=-1).reshape(*lead, 3 * m)
    return words[..., :tab_words(n)].to(torch.int32)


def pad_to_blocks(x: torch.Tensor) -> torch.Tensor:
    """(..., C) -> (..., Cp) int32, the last column repeated up to a whole
    number of 16-sample blocks (JAX's pad mode 'edge')."""
    x = x.to(torch.int32)
    n = -x.shape[-1] % CODEC_BW
    return torch.cat([x, x[..., -1:].expand(*x.shape[:-1], n)], dim=-1)


def _padded_pictures(pic: torch.Tensor, cfg):
    """(..., L, W) or (..., L*W) pictures -> ((B, L, Wp) int32 images
    edge-padded to whole blocks, the lag k)."""
    L, W, Wp, W4, k = pic_codec_params(cfg)
    return pad_to_blocks(pic.reshape(-1, L, W)), k


def encode_picture_planes(pic: torch.Tensor, cfg):
    """(..., L, W) or (..., L*W) pictures -> encode_image_planes outputs of
    the edge-padded (L, Wp) images, batched over the leading dimension."""
    return encode_image_planes(*_padded_pictures(pic, cfg))


def _block_rank(nw: torch.Tensor):
    """Dense rank of each block under (nwords DESC, block index ASC), and
    gt[v] = #blocks with nwords > v, over the last axis of (..., N) int
    nwords in 0..16: the integers of _block_rank_np, batched.  The rank is
    the inverse of a stable descending sort (a 17-bin running count along
    the blocks, as JAX and _block_rank_np compute it, is a scan that takes
    milliseconds on the card)."""
    nw = nw.to(torch.int64)
    order = torch.sort(nw, dim=-1, descending=True, stable=True).indices
    rank = torch.empty_like(order).scatter_(
        -1, order, torch.arange(nw.shape[-1], device=nw.device).expand_as(
            order))
    hist = torch.zeros((*nw.shape[:-1], 17), dtype=torch.int32,
                       device=nw.device).scatter_add_(
        -1, nw, torch.ones_like(nw, dtype=torch.int32))
    gt = hist.flip(-1).cumsum(-1, dtype=torch.int32).flip(-1) - hist
    return rank.to(torch.int32), gt


def _take_used(src: torch.Tensor, used: torch.Tensor, n: int):
    """src (U, w) units, used (U,) bool -> (n, w): the used units in order,
    then unit 0 repeated (JAX's take(src, nonzero(used, size=n,
    fill_value=0))).  The j-th used unit is found by a searchsorted over
    the mask's running count: fixed shapes, no read-back."""
    run = used.to(torch.int64).cumsum(0)
    j = torch.arange(1, n + 1, dtype=torch.int64, device=src.device)
    idx = torch.searchsorted(run, j)
    idx = torch.where(j <= run[-1], idx, 0)
    return src.index_select(0, idx)


def compact_planes(planes: torch.Tensor, tab: torch.Tensor, cap: int):
    """planes (B, 16, R, NB) + tab (B, R, NB) -> (dense (cap,) plane words,
    rows (B,) int32 shipped words an image).

    Per image, plane p ships ceil(cnt[p]/32)*32 words of which the first
    cnt[p] are real (rank order): ranking makes each plane's used words a
    contiguous prefix, so compaction runs at 32-word units."""
    B, _, R, NB = planes.shape
    N = R * NB
    Ncap = -(-N // _CODEC_UNIT) * _CODEC_UNIT
    rank, gt = _block_rank((tab & 0x1F).reshape(B, N))
    src = planes.reshape(B, CODEC_NPLANES, N).transpose(1, 2)
    pr = torch.zeros((B, Ncap, CODEC_NPLANES), dtype=planes.dtype,
                     device=planes.device).scatter_(
        1, rank.to(torch.int64)[..., None].expand(-1, -1, CODEC_NPLANES),
        src).transpose(1, 2)                        # (B, 16, Ncap)
    cnt = gt[:, :CODEC_NPLANES]                     # used blocks per plane
    used = -(-cnt // _CODEC_UNIT) * _CODEC_UNIT
    units = torch.arange(Ncap // _CODEC_UNIT, device=planes.device)
    umask = units * _CODEC_UNIT < cnt[..., None]
    dense = _take_used(pr.reshape(-1, _CODEC_UNIT), umask.reshape(-1),
                       cap // _CODEC_UNIT)
    return dense.reshape(-1), used.sum(-1).to(torch.int32)


def compact_qstreams(qstreams: torch.Tensor, qwords: torch.Tensor,
                     cap: int):
    """qstreams (B, qcap) + qwords (B,) (multiples of 8) -> (dense (cap,),
    qwords): each image's used stream prefix lands contiguously, at 8-word
    units."""
    B, qcap = qstreams.shape
    units = torch.arange(qcap // _QUNIT, device=qstreams.device)
    mask = units < (qwords // _QUNIT)[:, None]
    dense = _take_used(qstreams.reshape(-1, _QUNIT), mask.reshape(-1),
                       cap // _QUNIT)
    return dense.reshape(-1), qwords


def _wire16(x: torch.Tensor) -> torch.Tensor:
    """16-bit words held as int32 0..65535 -> the int16 tensor with the
    same bits (the host views it as np.uint16)."""
    return (x - ((x & 0x8000) << 1)).to(torch.int16)


def encode_image_payload(imgs: torch.Tensor, k: int, hpass: bool = False
                         ) -> Dict[str, torch.Tensor]:
    """(B, R, C) integer images -> the batch's wire payload: 'tab' (B,
    tab_words) packed tables, 'dense' and 'dense_q' (the compacted plane
    words and quotient streams, capacity-sized: the host copies only
    their used prefixes) as int16, 'rows2' (2, B) int32 words an image."""
    B, R, C = imgs.shape
    NB = C // CODEC_BW
    planes, tab, qstreams, qwords = encode_image_planes(imgs, k, hpass)
    dense, rows = compact_planes(planes, tab, codec_cap_words(R * NB, B))
    dense_q, qw = compact_qstreams(qstreams, qwords,
                                   codec_qcap_words(R, NB) * B)
    return {'tab': _wire16(pack_tab(tab)), 'dense': _wire16(dense),
            'dense_q': _wire16(dense_q), 'rows2': torch.stack([rows, qw])}


def encode_picture_payload(picture: torch.Tensor, cfg
                           ) -> Dict[str, torch.Tensor]:
    """pipeline_finish's codec branch: the (B, L, W) picture batch ->
    {'pic_tab', 'dense', 'dense_q', 'rows2'}."""
    pay = encode_image_payload(*_padded_pictures(picture, cfg))
    pay['pic_tab'] = pay.pop('tab')
    return pay


# ---------------------------------------------------------------------------
# host decode (copies of the JAX package's numpy functions)

def unpack_tab(words: np.ndarray, R: int, NB: int) -> np.ndarray:
    """Host inverse of pack_tab -> (R, NB) int table values."""
    bits = np.unpackbits(np.ascontiguousarray(
        np.asarray(words).astype('<u2')).view(np.uint8),
        bitorder='little')
    v = bits[:R * NB * 6].reshape(-1, 6).astype(np.int32)
    return (v @ (1 << np.arange(6, dtype=np.int32))).reshape(R, NB)


def decode_image_planes(tab: np.ndarray, dense_words: np.ndarray,
                        qstream: np.ndarray, shape, k: int,
                        rank_gt=None, hpass: bool = False) -> np.ndarray:
    """Invert encode_image_planes for one image from its contiguous dense
    plane region + quotient stream (host).  tab: (R, NB) 6-bit table
    values (see unpack_tab).  rank_gt: optional precomputed _block_rank_np
    result.  int32 throughout (the mod-2^16 reconstruction is exact under
    int32 wraparound); planes accumulate in rank space, and the plane
    loop stops at the first empty plane (gt is non-increasing)."""
    R, C = shape
    NB = C // CODEC_BW
    tab = np.asarray(tab)
    nwords = (tab & 0x1F).reshape(-1).astype(np.int32)
    mode = ((tab >> 5) & 1).reshape(-1).astype(bool)
    dw = np.asarray(dense_words).astype(np.int32)
    # replay the device's deterministic block ranking (compact_planes):
    # plane p's words are the first cnt[p] of its 32-word-aligned prefix,
    # in rank order
    rank, gt = rank_gt if rank_gt is not None else _block_rank_np(nwords)
    zr = np.zeros((R * NB, CODEC_BW), np.int32)
    pos = 0
    sample_sh = np.arange(CODEC_BW, dtype=np.int32)
    for p in range(CODEC_NPLANES):
        cnt = int(gt[p])
        if not cnt:
            break                     # gt is non-increasing
        shipped = -(-cnt // _CODEC_UNIT) * _CODEC_UNIT
        w = dw[pos:pos + shipped][:cnt]
        pos += shipped
        zr[:cnt] |= ((w[:, None] >> sample_sh) & 1) << p
    z = zr[rank]                      # rank space -> block order
    if mode.any():
        bits = np.unpackbits(np.ascontiguousarray(
            np.asarray(qstream).astype('<u2')).view(np.uint8),
            bitorder='little')
        nsamp = int(mode.sum()) * CODEC_BW
        ones = np.nonzero(bits)[0][:nsamp]
        q = np.diff(np.concatenate([[-1], ones])) - 1
        z[mode] += (q.reshape(-1, CODEC_BW) << nwords[mode, None]
                    ).astype(np.int32)
    z = z.reshape(R, C)
    d = ((z >> 1) ^ -(z & 1))                      # un-zigzag
    if hpass:                                      # invert the h pass
        d[k:] = np.cumsum(d[k:], axis=1)
    x = np.zeros((R, C), np.int32)
    x[:k] = np.cumsum(d[:k], axis=1)               # head rows: h-delta
    for c in range(k):                             # vertical chains
        x[c::k] = np.cumsum(
            np.concatenate([x[c:c + 1], d[c + k::k]]), axis=0)
    return (x & 0xFFFF).astype(np.uint16)


def _block_rank_np(nw: np.ndarray):
    """Host replay of _block_rank (identical integer arithmetic; int32 --
    counts are < 2^31 by construction)."""
    nw = np.asarray(nw).astype(np.int32)
    eq = (nw[:, None] == np.arange(17, dtype=np.int32)).astype(np.int32)
    cum_eq = np.cumsum(eq, axis=0, dtype=np.int32)
    hist = cum_eq[-1]
    gt = np.cumsum(hist[::-1], dtype=np.int32)[::-1] - hist
    rank = gt[nw] + cum_eq[np.arange(nw.size), nw] - 1
    return rank, gt


def shipped_plane_words_np(nwords: np.ndarray, rank_gt=None) -> int:
    """Host: exact dense-word count compact_planes ships for one image
    ((R, NB) or flat nwords) -- the pipeline's consistency check.
    rank_gt: optional precomputed _block_rank_np result."""
    _, gt = (rank_gt if rank_gt is not None
             else _block_rank_np(np.asarray(nwords).reshape(-1)))
    cnt = gt[:CODEC_NPLANES]
    return int((-(-cnt.astype(np.int64) // _CODEC_UNIT)
                * _CODEC_UNIT).sum())


def decode_picture_planes(tab: np.ndarray, dense_words: np.ndarray,
                          qstream: np.ndarray, cfg,
                          rank_gt=None) -> np.ndarray:
    """Invert encode_picture_planes + compaction for ONE field: tab (L, NB)
    values (via unpack_tab at the caller), the field's contiguous dense
    plane region and its quotient stream."""
    L, W, Wp, W4, k = pic_codec_params(cfg)
    x = decode_image_planes(tab, dense_words, qstream, (L, Wp), k,
                            rank_gt=rank_gt)
    return x[:, :W].reshape(-1)


def decode_payload(tab_words: np.ndarray, dense: np.ndarray,
                   dense_q: np.ndarray, shape, k: int, hpass: bool,
                   rows: int) -> Tuple[Optional[np.ndarray], str]:
    """One (R, C) image back from its wire payload, and the route taken:
    the native decoder (tbc/native_codec.py) where it built, else the
    numpy decode.  The image is None where the consistency gate fails:
    the dense words the table says were shipped must equal the device's
    count `rows`."""
    from ld_decode_tpu_torch.tbc import native_codec as NC
    R, C = shape
    NB = C // CODEC_BW
    if NC.available():
        tab = NC.unpack_tab(tab_words, R * NB)
        img, shipped = NC.decode_image(tab, dense, dense_q, shape, k, hpass)
        return (img if shipped == rows else None), 'native'
    tab = unpack_tab(tab_words, R, NB)
    rank_gt = _block_rank_np((tab & 0x1F).reshape(-1))
    if shipped_plane_words_np(tab & 0x1F, rank_gt) != rows \
            or dense.shape[0] < rows:
        return None, 'numpy'
    return decode_image_planes(tab, dense, dense_q, shape, k,
                               rank_gt=rank_gt, hpass=hpass), 'numpy'


def decode_batch(tabs: np.ndarray, dense: np.ndarray, dense_q: np.ndarray,
                 rows2: np.ndarray, shape, k: int, hpass: bool, executor):
    """Every image of a batch's payload (tabs (B, words), the used dense
    prefixes, rows2 (2, B) words an image), decoded in parallel on
    `executor` (the native decode releases the GIL): a list of
    decode_payload's (image or None, route); (None, None) where the
    prefixes are shorter than the counts say."""
    rows2 = rows2.astype(np.int64)
    offs = np.concatenate([[0], np.cumsum(rows2[0])])
    offs_q = np.concatenate([[0], np.cumsum(rows2[1])])

    def one(b):
        if offs[b + 1] > dense.shape[0] or offs_q[b + 1] > dense_q.shape[0]:
            return None, None
        return decode_payload(tabs[b], dense[offs[b]:offs[b + 1]],
                              dense_q[offs_q[b]:offs_q[b + 1]], shape, k,
                              hpass, int(rows2[0, b]))

    return list(executor.map(one, range(rows2.shape[1])))


class PrefixCopies:
    """The host copies of a batch's two dense buffers, sized by an estimate.

    At dispatch, `start` adds to a batch's copy set the first n words of
    each buffer, n from the running estimate (1.25x an EMA of the used
    words of earlier batches; a host int, never a device scalar), so they
    travel with the batch's other outputs; `finish` tops a prefix up where
    the batch used more than the estimate.  The JAX package's grid-chunked
    fetch pools exist for its tunnel; here a prefix is one copy."""

    def __init__(self):
        self._ema: Optional[Tuple[float, float]] = None
        self.topups = 0

    def start(self, copies: Dict[str, torch.Tensor], dense: torch.Tensor,
              dense_q: torch.Tensor) -> Tuple[int, int]:
        n = nq = 0
        if self._ema is not None:
            n = min(dense.shape[0], int(self._ema[0] * 1.25))
            nq = min(dense_q.shape[0], int(self._ema[1] * 1.25))
        copies['dense_head'] = dense[:n]
        copies['dense_q_head'] = dense_q[:nq]
        return n, nq

    def finish(self, host: Dict[str, np.ndarray], dense: torch.Tensor,
               dense_q: torch.Tensor, rows2: np.ndarray):
        """(dense[:total], dense_q[:totq]) as np.uint16 from the copies in
        `host` (read after the batch's event), topped up where short."""
        total = int(min(rows2[0].sum(), dense.shape[0]))
        totq = int(min(rows2[1].sum(), dense_q.shape[0]))
        self._ema = (total, totq) if self._ema is None else (
            0.5 * self._ema[0] + 0.5 * total, 0.5 * self._ema[1] + 0.5 * totq)
        out = []
        for head, buf, n in ((host['dense_head'], dense, total),
                             (host['dense_q_head'], dense_q, totq)):
            head = np.asarray(head).view(np.uint16)
            if head.shape[0] < n:
                self.topups += 1
                rest = buf[head.shape[0]:n].cpu().numpy().view(np.uint16)
                head = np.concatenate([head, rest])
            out.append(head[:n])
        return out[0], out[1]
