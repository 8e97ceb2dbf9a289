// Native decoder for the adaptive bit-plane picture/RGB codec
// (ld_decode_tpu/tbc/fused.py: encode_image_planes / compact_planes /
// decode_image_planes).  The numpy decode costs ~20-60 ms per image on
// the consumer path — enough to bound the full decode->comb->RGB chain
// (scripts/probe_chain.py measured the codec-mode chain at ~18 MSa/s vs
// ~35 for raw-fetch).  This is the same arithmetic, single pass, ~2-4 ms.
//
// Layout contract (must match fused.py exactly):
//  - tab: N = R*NB values, bits 0..4 = nwords, bit 5 = rice mode.
//  - blocks are ranked by (nwords DESC, index ASC); plane p ships the
//    first cnt[p]=|{nwords>p}| ranked blocks' words as a prefix padded
//    to 32-word units.
//  - rice blocks append, in BLOCK order, 16 unary quotients
//    (q zeros then a stop 1) to a little-endian bitstream; sample j of
//    block i adds q << nwords[i].
//  - residual: zigzag of mod-2^16 vertical lag-k delta (head k rows:
//    horizontal lag-1 delta).  hpass=1 adds a horizontal lag-1 pass
//    over the body rows' vertical deltas (the 2D gradient predictor
//    used for the comb's RGB48 stream — fused._codec_residual).
//
// Returns the total shipped dense words (the caller compares against
// the device-reported count as the consistency gate), or -1 if the
// provided buffers are too short (caller falls back to numpy/raw).

#include <cstdint>
#include <cstring>
#include <vector>

extern "C" int64_t codec_decode(
    const uint16_t* tab,        // (N,) 6-bit table values
    const uint16_t* dense,      // shipped plane words
    int64_t dense_len,
    const uint16_t* qstream,    // unary quotient bitstream words
    int64_t q_len,
    int64_t R, int64_t NB, int64_t k, int64_t hpass,
    uint16_t* out)              // (R, NB*16) u16, written fully
{
    const int64_t N = R * NB;
    const int64_t C = NB * 16;

    // counting rank, identical arithmetic to _block_rank_np
    int32_t hist[17] = {0};
    std::vector<uint8_t> nw(N);
    std::vector<uint8_t> mode(N);
    for (int64_t i = 0; i < N; i++) {
        nw[i] = tab[i] & 0x1F;
        mode[i] = (tab[i] >> 5) & 1;
        hist[nw[i]]++;
    }
    int32_t gt[17];
    int32_t run = 0;
    for (int v = 16; v >= 0; v--) { gt[v] = run; run += hist[v]; }
    // ord[rank] = block index (ranks are gt[v] + arrival order per bin)
    std::vector<int32_t> ord(N);
    int32_t next[17];
    for (int v = 0; v < 17; v++) next[v] = gt[v];
    for (int64_t i = 0; i < N; i++) ord[next[nw[i]]++] = i;

    std::vector<int32_t> z(N * 16, 0);

    int64_t pos = 0;
    for (int p = 0; p < 16; p++) {
        const int64_t cnt = gt[p];
        if (!cnt) break;
        const int64_t shipped = ((cnt + 31) / 32) * 32;
        if (pos + cnt > dense_len) return -1;
        for (int64_t r = 0; r < cnt; r++) {
            const uint32_t w = dense[pos + r];
            int32_t* zb = &z[(int64_t)ord[r] * 16];
            for (int j = 0; j < 16; j++)
                zb[j] |= ((w >> j) & 1) << p;
        }
        pos += shipped;
    }

    // unary quotient stream, block order
    {
        int64_t bit = 0;
        const int64_t nbits = q_len * 16;
        for (int64_t i = 0; i < N; i++) {
            if (!mode[i]) continue;
            const int sh = nw[i];
            int32_t* zb = &z[i * 16];
            for (int j = 0; j < 16; j++) {
                int32_t q = 0;
                for (;;) {
                    if (bit >= nbits) return -1;
                    const int b = (qstream[bit >> 4] >> (bit & 15)) & 1;
                    bit++;
                    if (b) break;
                    q++;
                }
                zb[j] += q << sh;
            }
        }
    }

    // un-zigzag + reconstruction (all mod-2^16)
    // head rows: horizontal cumsum of deltas; then vertical chains
    for (int64_t r = 0; r < R; r++) {
        const int32_t* zr = &z[r * C];
        uint16_t* xr = &out[r * C];
        if (r < k) {
            uint32_t acc = 0;
            for (int64_t c = 0; c < C; c++) {
                const int32_t zz = zr[c];
                const int32_t d = (zz >> 1) ^ -(zz & 1);
                acc += (uint32_t)d;
                xr[c] = (uint16_t)acc;
            }
        } else if (hpass) {
            // body rows carry h-deltas of the v-delta: one running
            // accumulator inverts both passes in a single sweep
            const uint16_t* xp = &out[(r - k) * C];
            uint32_t acc = 0;
            for (int64_t c = 0; c < C; c++) {
                const int32_t zz = zr[c];
                const int32_t d = (zz >> 1) ^ -(zz & 1);
                acc += (uint32_t)d;
                xr[c] = (uint16_t)(xp[c] + acc);
            }
        } else {
            const uint16_t* xp = &out[(r - k) * C];
            for (int64_t c = 0; c < C; c++) {
                const int32_t zz = zr[c];
                const int32_t d = (zz >> 1) ^ -(zz & 1);
                xr[c] = (uint16_t)(xp[c] + (uint32_t)d);
            }
        }
    }
    return pos;
}

// 6-bit little-endian table unpack (fused.pack_tab inverse): the numpy
// unpackbits path costs ~10 ms on RGB-sized tables.
extern "C" void unpack_tab6(const uint16_t* words, int64_t n,
                            uint16_t* out)
{
    for (int64_t i = 0; i < n; i++) {
        const int64_t off = 6 * i;
        uint32_t v = (uint32_t)words[off >> 4] >> (off & 15);
        if ((off & 15) > 10)
            v |= (uint32_t)words[(off >> 4) + 1] << (16 - (off & 15));
        out[i] = v & 0x3F;
    }
}
