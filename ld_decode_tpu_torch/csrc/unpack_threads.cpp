// The .lds 4-in-5 unpack (csrc/unpack.cpp's unpack_4_40), on one thread for
// small reads and split across host threads for the segment loads: a
// 512 MB segment is 2^26 groups, which one thread unpacks in 0.3-0.4 s
// while the card waits.
//
// The groups are cut into `nthreads` contiguous ranges, one std::thread
// each; the caller's thread takes the first range itself.  Each thread
// writes only its own slice of `out`, so the page faults of a freshly
// allocated output are split across the threads too.  Same bits as
// unpack_4_40.  Exposed via ctypes (io/native_unpack.py), which releases
// the GIL for the call.

#include <cstddef>
#include <cstdint>
#include <cstring>
#include <exception>
#include <thread>
#include <vector>

namespace {

inline void unpack_group(const uint8_t* b, uint16_t* o) {
    o[0] = (uint16_t)((b[0] << 2) | (b[1] >> 6));
    o[1] = (uint16_t)(((b[1] & 0x3f) << 4) | (b[2] >> 4));
    o[2] = (uint16_t)(((b[2] & 0x0f) << 6) | (b[3] >> 2));
    o[3] = (uint16_t)(((b[3] & 0x03) << 8) | b[4]);
}

// Groups [g0, g1) of the ngroups in `in`.  A group is read as the top 40
// bits of one big-endian 8-byte word; the last group of the input, whose
// word would run 3 bytes past its end, is read byte by byte.
void unpack_range(const uint8_t* in, size_t g0, size_t g1, size_t ngroups,
                  uint16_t* out) {
    const size_t whole = ngroups > 0 ? ngroups - 1 : 0;
    const size_t end = g1 < whole ? g1 : whole;
    size_t g = g0;
    for (; g < end; g++) {
        uint64_t w;
        std::memcpy(&w, in + g * 5, 8);
#if __BYTE_ORDER__ == __ORDER_LITTLE_ENDIAN__
        w = __builtin_bswap64(w);
#endif
        uint16_t* o = out + g * 4;
        o[0] = (uint16_t)((w >> 54) & 0x3ff);
        o[1] = (uint16_t)((w >> 44) & 0x3ff);
        o[2] = (uint16_t)((w >> 34) & 0x3ff);
        o[3] = (uint16_t)((w >> 24) & 0x3ff);
    }
    for (; g < g1; g++) unpack_group(in + g * 5, out + g * 4);
}

}  // namespace

extern "C" {

// unpack_4_40 on min(nthreads, ngroups) threads (at least one).  A thread
// the system refuses to start leaves its range to the caller's thread.
void unpack_4_40_threads(const uint8_t* in, size_t ngroups, uint16_t* out,
                         int nthreads) {
    size_t n = nthreads > 1 ? (size_t)nthreads : 1;
    if (n > ngroups) n = ngroups > 0 ? ngroups : 1;
    const size_t per = ngroups / n, extra = ngroups % n;
    auto first = [&](size_t k) { return k * per + (k < extra ? k : extra); };
    std::vector<std::thread> pool;
    for (size_t k = 1; k < n; k++) {
        try {
            pool.emplace_back(unpack_range, in, first(k), first(k + 1),
                              ngroups, out);
        } catch (const std::exception&) {
            unpack_range(in, first(k), first(k + 1), ngroups, out);
        }
    }
    unpack_range(in, first(0), first(1), ngroups, out);
    for (auto& t : pool) t.join();
}

}  // extern "C"
