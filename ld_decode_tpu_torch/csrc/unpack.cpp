// Native bit-unpack fast paths for capture ingestion.
//
// TPU-native equivalent of the reference's packing tools and loader inner
// loops (reference ddpack.c / ddunpack.c and lddutils.py:150-229): the
// Domesday Duplicator 10-bit formats are unpacked to uint16 at memory
// bandwidth so the host-side feeder never stalls the device pipeline.
// Exposed via ctypes (see ld_decode_tpu/io/native_unpack.py).

#include <cstdint>
#include <cstddef>

extern "C" {

// 4 samples in 5 bytes (.lds; layout per reference lddutils.py:178-191)
void unpack_4_40(const uint8_t* in, size_t ngroups, uint16_t* out) {
    for (size_t g = 0; g < ngroups; g++) {
        const uint8_t* b = in + g * 5;
        uint16_t* o = out + g * 4;
        o[0] = (uint16_t)((b[0] << 2) | (b[1] >> 6));
        o[1] = (uint16_t)(((b[1] & 0x3f) << 4) | (b[2] >> 4));
        o[2] = (uint16_t)(((b[2] & 0x0f) << 6) | (b[3] >> 2));
        o[3] = (uint16_t)(((b[3] & 0x03) << 8) | b[4]);
    }
}

// inverse (fixture/cut writing)
void pack_4_40(const uint16_t* in, size_t ngroups, uint8_t* out) {
    for (size_t g = 0; g < ngroups; g++) {
        const uint16_t* s = in + g * 4;
        uint8_t* o = out + g * 5;
        o[0] = (uint8_t)(s[0] >> 2);
        o[1] = (uint8_t)(((s[0] & 0x3) << 6) | (s[1] >> 4));
        o[2] = (uint8_t)(((s[1] & 0xf) << 4) | (s[2] >> 6));
        o[3] = (uint8_t)(((s[2] & 0x3f) << 2) | (s[3] >> 8));
        o[4] = (uint8_t)(s[3] & 0xff);
    }
}

// 3 samples per little-endian uint32 (.r30; reference ddpack.c:11-27)
void unpack_3_32(const uint32_t* in, size_t nwords, int16_t* out) {
    for (size_t w = 0; w < nwords; w++) {
        uint32_t v = in[w];
        int16_t* o = out + w * 3;
        o[0] = (int16_t)(v & 0x3ff);
        o[1] = (int16_t)((v >> 10) & 0x3ff);
        o[2] = (int16_t)((v >> 20) & 0x3ff);
    }
}

}  // extern "C"
