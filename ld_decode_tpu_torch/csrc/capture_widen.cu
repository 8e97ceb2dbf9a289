// Capture widening: a segment's integer samples to float32, in place, on
// the card.
//
// Replaces no TPU kernel.  The JAX package keeps the capture as uint16 on
// the device (ld_decode_tpu/tbc/framer.py, jax.device_put) and its jitted
// graphs widen what they read.  The port keeps a float32 buffer, which its
// CUDA graphs read in place, and converted on the host
// (tbc/cuda_widen.py::widen_plain, still the route of a CPU tensor): a
// fresh host array of 4 bytes a sample, then a copy of those 4 bytes to
// the card.  Here the host copies the loader's samples as they are (1 or
// 2 bytes each) into the resident buffer and the card widens them where
// they lie.
//
// For sample i of n, of type T (uint8, int8, uint16 or int16):
//   out[i] = float((int)x[i] + bias)      bias = 32768 for a signed T, else 0
// which is the host route's recentre and float32 conversion bit for bit
// (every value lies below 2^24, so both conversions are exact).
//
// What bounds it on the card: memory traffic.  n samples of s bytes read
// and n floats written, s + 4 bytes a sample: 6 for the .lds route's
// uint16, 1.61 GB for a 2^28-sample segment, 0.48 ms at 3.35 TB/s.
//
// Design.  No scratch memory: the buffer's own bytes hold the input.  The
// caller copies the n samples into the top s*n bytes of the buffer's first
// 4n, bytes [(4-s)n, 4n); output i takes bytes [4i, 4i+4).  The outputs
// are widened in ranges [a, b), one launch a range, in stream order
// (tbc/cuda_widen.py::widen_schedule): a range's outputs overwrite no
// input of the same range, except that the last sample, alone in the last
// range, overwrites its own input after reading it.  The writes of range
// [a, b) end at byte 4b and its reads start at byte (4-s)n + s*a, so
// b <= ((4-s)n + s*a) / 4: for uint16 each range is half of what is left
// (n/2, n/4, ...), about log2(n) + 1 launches (29 for 2^28 samples), for
// uint8 three quarters.  Inputs above a range are never overwritten before
// they are read, since (4-s)n + s*j >= 4j for every j < n.  The launcher
// refuses a schedule that breaks the first rule.  Each thread loads kPer
// samples a block's width apart before it stores any of them, so a thread
// keeps kPer loads in flight (2-byte loads one a thread would hold the
// card to a fraction of its memory rate).  The tail out[n:] is zeroed with
// a memset on the same stream.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPer = 8;

template <typename T>
__global__ void widen_kernel(float* out, const T* in, long long a,
                             long long b, int bias) {
  const long long base = a + (long long)blockIdx.x * (kThreads * kPer)
                         + threadIdx.x;
  T x[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const long long i = base + (long long)k * kThreads;
    if (i < b) x[k] = in[i];
  }
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const long long i = base + (long long)k * kThreads;
    if (i < b) out[i] = (float)((int)x[k] + bias);
  }
}

template <typename T>
int launch_all(float* out, long long n, const long long* bounds,
               int nranges, int bias, cudaStream_t stream) {
  const int s = (int)sizeof(T);
  const T* in = (const T*)((const char*)out + (long long)(4 - s) * n);
  for (int r = 0; r < nranges; ++r) {
    const long long a = bounds[r], b = bounds[r + 1];
    const long long per = (long long)kThreads * kPer;
    const long long blocks = (b - a + per - 1) / per;
    widen_kernel<T><<<(unsigned)blocks, kThreads, 0, stream>>>(out, in, a,
                                                                b, bias);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

}  // namespace

// Plain C entry point (bound with ctypes).  out: `total` float32 on the
// current device, its bytes [(4-s)n, 4n) holding the n samples of kind
// `kind` (0 uint8, 1 int8, 2 uint16, 3 int16; s = 1 or 2 bytes).  bounds:
// nranges + 1 host integers, 0 = bounds[0] < ... < bounds[nranges] = n,
// one launch a range.  Widens out[0:n] in place and zeroes out[n:total],
// on `stream` without synchronising; returns cudaGetLastError() after
// each launch, or cudaErrorInvalidValue for a kind, size or schedule it
// does not take.
extern "C" int capture_widen_launch(float* out, long long n, long long total,
                                    int kind, const long long* bounds,
                                    int nranges, void* stream) {
  if (kind < 0 || kind > 3 || n < 0 || total < n || nranges < 0)
    return (int)cudaErrorInvalidValue;
  const long long s = kind < 2 ? 1 : 2;
  if (n > 0) {
    if (nranges < 1 || bounds[0] != 0 || bounds[nranges] != n)
      return (int)cudaErrorInvalidValue;
    for (int r = 0; r < nranges; ++r) {
      const long long a = bounds[r], b = bounds[r + 1];
      const bool last_alone = a == n - 1 && b == n;
      // 2^31 - 1 blocks at most a launch
      if (b <= a || (b - a) / ((long long)kThreads * kPer) >= 0x7fffffffLL
          || (!last_alone && 4 * b > (4 - s) * n + s * a))
        return (int)cudaErrorInvalidValue;
    }
  } else if (nranges != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t st = (cudaStream_t)stream;
  int rc = 0;
  switch (kind) {
    case 0: rc = launch_all<uint8_t>(out, n, bounds, nranges, 0, st); break;
    case 1: rc = launch_all<int8_t>(out, n, bounds, nranges, 32768, st); break;
    case 2: rc = launch_all<uint16_t>(out, n, bounds, nranges, 0, st); break;
    default: rc = launch_all<int16_t>(out, n, bounds, nranges, 32768, st);
  }
  if (rc != 0) return rc;
  if (total > n) {
    const cudaError_t e = cudaMemsetAsync(out + n, 0,
                                          (size_t)(total - n) * sizeof(float),
                                          st);
    if (e != cudaSuccess) return (int)e;
  }
  return (int)cudaGetLastError();
}
