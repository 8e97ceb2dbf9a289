// Batched per-line Catmull-Rom resample (the TBC downscale) for Hopper.
//
// Replaces the TPU Pallas kernel
// ld_decode_tpu/tbc/pallas_resample.py::resample_lines_batch.  For field b,
// line l and output column k in [col0, col0+ncols):
//   steplen = (lli[l+1]-lli[l]) + (llf[l+1]-llf[l])
//   rel     = llf[l] + steplen * (k * inv_w)     (inv_w = float32(1/W))
//   out     = (steplen / st_nom) * sum_{tap=-1..2} w_tap(rel - floor(rel))
//             * data[b, clamp(lli[l] + floor(rel), 1, nsamp-3) + tap]
//
// What bounds it on the card: memory traffic, and little of it.  An NTSC
// picture call (16 fields x 263 lines x 910 columns) reads each line's
// ~2546-sample span of the demod tap once (43 MB) and writes 15 MB: ~17 us
// at 3.35 TB/s.  The burst-window call (48 columns) moves ~3 MB, so it is
// bound by latency: the launch and two dependent memory trips (the line
// table, then the samples).  Loading the table and the four taps with
// scalar loads for every output sample holds the picture call to about
// half the memory rate.
//
// Design.  A group of G warps resamples one line (G = 4 for the picture's
// 910 columns, 1 for the burst window's 48), so a 128-thread block holds
// 4 / G lines.  Each thread of the group reads the line's table entries
// (one broadcast load each) and computes, from the first and the last
// output column, the clamped tap indices that bound the line's span: with
// steplen >= 0 the position `rel` is non-decreasing in the column (the
// float32 product and the float64 sum round monotonically), so the span
// is fixed by its two ends.  The span, widened to 16-byte chunks (the row
// must start 16-byte aligned and nsamp be a multiple of 4, so a chunk
// never leaves the row), is copied into shared memory with cp.async.cg
// (16 bytes, L1 bypassed; no register holds it), and the group computes
// its outputs from there and stores them coalesced.  Up to sixteen blocks
// of an SM are resident at once (the thread limit; their spans fit the
// shared memory), so one block's copies are in flight while another
// computes.  Measured on the card against 1, 2, 4 and 8 warps a line in
// 256-thread blocks, and persistent blocks with a two-line ring per group
// (48 registers, fewer resident blocks): none was faster (PERF.md,
// Findings).  The picture call beats a device-to-device copy of the same
// bytes; the burst-window call stays at its latency floor.  A line whose
// span does not fit its buffer (`cap` floats), whose steplen is negative
// or not finite, or whose tap index would overflow int32 -- a broken line
// table -- reads its taps from global memory instead, in the same kernel.
//
// Numerics: the operation order of the plain PyTorch version
// (tbc/resample.py::downscale_lines_split) is reproduced exactly on both
// paths, and the library is built with -fmad=false so no multiply-add is
// contracted: the kernel is bit-equal to the plain version run on the same
// card.  `rel` is the fused multiply-add the JAX package's compiled graph
// computes: the float32 product is exact in float64, so the float64 sum
// rounded to float32 is that single rounding (up to a double-rounding tie).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

struct Tap {
  int i0;      // clamped to [1, nsamp-3]
  float t;     // fractional position
  bool wrap;   // lli[l] + floor(rel) left the int32 range
};

__device__ __forceinline__ Tap tap_at(int si, float sf, float steplen,
                                      int k, float inv_w, int nsamp) {
  const float kw = (float)k * inv_w;
  const double relw = (double)steplen * (double)kw;
  const float rel = (float)((double)sf + relw);
  const float relf = floorf(rel);
  const int r = (int)relf;
  // the int32 sum wraps as the plain version's does (no signed overflow)
  const int i0 = (int)((unsigned)si + (unsigned)r);
  Tap tp;
  tp.t = rel - relf;
  tp.wrap = (long long)si + r != (long long)i0;
  tp.i0 = min(max(i0, 1), nsamp - 3);
  return tp;
}

// the four taps d[-1..2] around i0, weighted; d reads sample i
template <typename Load>
__device__ __forceinline__ float cubic(const Tap& tp, Load d) {
  const float t = tp.t;
  const float t2 = t * t;
  const float t3 = t2 * t;
  const float w0 = -0.5f * t3 + t2 - 0.5f * t;
  const float w1 = 1.5f * t3 - 2.5f * t2 + 1.0f;
  const float w2 = -1.5f * t3 + 2.0f * t2 + 0.5f * t;
  const float w3 = 0.5f * t3 - 0.5f * t2;
  return w0 * d(tp.i0 - 1) + w1 * d(tp.i0) + w2 * d(tp.i0 + 1)
         + w3 * d(tp.i0 + 2);
}

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__global__ void __launch_bounds__(kThreads)
resample_lines_kernel(const float* __restrict__ data,
                      const int* __restrict__ lli,
                      const float* __restrict__ llf,
                      float* __restrict__ out, int rows, int nsamp,
                      int nlines, long long ldi, long long ldf, int col0,
                      int ncols, float inv_w, float st_nom, int group,
                      int cap) {
  extern __shared__ __align__(16) float span[];
  const int slot = threadIdx.x / group;
  const int lane = threadIdx.x - slot * group;
  const int row = blockIdx.x * (kThreads / group) + slot;   // b*nlines + l
  const bool live = row < rows;
  float* buf = span + slot * cap;

  int b = 0, si = 0, lo = 0;
  float sf = 0.0f, steplen = 0.0f;
  bool staged = false;
  if (live) {
    b = row / nlines;
    const int l = row - b * nlines;
    const int* li = lli + b * ldi + l;
    const float* lf = llf + b * ldf + l;
    si = __ldg(li);
    sf = __ldg(lf);
    steplen = (float)(__ldg(li + 1) - si) + (__ldg(lf + 1) - sf);
    // rows start 16-byte aligned and end on a whole chunk
    const bool aligned =
        ((uintptr_t)data & 15) == 0 && (nsamp & 3) == 0;
    if (aligned && steplen >= 0.0f && isfinite(steplen) && inv_w >= 0.0f) {
      const Tap a = tap_at(si, sf, steplen, col0, inv_w, nsamp);
      const Tap z = tap_at(si, sf, steplen, col0 + ncols - 1, inv_w, nsamp);
      lo = (a.i0 - 1) & ~3;
      const int hi = (z.i0 + 2 + 4) & ~3;   // past the last tap, <= nsamp
      staged = !a.wrap && !z.wrap && hi - lo <= cap;
      if (staged) {
        const float* src = data + (size_t)b * nsamp + lo;
        for (int c = lane * 4; c < hi - lo; c += group * 4)
          cp_async16(buf + c, src + c);
      }
    }
  }
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::);
  __syncthreads();
  if (!live) return;

  const float wow = steplen / st_nom;
  float* o = out + (size_t)row * ncols;
  if (staged) {
    for (int c = lane; c < ncols; c += group) {
      const Tap tp = tap_at(si, sf, steplen, col0 + c, inv_w, nsamp);
      o[c] = cubic(tp, [&](int i) { return buf[i - lo]; }) * wow;
    }
  } else {
    const float* d = data + (size_t)b * nsamp;
    for (int c = lane; c < ncols; c += group) {
      const Tap tp = tap_at(si, sf, steplen, col0 + c, inv_w, nsamp);
      o[c] = cubic(tp, [&](int i) { return __ldg(d + i); }) * wow;
    }
  }
}

}  // namespace

// Plain C entry point (bound with ctypes).  data (B, nsamp) float32
// contiguous; lli (B, >= nlines+1) int32 and llf (B, >= nlines+1) float32
// with unit column stride and row strides ldi, ldf (elements); out
// (B, nlines, ncols) float32 contiguous; all on the current device.
// `group` threads (32, 64 or 128) resample a line; each line's span
// buffer holds `cap` floats (a multiple of 4).  Launches on `stream`
// without synchronising; returns cudaGetLastError(), or
// cudaErrorInvalidValue for a group or cap the kernel does not take.
extern "C" int resample_lines_launch(const float* data, const int* lli,
                                     const float* llf, float* out, int B,
                                     int nsamp, int nlines, long long ldi,
                                     long long ldf, int col0, int ncols,
                                     float inv_w, float st_nom, int group,
                                     int cap, void* stream) {
  if (B <= 0 || nlines <= 0 || ncols <= 0) return 0;
  if ((group != 32 && group != 64 && group != 128) || cap < 4 || cap % 4)
    return (int)cudaErrorInvalidValue;
  const int per_block = kThreads / group;
  const size_t smem = (size_t)per_block * cap * sizeof(float);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  const int rows = B * nlines;
  const int blocks = (rows + per_block - 1) / per_block;
  resample_lines_kernel<<<blocks, kThreads, smem, (cudaStream_t)stream>>>(
      data, lli, llf, out, rows, nsamp, nlines, ldi, ldf, col0, ncols, inv_w,
      st_nom, group, cap);
  return (int)cudaGetLastError();
}
