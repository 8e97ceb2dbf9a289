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
// batch (16 fields x 263 lines) reads ~16 x 263 x 2542 x 4 B = 43 MB of the
// demod tap and writes 16 x 263 x 910 x 4 B = 15 MB: tens of microseconds
// at 3.35 TB/s.  The design is the simple one: one thread per output
// sample, blocks tiling (B*nlines) x ceil(ncols/128).  Neighbouring threads
// read neighbouring addresses ~2.8 samples apart, so the four taps of a
// warp fall into a few cache lines and the L1/L2 absorb the overlap.  A
// shared-memory staged line window (or TMA) is later work.
//
// Numerics: the operation order of the plain PyTorch version
// (tbc/resample.py::downscale_lines_split) is reproduced exactly, and the
// library is built with -fmad=false so no multiply-add is contracted: the
// kernel is bit-equal to the plain version run on the same card.  `rel` is
// the fused multiply-add the JAX package's compiled graph computes: the
// float32 product is exact in float64, so the float64 sum rounded to
// float32 is that single rounding (up to a double-rounding tie).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
resample_lines_kernel(const float* __restrict__ data,
                      const int* __restrict__ lli,
                      const float* __restrict__ llf,
                      float* __restrict__ out,
                      int nsamp, int nlines, int ld,
                      int col0, int ncols, float inv_w, float st_nom) {
  const int row = blockIdx.x;                 // b * nlines + l
  const int c = blockIdx.y * kThreads + threadIdx.x;
  if (c >= ncols) return;
  const int b = row / nlines;
  const int l = row - b * nlines;

  const int* li = lli + (size_t)b * ld + l;
  const float* lf = llf + (size_t)b * ld + l;
  const int si = __ldg(li);
  const float sf = __ldg(lf);
  const float steplen = (float)(__ldg(li + 1) - si) + (__ldg(lf + 1) - sf);

  const float kw = (float)(col0 + c) * inv_w;
  const double relw = (double)steplen * (double)kw;
  const float rel = (float)((double)sf + relw);
  const float relf = floorf(rel);
  const float t = rel - relf;
  int i0 = si + (int)relf;
  i0 = min(max(i0, 1), nsamp - 3);

  const float t2 = t * t;
  const float t3 = t2 * t;
  const float w0 = -0.5f * t3 + t2 - 0.5f * t;
  const float w1 = 1.5f * t3 - 2.5f * t2 + 1.0f;
  const float w2 = -1.5f * t3 + 2.0f * t2 + 0.5f * t;
  const float w3 = 0.5f * t3 - 0.5f * t2;

  const float* d = data + (size_t)b * nsamp + i0;
  const float acc = w0 * __ldg(d - 1) + w1 * __ldg(d) + w2 * __ldg(d + 1)
                    + w3 * __ldg(d + 2);
  const float wow = steplen / st_nom;
  out[(size_t)row * ncols + c] = acc * wow;
}

}  // namespace

// Plain C entry point (bound with ctypes).  data (B, nsamp) float32,
// lli (B, ld) int32, llf (B, ld) float32 with ld >= nlines+1, out
// (B, nlines, ncols) float32, all contiguous on the current device.
// Launches on `stream` without synchronising; returns cudaGetLastError().
extern "C" int resample_lines_launch(const float* data, const int* lli,
                                     const float* llf, float* out, int B,
                                     int nsamp, int nlines, int ld,
                                     int col0, int ncols, float inv_w,
                                     float st_nom, void* stream) {
  if (B <= 0 || nlines <= 0 || ncols <= 0) return 0;
  dim3 grid(B * nlines, (ncols + kThreads - 1) / kThreads);
  resample_lines_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      data, lli, llf, out, nsamp, nlines, ld, col0, ncols, inv_w, st_nom);
  return (int)cudaGetLastError();
}
