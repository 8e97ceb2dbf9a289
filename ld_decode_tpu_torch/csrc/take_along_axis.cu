// take_along_axis over a 2-D float32 operand with int32 indices, for Hopper.
//
// Replaces the TPU Pallas kernel scripts/probe_warp.py:118
// (probe_dyngather's `kern`: out = take_along_axis(op, idx, axis), Mosaic's
// lane-local dynamic_gather), which was written to size a gather kernel for
// the Farneback warp.  Here it is that gather: the single `take` of 20-wide
// quad-expanded rows in ld_decode_tpu/comb/optflow.py:160, whose index
// (y0*w + x0) is broadcast across the row -- take_along_axis on axis 0.
//
//   axis 0: out[i, j] = op[clamp(idx[i, j], 0, op_rows-1), j]
//   axis 1: out[i, j] = op[i, clamp(idx[i, j], 0, op_cols-1)]
//
// idx is read through its strides, so the warp's stride-0 broadcast view of
// one index per row is read in place (no 20x index tensor).  Indices are in
// range at both call sites; the clamp keeps a stray one inside the tensor.
//
// What bounds it on the card: memory traffic.  At the warp's full pyramid
// level one call gathers both fields (2 x 252 x 840 = 423,360 rows of 20
// floats): at most 33.9 MB gathered, 33.9 MB written and 1.7 MB of index,
// ~20.7 us at 3.35 TB/s; rows that no pixel samples are not read, so the
// bound of a given index counts only the distinct rows it reads.  The whole
// operand (33.9 MB) fits in the 50 MB L2, so the three warps of a level may
// find it there.  Design, simple first: one thread per output element in
// row-major order, so a warp writes 32 consecutive floats, and for the
// axis-0 gather the 32 threads read 1.6 rows of 80 contiguous bytes each;
// __ldg on the operand and the index; a grid-stride loop over a grid capped
// at a few blocks per SM.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;

template <int kAxis>
__global__ void __launch_bounds__(kThreads)
take_along_axis_kernel(const float* __restrict__ op,
                       const int* __restrict__ idx,
                       float* __restrict__ out, int rows_out, int cols_out,
                       int op_rows, int op_cols, long long is0,
                       long long is1) {
  const long long total = (long long)rows_out * cols_out;
  const long long step = (long long)gridDim.x * kThreads;
  for (long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
       t < total; t += step) {
    const int i = (int)(t / cols_out);
    const int j = (int)(t - (long long)i * cols_out);
    int k = __ldg(idx + i * is0 + j * is1);
    if (kAxis == 0) {
      k = min(max(k, 0), op_rows - 1);
      out[t] = __ldg(op + (long long)k * op_cols + j);
    } else {
      k = min(max(k, 0), op_cols - 1);
      out[t] = __ldg(op + (long long)i * op_cols + k);
    }
  }
}

}  // namespace

// Plain C entry point (bound with ctypes).  op (op_rows, op_cols) float32
// contiguous; idx int32 of shape (rows_out, cols_out) with element strides
// (is0, is1); out (rows_out, cols_out) float32 contiguous; all on the
// current device.  Launches on `stream` without synchronising; returns
// cudaGetLastError().
extern "C" int take_along_axis_launch(const float* op, const int* idx,
                                      float* out, int rows_out,
                                      int cols_out, int op_rows, int op_cols,
                                      long long is0, long long is1, int axis,
                                      void* stream) {
  const long long total = (long long)rows_out * cols_out;
  if (total <= 0) return 0;
  long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  cudaStream_t s = (cudaStream_t)stream;
  if (axis == 0) {
    take_along_axis_kernel<0><<<(int)blocks, kThreads, 0, s>>>(
        op, idx, out, rows_out, cols_out, op_rows, op_cols, is0, is1);
  } else {
    take_along_axis_kernel<1><<<(int)blocks, kThreads, 0, s>>>(
        op, idx, out, rows_out, cols_out, op_rows, op_cols, is0, is1);
  }
  return (int)cudaGetLastError();
}
