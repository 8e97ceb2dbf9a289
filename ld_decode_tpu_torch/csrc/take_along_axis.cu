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
// floats): 33.9 MB written, at most 33.9 MB gathered (only the distinct
// rows the index reads count toward the bound) and 1.7 MB of index,
// ~19-21 us at 3.35 TB/s.  Each output element waits on two dependent
// loads (its row index, then the operand), so the rate depends on how
// many of them are in flight and on the instructions spent per byte: a
// thread per 4-byte element would issue four times the loads of a thread
// per 16-byte chunk, and a 64-bit division per element costs more
// instructions than the copy.
//
// Two paths, chosen by the wrapper (ops/cuda_gather.py::row_gather_ok):
//
// - take_rows_kernel, the row gather: axis 0 with one index per row
//   (idx.stride(1) == 0), a width that is a multiple of 4 floats, and op
//   and out 16-byte aligned.  Each output row is a copy of one operand row,
//   so a thread moves one 16-byte chunk (5 per row at width 20): one index
//   load, one 16-byte operand load, one 16-byte store, neighbouring threads
//   on neighbouring chunks of the output; 32-bit index arithmetic.  Blocks
//   of 256 threads that finish after one chunk each keep the SMs full of
//   independent loads.  Measured
//   on the card against 2, 4 and 8 chunks a thread, a persistent grid,
//   128- and 512-thread blocks, streaming stores, and a cp.async ring of
//   128-row tiles in shared memory written out by the threads or by one
//   cp.async.bulk store: none was faster (PERF.md, Findings).  At the full
//   level it beats a device-to-device copy of the same bytes; that copy,
//   not the kernel, sets how near the card comes to the bound.
// - take_along_axis_kernel, every other case (axis 1, a full index, widths
//   not a multiple of 4, unaligned views): a thread per element, with
//   32-bit index arithmetic where the element count allows it.
//
// Both paths clamp stray indices the same way and are bit-equal to the
// plain version (ops/gather.py::take_along_axis_plain): they move values
// and compute nothing.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;

template <int kAxis, typename I>
__global__ void __launch_bounds__(kThreads)
take_along_axis_kernel(const float* __restrict__ op,
                       const int* __restrict__ idx,
                       float* __restrict__ out, int rows_out, int cols_out,
                       int op_rows, int op_cols, long long is0,
                       long long is1) {
  const I total = (I)rows_out * (I)cols_out;
  const I step = (I)gridDim.x * kThreads;
  for (I t = (I)blockIdx.x * kThreads + threadIdx.x; t < total; t += step) {
    const int i = (int)(t / (I)cols_out);
    const int j = (int)(t - (I)i * (I)cols_out);
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

// out row i = op row clamp(idx[i * is0]); q 16-byte chunks a row, one
// chunk a thread.
__global__ void __launch_bounds__(kThreads)
take_rows_kernel(const float4* __restrict__ op, const int* __restrict__ idx,
                 float4* __restrict__ out, unsigned nchunks, unsigned q,
                 int op_rows, long long is0) {
  const unsigned t = blockIdx.x * kThreads + threadIdx.x;
  if (t >= nchunks) return;
  const unsigned i = t / q;
  int k = __ldg(idx + i * is0);
  k = min(max(k, 0), op_rows - 1);
  out[t] = __ldg(op + (long long)k * q + (t - i * q));
}

}  // namespace

// Plain C entry points (bound with ctypes).  Both launch on `stream`
// without synchronising and return cudaGetLastError() (or
// cudaErrorInvalidValue for arguments the kernel does not take).
//
// The general path.  op (op_rows, op_cols) float32 contiguous; idx int32
// of shape (rows_out, cols_out) with element strides (is0, is1); out
// (rows_out, cols_out) float32 contiguous; all on the current device.
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
  // 32-bit element indices while t + grid stride cannot wrap
  const bool narrow = total < (1LL << 31);
  const int g = (int)blocks;
  if (axis == 0 && narrow) {
    take_along_axis_kernel<0, unsigned><<<g, kThreads, 0, s>>>(
        op, idx, out, rows_out, cols_out, op_rows, op_cols, is0, is1);
  } else if (axis == 0) {
    take_along_axis_kernel<0, long long><<<g, kThreads, 0, s>>>(
        op, idx, out, rows_out, cols_out, op_rows, op_cols, is0, is1);
  } else if (narrow) {
    take_along_axis_kernel<1, unsigned><<<g, kThreads, 0, s>>>(
        op, idx, out, rows_out, cols_out, op_rows, op_cols, is0, is1);
  } else {
    take_along_axis_kernel<1, long long><<<g, kThreads, 0, s>>>(
        op, idx, out, rows_out, cols_out, op_rows, op_cols, is0, is1);
  }
  return (int)cudaGetLastError();
}

// The row gather.  op (op_rows, cols) float32 contiguous and out
// (rows_out, cols) float32 contiguous, both 16-byte aligned, cols a
// multiple of 4 with rows_out * cols / 4 < 2^31; idx int32, row i's index
// at idx[i * is0].
extern "C" int take_rows_launch(const float* op, const int* idx, float* out,
                                int rows_out, int cols, int op_rows,
                                long long is0, void* stream) {
  if (((uintptr_t)op | (uintptr_t)out) & 15 || cols % 4 || cols <= 0
      || op_rows <= 0 || rows_out < 0)
    return (int)cudaErrorInvalidValue;
  const long long nchunks = (long long)rows_out * (cols / 4);
  if (nchunks >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  if (nchunks == 0) return 0;
  const int blocks = (int)((nchunks + kThreads - 1) / kThreads);
  take_rows_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const float4*)op, idx, (float4*)out, (unsigned)nchunks,
      (unsigned)(cols / 4), op_rows, is0);
  return (int)cudaGetLastError();
}
