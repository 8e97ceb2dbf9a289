// The CX expander's dual-speed envelope followers over independent lanes,
// for Hopper.
//
// Stands behind no Pallas kernel: the JAX package runs these recurrences as
// lax.scan, which XLA compiles to a loop (ld_decode_tpu/audio/cx.py:87-94
// `_envelope_scan`, one lane over the input, and :119-165
// `_blocked_envelopes`, a lower- and an upper-bound lane per block).
// PyTorch has no operator for a sequential scan, and as tensor code on the
// card each of a 1 MB chunk's ~393k steps would be several launches.  Here
// one thread runs one lane.
//
// A lane: a start position in menv (below 0 in a block's head padding), a
// start state (fast, slow), `nwarm` steps whose states are not written,
// then `ncore` steps whose (fast, slow) trajectory is.  Each step is the
// reference's (cx-expander.cxx:53-60) as XLA:CPU compiles the JAX package's
// `_env_step`, the multiply-adds fused:
//     f' = f * 0.9998;    f = m > f' ? min(m, fma(m, 0.040, f'))  : f'
//     s' = s * 0.999985;  s = m > s' ? min(m, fma(m, 0.0020, s')) : s'
// (the constants arrive as arguments, rounded to float32 as JAX rounds
// them).  A position before 0 holds the state; one past the end of menv
// reads m = 0, as the JAX package's zero padding does.
//
// What bounds it: the dependent chain.  A lane's steps are one chain, so a
// step costs the latency of its longest dependent path, not the card's
// throughput.  Written as above the path is FMUL -> FFMA -> FMNMX -> FSEL.
// With m >= 0 and f' >= 0, fma(m, k, f') >= f', so the step is exactly
//     f = min(max(f', m), fma(m, k, f'))
// (m <= f' gives f', m > f' gives min(m, fma)): FMUL -> {FMNMX, FFMA} ->
// FMNMX, three dependent FP32 operations, the fast and slow chains
// interleaved.  m is clamped to >= 0 when it is loaded, off the chain; with
// a state >= 0 (the wrapper checks the start states) a negative or NaN m
// then leaves the state as the reference's step does.  At the production
// geometry a 1 MB chunk of 16-bit stereo (262,144 samples) is two blocks of
// 131,072 core and 262,144 warm steps, lower and upper bound each: four
// lanes of 393,216 steps, ~1.2M dependent operations a lane against ~5 MB
// to move, ~1.5 us at 3.35 TB/s.  Everything else stays off the chain:
// menv arrives as float4 loads issued a group of 32 steps before use, with
// an L2 prefetch four groups ahead, and each lane's trajectory leaves as
// float4 stores that nothing waits on.  No shared memory and no tensor
// cores: a launch is a few threads of one warp.
//
// The wrapper (audio/cuda_cx.py) pads menv with zeros past the last
// position any lane reads, prefetch distance included, and hands over
// starts, nwarm and ncore that are multiples of 4, so that every load and
// store is a whole aligned float4.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 32;
constexpr int kGroup = 8;        // float4 loads a group: 32 steps
constexpr int kPrefetch = 4;     // groups ahead for the L2 prefetch

struct Consts {
  float fast_decay, fast_attack, slow_decay, slow_attack;
};

__device__ __forceinline__ void step(float& f, float& s, float m,
                                     const Consts& k) {
  const float fd = f * k.fast_decay;
  const float sd = s * k.slow_decay;
  f = fminf(fmaxf(fd, m), __fmaf_rn(m, k.fast_attack, fd));
  s = fminf(fmaxf(sd, m), __fmaf_rn(m, k.slow_attack, sd));
}

__device__ __forceinline__ float4 load(const float4* p) {
  float4 v = __ldg(p);
  v.x = fmaxf(v.x, 0.f);
  v.y = fmaxf(v.y, 0.f);
  v.z = fmaxf(v.z, 0.f);
  v.w = fmaxf(v.w, 0.f);
  return v;
}

template <bool kStore>
__device__ __forceinline__ void group(const float4 (&buf)[kGroup], float& f,
                                      float& s, float4* __restrict__ of,
                                      float4* __restrict__ os,
                                      const Consts& k) {
#pragma unroll
  for (int u = 0; u < kGroup; ++u) {
    float4 fo, so;
    step(f, s, buf[u].x, k); fo.x = f; so.x = s;
    step(f, s, buf[u].y, k); fo.y = f; so.y = s;
    step(f, s, buf[u].z, k); fo.z = f; so.z = s;
    step(f, s, buf[u].w, k); fo.w = f; so.w = s;
    if (kStore) {
      of[u] = fo;
      os[u] = so;
    }
  }
}

__device__ __forceinline__ void fill(float4 (&buf)[kGroup],
                                     const float4* __restrict__ src) {
  asm volatile("prefetch.global.L2 [%0];" ::"l"(src + kPrefetch * kGroup));
#pragma unroll
  for (int u = 0; u < kGroup; ++u) buf[u] = load(src + u);
}

// n4 float4 steps-of-4 from src; with kStore, the states after each step go
// to of/os (float4 per 4 steps).  Loads of the group after the current one
// are in flight while it runs (two register buffers, used in turn).
template <bool kStore>
__device__ void run(const float4* __restrict__ src, int n4, float& f,
                    float& s, float4* __restrict__ of,
                    float4* __restrict__ os, const Consts& k) {
  const int ngroups = n4 / kGroup;
  float4 a[kGroup], b[kGroup];
  fill(a, src);
  int g = 0;
  for (; g + 2 <= ngroups; g += 2) {
    fill(b, src + (g + 1) * kGroup);
    group<kStore>(a, f, s, of + g * kGroup, os + g * kGroup, k);
    fill(a, src + (g + 2) * kGroup);
    group<kStore>(b, f, s, of + (g + 1) * kGroup, os + (g + 1) * kGroup, k);
  }
  if (g < ngroups) {
    group<kStore>(a, f, s, of + g * kGroup, os + g * kGroup, k);
    ++g;
  }
  for (int i = g * kGroup; i < n4; ++i) {
    const float4 m = load(src + i);
    float4 fo, so;
    step(f, s, m.x, k); fo.x = f; so.x = s;
    step(f, s, m.y, k); fo.y = f; so.y = s;
    step(f, s, m.z, k); fo.z = f; so.z = s;
    step(f, s, m.w, k); fo.w = f; so.w = s;
    if (kStore) {
      of[i] = fo;
      os[i] = so;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
cx_envelope_kernel(const float* __restrict__ menv,
                   const int* __restrict__ starts,
                   const float* __restrict__ state0, int nlanes, int nwarm,
                   int ncore, float* __restrict__ out_fast,
                   float* __restrict__ out_slow, Consts k) {
  const int lane = blockIdx.x * kThreads + threadIdx.x;
  if (lane >= nlanes) return;
  float f = state0[2 * lane], s = state0[2 * lane + 1];
  const int start = starts[lane];
  const int nsteps = nwarm + ncore;
  float4* of = (float4*)(out_fast + (long long)lane * ncore);
  float4* os = (float4*)(out_slow + (long long)lane * ncore);
  // steps at positions before 0 hold the state; where they reach into the
  // written span, the held state is what is written
  const int j0 = start < 0 ? min(-start, nsteps) : 0;
  for (int j = nwarm; j < j0; j += 4) {
    of[(j - nwarm) / 4] = make_float4(f, f, f, f);
    os[(j - nwarm) / 4] = make_float4(s, s, s, s);
  }
  const float4* src = (const float4*)menv + (start + j0) / 4;
  const int jw = max(j0, nwarm);        // first written step
  run<false>(src, (jw - j0) / 4, f, s, nullptr, nullptr, k);
  run<true>(src + (jw - j0) / 4, (nsteps - jw) / 4, f, s,
            of + (jw - nwarm) / 4, os + (jw - nwarm) / 4, k);
}

}  // namespace

// Plain C entry point (bound with ctypes).  menv: float32, 16-byte aligned,
// zero-padded past every position a lane reads plus (kPrefetch + 2) groups;
// starts: nlanes int32 (multiples of 4); state0: nlanes (fast, slow) float32
// pairs, all >= 0; out_fast/out_slow: (nlanes, ncore) float32; nwarm and
// ncore multiples of 4; all on the current device.  Launches on `stream`
// without synchronising and returns cudaGetLastError() (or
// cudaErrorInvalidValue for arguments the kernel does not take).
extern "C" int cx_envelope_launch(const float* menv, const int* starts,
                                  const float* state0, int nlanes, int nwarm,
                                  int ncore, float* out_fast, float* out_slow,
                                  float fast_decay, float fast_attack,
                                  float slow_decay, float slow_attack,
                                  void* stream) {
  if (nlanes < 0 || nwarm < 0 || ncore < 0 || nwarm % 4 || ncore % 4
      || ((uintptr_t)menv | (uintptr_t)out_fast | (uintptr_t)out_slow) & 15)
    return (int)cudaErrorInvalidValue;
  if (nlanes == 0 || nwarm + ncore == 0) return 0;
  const Consts k{fast_decay, fast_attack, slow_decay, slow_attack};
  const int blocks = (nlanes + kThreads - 1) / kThreads;
  cx_envelope_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      menv, starts, state0, nlanes, nwarm, ncore, out_fast, out_slow, k);
  return (int)cudaGetLastError();
}
