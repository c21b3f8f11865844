// Dual interpolating biquad (the voices' direct and send filters) for
// NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel openal_soft_tpu/ops/pallas/biquad.py `_kernel`
// (time-major (T, V/128, 128) tiles, 1024-voice programs, T % 256 == 0).
// It computes ops/filters.py `biquad_dual_interp`: per line, two cascaded
// TDF2 biquads (BiquadInterpFilter::dualProcess, biquad.cpp:284-343)
//
//   y0 = x*b00 + z00;  z00 = (x*b01 - y0*a01) + z01;  z01 = x*b02 - y0*a02
//   y1 = y0*b10 + z10; z10 = (y0*b11 - y1*a11) + z11; z11 = y0*b12 - y1*a12
//
// and after every 32 samples the coefficients step toward their targets:
// cnt2 = max(cnt - 32, 0), a = 1/(cnt2/32 + 1), cf = cnt > 0 ? (cnt2 == 0 ?
// target : cf + (target - cf)*a) : cf.  Any V, any T that is a multiple of
// 32; the state (z, coefficients, counter) is written once, at the end.
//
// What bounds it: the bytes, x read once and y written once (33.6 MB at the
// main path's V = 4096, T = 1024: ~0.010 ms at 3.35 TB/s); the arithmetic
// is 18 flops per sample.  But each line is one dependent chain of ~16
// cycles per sample (add -> mul -> sub -> add through the state), and the
// main path has only 4096 lines, about one warp per SM: the chain's
// latency, not bandwidth, sets the time.  Design: one thread per line
// walks T in order, reading and writing its own row as float4 in
// 32-sample steps (the lerp cadence), with the next step's eight float4
// loads issued before the current step's arithmetic so their latency
// overlaps it.  A warp's 32 rows are 32 separate lines of cache; each is
// read whole over eight consecutive loads, so the bytes move once.  (A
// first version staged [32 lines x 32 samples] tiles through shared
// memory for coalesced accesses; it took 2.2x as long on the card.)
//
// Exactness: every product, sum and difference rounds on its own
// (__fmul_rn, __fadd_rn, __fsub_rn, no FMA contraction) in the plain
// version's order, and a is a correctly rounded division, so the kernel
// equals the plain torch version bit for bit.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 32;
constexpr int kStep = 32;    // samples per step = the lerp cadence
constexpr int kVec = kStep / 4;
constexpr int kCoeffs = 10;  // [b0, b1, b2, a1, a2] for each of 2 biquads

__global__ void __launch_bounds__(kThreads)
biquad_dual_kernel(const float* __restrict__ x, const float* __restrict__ z,
                   const float* __restrict__ cf,
                   const float* __restrict__ target,
                   const int* __restrict__ counter, float* __restrict__ y,
                   float* __restrict__ z_out, float* __restrict__ cf_out,
                   int* __restrict__ counter_out, int V, int T) {
  const int v = blockIdx.x * kThreads + threadIdx.x;
  if (v >= V) return;
  float z00 = z[4 * v + 0], z01 = z[4 * v + 1];
  float z10 = z[4 * v + 2], z11 = z[4 * v + 3];
  float c[kCoeffs], g[kCoeffs];
#pragma unroll
  for (int i = 0; i < kCoeffs; ++i) {
    c[i] = cf[kCoeffs * v + i];
    g[i] = target[kCoeffs * v + i];
  }
  int cnt = counter[v];
  const float4* xr =
      reinterpret_cast<const float4*>(x + static_cast<long long>(v) * T);
  float4* yr = reinterpret_cast<float4*>(y + static_cast<long long>(v) * T);

  const int n = T / kStep;
  float4 next[kVec];
#pragma unroll
  for (int i = 0; i < kVec; ++i) next[i] = __ldg(xr + i);
  for (int k = 0; k < n; ++k) {
    float s[kStep];
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      s[4 * i + 0] = next[i].x;
      s[4 * i + 1] = next[i].y;
      s[4 * i + 2] = next[i].z;
      s[4 * i + 3] = next[i].w;
    }
    if (k + 1 < n) {
#pragma unroll
      for (int i = 0; i < kVec; ++i) next[i] = __ldg(xr + kVec * (k + 1) + i);
    }
#pragma unroll
    for (int t = 0; t < kStep; ++t) {
      const float xin = s[t];
      const float y0 = __fadd_rn(__fmul_rn(xin, c[0]), z00);
      const float n00 = __fadd_rn(__fsub_rn(__fmul_rn(xin, c[1]),
                                            __fmul_rn(y0, c[3])), z01);
      const float n01 = __fsub_rn(__fmul_rn(xin, c[2]), __fmul_rn(y0, c[4]));
      const float y1 = __fadd_rn(__fmul_rn(y0, c[5]), z10);
      const float n10 = __fadd_rn(__fsub_rn(__fmul_rn(y0, c[6]),
                                            __fmul_rn(y1, c[8])), z11);
      const float n11 = __fsub_rn(__fmul_rn(y0, c[7]), __fmul_rn(y1, c[9]));
      z00 = n00;
      z01 = n01;
      z10 = n10;
      z11 = n11;
      s[t] = y1;
    }
#pragma unroll
    for (int i = 0; i < kVec; ++i)
      yr[kVec * k + i] = make_float4(s[4 * i], s[4 * i + 1], s[4 * i + 2],
                                     s[4 * i + 3]);

    const int cnt2 = max(cnt - kStep, 0);
    const float a = __fdiv_rn(1.0f, __fadd_rn(static_cast<float>(cnt2 / kStep),
                                              1.0f));
#pragma unroll
    for (int i = 0; i < kCoeffs; ++i) {
      const float lerped = __fadd_rn(c[i], __fmul_rn(__fsub_rn(g[i], c[i]), a));
      c[i] = cnt > 0 ? (cnt2 == 0 ? g[i] : lerped) : c[i];
    }
    cnt = cnt2;
  }

  z_out[4 * v + 0] = z00;
  z_out[4 * v + 1] = z01;
  z_out[4 * v + 2] = z10;
  z_out[4 * v + 3] = z11;
#pragma unroll
  for (int i = 0; i < kCoeffs; ++i) cf_out[kCoeffs * v + i] = c[i];
  counter_out[v] = cnt;
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for V < 1, T < 1, T % 32 != 0, or x or y not
// 16-byte aligned (the rows are read and written as float4).
extern "C" int biquad_dual_launch(const float* x, const float* z,
                                  const float* cf, const float* target,
                                  const int* counter, float* y, float* z_out,
                                  float* cf_out, int* counter_out, int V,
                                  int T, void* stream) {
  if (V < 1 || T < 1 || T % kStep != 0 ||
      reinterpret_cast<unsigned long long>(x) % 16 != 0 ||
      reinterpret_cast<unsigned long long>(y) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (V + kThreads - 1) / kThreads;
  biquad_dual_kernel<<<blocks, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      x, z, cf, target, counter, y, z_out, cf_out, counter_out, V, T);
  return static_cast<int>(cudaGetLastError());
}
