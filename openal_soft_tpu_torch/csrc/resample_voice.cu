// General-pitch voice resampler, one voice per thread block, for NVIDIA
// Hopper (sm_90a).
//
// Replaces the TPU kernel openal_soft_tpu/ops/pallas/resample.py `_kernel`
// (the first-generation resampler: one voice per grid program, two window
// DMAs per voice, then lane gathers over the windows).  It computes
// ops/resample.py `resample_voices` at any increment, for every tier, with
// the arithmetic of csrc/resample_gen.cu:
//
//   total = pos_frac + t*inc (64-bit),  pos = pos_int + (total >> 16)
//   phase = (total & 0xffff) >> 11,  pf = (total & 2047) / 2048
//   w_j   = (fil + sf*scd) + pf*(phd + sf*spd)   rows [bank_row, phase, j]
//   out[v, t] = sum_{j < taps} w_j * src_v(resolve(pos + j - center))
//
// Design: the block stages two windows of `span` frames in dynamic shared
// memory, as the TPU kernel's DMAs did: window 1 from the voice's resolved
// base (pos_int + (pos_frac >> 16) - center, wrapped into the loop when
// past it, clamped to [0, len-1]), and for a looping voice window 2 from
// loop_start.  The wrapper picks `span` from the TPU kernel's buckets
// (2048-11264 frames, up to 2 x 45 KB, which needs the shared memory
// opt-in) so that window 1 covers every tap the block's outputs read
// before a loop seam; past a seam the resolved frames lie within
// [loop_start, loop_start + span), so a loop shorter than the window sits
// whole in window 2.  Then the block's 256 threads stride over the outputs
// and resolve every tap as K3 does (forward wrap, backward wrap once
// wrapped, end clamp, silence before frame 0 and for empty sources),
// reading the resolved frame from the window that holds it.  Staged reads
// clamp their pool address to [0, pool_len - 1] as K3's reads do.
//
// What bounds it: the bytes, each voice's two windows read once and the
// output written once.  One block per voice leaves the card with V blocks
// of `n` outputs each, which suits many voices and short blocks (the TPU
// kernel's T = 1024) and serialises a long window on one SM.
//
// Exactness: products and sums are rounded one by one (__fmul_rn,
// __fadd_rn) in the plain version's order, taps j = 0..taps-1 from 0.0f,
// so the kernel equals the plain torch version bit for bit.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMeta = 12;
constexpr int kPhases = 32;
constexpr int kRows = 52;

__device__ __forceinline__ float pool_at(const float* __restrict__ pool,
                                         long long pool_len, long long a) {
  a = a < 0 ? 0 : (a >= pool_len ? pool_len - 1 : a);
  return pool[a];
}

__device__ __forceinline__ int wrap_into_loop(int s, int ls, int loop_len) {
  int r = (s - ls) % loop_len;   // C truncates toward zero:
  if (r < 0) r += loop_len;      // make it non-negative like jnp.mod
  return r + ls;
}

__global__ void __launch_bounds__(kThreads)
resample_voice_kernel(const float* __restrict__ pool, long long pool_len,
                      const int* __restrict__ meta,
                      const float* __restrict__ sf,
                      const float* __restrict__ bank,
                      float* __restrict__ out, int W, int taps, int span) {
  extern __shared__ float win[];   // [2, span]: from the base, from loop_start
  float* win2 = win + span;
  const int v = blockIdx.x;

  // meta row: src_off, src_len, loop_start, loop_end, has_loop,
  // has_wrapped, pos_int, pos_frac, increment, bank_row, (unused) x2
  const int* m = meta + static_cast<long long>(kMeta) * v;
  const long long off = m[0];
  const int len = m[1];
  const int ls = m[2];
  const int le = m[3];
  const bool has_loop = m[4] != 0;
  const bool has_wrapped = m[5] != 0;
  const int pos_int = m[6];
  const long long frac0 = m[7];
  const long long inc = m[8];
  const int center = taps / 2 - 1;
  const int loop_len = max(le - ls, 1);
  const int last = max(len - 1, 0);

  const int base = pos_int + static_cast<int>(frac0 >> 16) - center;
  int base_res = base;
  if (has_loop && (base >= le || (has_wrapped && base < ls))) {
    base_res = wrap_into_loop(base, ls, loop_len);
  }
  base_res = min(max(base_res, 0), last);
  for (int i = threadIdx.x; i < span; i += kThreads) {
    win[i] = pool_at(pool, pool_len, off + base_res + i);
    if (has_loop) win2[i] = pool_at(pool, pool_len, off + ls + i);
  }
  __syncthreads();

  const float s = sf[v];
  const long long plane = static_cast<long long>(kRows) * kPhases * taps;
  for (int t = threadIdx.x; t < W; t += kThreads) {
    const long long total = frac0 + t * inc;
    const int pos = pos_int + static_cast<int>(total >> 16);
    const int fr = static_cast<int>(total & 0xFFFF);
    const float pf =
        __fmul_rn(static_cast<float>(fr & 2047), 1.0f / 2048.0f);
    const float* fil =
        bank + (static_cast<long long>(m[9]) * kPhases + (fr >> 11)) * taps;
    const float* phd = fil + plane;
    const float* scd = fil + 2 * plane;
    const float* spd = fil + 3 * plane;
    float acc = 0.0f;
    for (int j = 0; j < taps; ++j) {
      const float w0 = __fadd_rn(__ldg(fil + j), __fmul_rn(s, __ldg(scd + j)));
      const float wd = __fadd_rn(__ldg(phd + j), __fmul_rn(s, __ldg(spd + j)));
      const float w = __fadd_rn(w0, __fmul_rn(pf, wd));
      const int si = pos + j - center;
      int idx;
      if (has_loop) {
        idx = (si >= le || (has_wrapped && si < ls))
                  ? wrap_into_loop(si, ls, loop_len) : si;
      } else {
        idx = min(si, last);
      }
      float val = 0.0f;
      if (si >= 0 && len > 0) {
        const int i1 = idx - base_res;
        if (i1 >= 0 && i1 < span) {
          val = win[i1];
        } else {
          val = win2[min(max(idx - ls, 0), span - 1)];
        }
      }
      acc = __fadd_rn(acc, __fmul_rn(w, val));
    }
    out[static_cast<long long>(v) * W + t] = acc;
  }
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 on success), or the
// error of raising the kernel's dynamic shared memory limit to 2 * span
// floats.  bank: [4 (fil, phd, scd, spd), 52, 32, taps] f32.
extern "C" int resample_voice_launch(const float* pool, long long pool_len,
                                     const int* meta, const float* sf,
                                     const float* bank, float* out, int V,
                                     int W, int taps, int span, void* stream) {
  if (V <= 0 || W <= 0 || taps <= 0 || pool_len <= 0 || span <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = 2 * static_cast<size_t>(span) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      resample_voice_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  resample_voice_kernel<<<V, kThreads, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      pool, pool_len, meta, sf, bank, out, W, taps, span);
  return static_cast<int>(cudaGetLastError());
}
