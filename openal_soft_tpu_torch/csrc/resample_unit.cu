// Unit-increment (native-rate) voice resampler for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernels of openal_soft_tpu/ops/pallas/resample_unit.py:
// `_kernel_shared` (all voices read one VMEM image of the active pool
// regions, staged by grid program 0) and `_kernel` (one span DMA per voice
// when the pool is too large to stage).  Here both are this one kernel,
// reading the pool straight from global memory.
//
//   out[v, t] = sum_{j < taps} w[v, j] * src_v(resolve(pos_int[v] + t + j - center))
//
// resolve() is ops/resample.resolve_source_index: a looping voice wraps
// forward past loop_end and, once it has wrapped, backward below
// loop_start (non-negative modulo); a non-looping voice clamps to its last
// frame; s < 0 or src_len == 0 reads silence.  Pool reads clamp to
// [0, pool_len - 1] like jnp.take(mode="clip").  Every tap resolves on its
// own, so the TPU kernels' single-seam window condition does not exist here.
//
// What bounds it: one launch writes V*W floats (268 MB at the main path's
// V=4096, W=16384) and reads taps*V*W pool samples, but neighbouring
// threads read neighbouring samples of one voice, so the reads coalesce
// and hit L1/L2 (the best_case pool, 48 one-second buffers = 9.2 MB, stays
// in the 50 MB L2).  The kernel is bound by its output writes.  Design:
// one thread per output sample, a block covers 256 consecutive samples of
// one voice (its scalars load once per block, broadcast from cache), and
// the voice axis is folded into blockIdx.x (gridDim.y/z stop at 65535).
//
// Exactness: the products and sums are rounded one by one
// (__fmul_rn/__fadd_rn, taps in order j = 0..taps-1, starting from 0.0f),
// so nvcc cannot contract them into FMA and the result equals the plain
// torch version (ops/kernels/resample_unit.py resample_unit_ref) bit for
// bit.

#include <cuda_runtime.h>
#include <climits>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
resample_unit_kernel(const float* __restrict__ pool, long long pool_len,
                     const int* __restrict__ meta,
                     const float* __restrict__ weights,
                     float* __restrict__ out, int W, int taps, int tiles) {
  const int v = blockIdx.x / tiles;
  const int t = (blockIdx.x - v * tiles) * kThreads + threadIdx.x;
  if (t >= W) return;

  // meta row: src_off, src_len, loop_start, loop_end, has_loop,
  // has_wrapped, pos_int, (unused)
  const int* m = meta + 8LL * v;
  const int off = m[0];
  const int len = m[1];
  const int ls = m[2];
  const int le = m[3];
  const bool has_loop = m[4] != 0;
  const bool has_wrapped = m[5] != 0;
  const int p0 = m[6];
  const int loop_len = max(le - ls, 1);
  const int last = max(len - 1, 0);
  const int center = taps / 2 - 1;
  const float* w = weights + static_cast<long long>(v) * taps;

  float acc = 0.0f;
  for (int j = 0; j < taps; ++j) {
    const int s = p0 + t + j - center;
    int idx;
    if (has_loop) {
      idx = s;
      if (s >= le || (has_wrapped && s < ls)) {
        int r = (s - ls) % loop_len;  // C truncates toward zero:
        if (r < 0) r += loop_len;     // make it non-negative like jnp.mod
        idx = r + ls;
      }
    } else {
      idx = min(s, last);
    }
    float val = 0.0f;
    if (s >= 0 && len > 0) {
      long long a = static_cast<long long>(off) + idx;
      a = a < 0 ? 0 : (a >= pool_len ? pool_len - 1 : a);
      val = pool[a];
    }
    acc = __fadd_rn(acc, __fmul_rn(__ldg(w + j), val));
  }
  out[static_cast<long long>(v) * W + t] = acc;
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 on success).
extern "C" int resample_unit_launch(const float* pool, long long pool_len,
                                    const int* meta, const float* weights,
                                    float* out, int V, int W, int taps,
                                    void* stream) {
  if (V <= 0 || W <= 0 || taps <= 0 || pool_len <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int tiles = (W + kThreads - 1) / kThreads;
  const long long blocks = static_cast<long long>(V) * tiles;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  resample_unit_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      pool, pool_len, meta, weights, out, W, taps, tiles);
  return static_cast<int>(cudaGetLastError());
}
