// General-pitch voice resampler for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel openal_soft_tpu/ops/pallas/resample3.py `_kernel`
// (reached through `_resample3`; all voices read one VMEM image of the
// active pool regions, and the window of each output tile is assembled
// with one-hot MXU products).  Here the pool is read straight from global
// memory, as in csrc/resample_unit.cu.  It computes
// ops/resample.py `resample_voices` at any increment, for every tier:
//
//   total = pos_frac + t*inc (64-bit),  pos = pos_int + (total >> 16)
//   phase = (total & 0xffff) >> 11,  pf = (total & 2047) / 2048
//   w_j   = (fil + sf*scd) + pf*(phd + sf*spd)   rows [bank_row, phase, j]
//   out[v, t] = sum_{j < taps} w_j * src_v(resolve(pos + j - center))
//
// with the bank sliced to the taps in use (`taps` of the 48 columns).
// resolve() is ops/resample.resolve_source_index: loop wrap forward past
// loop_end and, once wrapped, backward below loop_start (non-negative
// modulo); end clamp without a loop; silence before frame 0 and for empty
// sources; pool reads clamp to [0, pool_len - 1].  Every tap resolves on
// its own, so any loop length is exact: the TPU kernel's single-seam
// condition (loop_len >= window span) does not exist here.
//
// What bounds it: the output writes, V*W floats (268 MB at the main path's
// V = 4096, W = 16384: ~0.080 ms at 3.35 TB/s).  The arithmetic, about
// 10 operations per tap, is ~1 GFLOP at taps = 4.  Neighbouring threads
// read neighbouring source frames of one voice, so pool reads coalesce and
// hit L2 (the loaded scene's pool is 9.2 MB of the 50 MB L2); the weight
// rows come from a 26 KB bank slice.  Design: one thread per output
// sample, a block covers 256 consecutive samples of one voice (its scalars
// load once, broadcast from cache), the voice axis folded into blockIdx.x.
//
// Exactness: products and sums are rounded one by one (__fmul_rn,
// __fadd_rn) in the plain version's order, taps j = 0..taps-1 from 0.0f, so
// the kernel equals the plain torch version bit for bit.

#include <cuda_runtime.h>
#include <climits>

namespace {

constexpr int kThreads = 256;
constexpr int kMeta = 12;
constexpr int kPhases = 32;
constexpr int kRows = 52;

__global__ void __launch_bounds__(kThreads)
resample_gen_kernel(const float* __restrict__ pool, long long pool_len,
                    const int* __restrict__ meta, const float* __restrict__ sf,
                    const float* __restrict__ bank, float* __restrict__ out,
                    int W, int taps, int tiles) {
  const int v = blockIdx.x / tiles;
  const int t = (blockIdx.x - v * tiles) * kThreads + threadIdx.x;
  if (t >= W) return;

  // meta row: src_off, src_len, loop_start, loop_end, has_loop,
  // has_wrapped, pos_int, pos_frac, increment, bank_row, (unused) x2
  const int* m = meta + static_cast<long long>(kMeta) * v;
  const int off = m[0];
  const int len = m[1];
  const int ls = m[2];
  const int le = m[3];
  const bool has_loop = m[4] != 0;
  const bool has_wrapped = m[5] != 0;
  const long long total = m[7] + static_cast<long long>(t) * m[8];
  const int pos = m[6] + static_cast<int>(total >> 16);
  const int fr = static_cast<int>(total & 0xFFFF);
  const float pf = __fmul_rn(static_cast<float>(fr & 2047), 1.0f / 2048.0f);
  const float s = sf[v];
  const long long plane = static_cast<long long>(kRows) * kPhases * taps;
  const float* fil = bank + (static_cast<long long>(m[9]) * kPhases
                             + (fr >> 11)) * taps;
  const float* phd = fil + plane;
  const float* scd = fil + 2 * plane;
  const float* spd = fil + 3 * plane;
  const int loop_len = max(le - ls, 1);
  const int last = max(len - 1, 0);
  const int center = taps / 2 - 1;

  float acc = 0.0f;
  for (int j = 0; j < taps; ++j) {
    const float w0 = __fadd_rn(__ldg(fil + j), __fmul_rn(s, __ldg(scd + j)));
    const float wd = __fadd_rn(__ldg(phd + j), __fmul_rn(s, __ldg(spd + j)));
    const float w = __fadd_rn(w0, __fmul_rn(pf, wd));
    const int si = pos + j - center;
    int idx;
    if (has_loop) {
      idx = si;
      if (si >= le || (has_wrapped && si < ls)) {
        int r = (si - ls) % loop_len;  // C truncates toward zero:
        if (r < 0) r += loop_len;      // make it non-negative like jnp.mod
        idx = r + ls;
      }
    } else {
      idx = min(si, last);
    }
    float val = 0.0f;
    if (si >= 0 && len > 0) {
      long long a = static_cast<long long>(off) + idx;
      a = a < 0 ? 0 : (a >= pool_len ? pool_len - 1 : a);
      val = pool[a];
    }
    acc = __fadd_rn(acc, __fmul_rn(w, val));
  }
  out[static_cast<long long>(v) * W + t] = acc;
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 on success).
// bank: [4 (fil, phd, scd, spd), 52, 32, taps] f32.
extern "C" int resample_gen_launch(const float* pool, long long pool_len,
                                   const int* meta, const float* sf,
                                   const float* bank, float* out, int V, int W,
                                   int taps, void* stream) {
  if (V <= 0 || W <= 0 || taps <= 0 || pool_len <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int tiles = (W + kThreads - 1) / kThreads;
  const long long blocks = static_cast<long long>(V) * tiles;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  resample_gen_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      pool, pool_len, meta, sf, bank, out, W, taps, tiles);
  return static_cast<int>(cudaGetLastError());
}
