// General-pitch voice resampler for sample pools larger than L2, for NVIDIA
// Hopper (sm_90a).
//
// Replaces the TPU kernel openal_soft_tpu/ops/pallas/resample2.py `_kernel`
// (reached through `_resample2` when the active voices' buffers do not fit
// the shared VMEM image: two span DMAs per voice from HBM, then per-row
// windows assembled in VMEM with one loop seam per row).  It computes
// ops/resample.py `resample_voices` at any increment, for every tier, as
// csrc/resample_gen.cu does:
//
//   total = pos_frac + t*inc (64-bit),  pos = pos_int + (total >> 16)
//   phase = (total & 0xffff) >> 11,  pf = (total & 2047) / 2048
//   w_j   = (fil + sf*scd) + pf*(phd + sf*spd)   rows [bank_row, phase, j]
//   out[v, t] = sum_{j < taps} w_j * src_v(resolve(pos + j - center))
//
// What bounds it: the bytes.  Each voice's source window is read once and
// the output written once: at the full-width UHJ scene's V = 4096,
// W = 16512 and pitch 2**U(-1,1) about 0.1 GB of windows and 0.27 GB of
// output.  The pool (~1 GB there) is 19x the 50 MB L2, so unlike K3, which
// reads every tap from global memory and relies on L2 to absorb the taps'
// overlap, this kernel reads each source frame from device memory once
// per tile.
//
// Design: one block per (voice, tile of 1024 outputs).  From the voice's
// scalars the block works out the tile's source window, frames
// s0 = pos(t0) - center .. pos(t1) + taps - 1 - center, and stages the
// resolved value of every frame of it in dynamic shared memory:
//
//   win[d] = pool[clamp(off + resolve(s0 + d))],   d < span
//
// with the address clamp of csrc/resample_gen.cu, so each staged value is
// the one K3 would have read.  Resolved frames are contiguous runs: a
// looping voice's run A starts at the resolved base of the tile and ends
// at loop_end, and run B starts at loop_start (repeated when the loop is
// shorter than the window, which the device's plan avoids but the kernel
// still gets right); a non-looping voice's run ends at its last frame,
// which fills the rest of the window.  Runs are copied with 16-byte
// loads for their aligned interior.  Then each thread computes outputs
// t0 + tid, t0 + tid + 256, ... reading every tap from shared memory; the
// per-tap validity (silence before frame 0 and for empty sources) and the
// arithmetic are K3's, in the same order.
//
// Exactness: products and sums are rounded one by one (__fmul_rn,
// __fadd_rn) in the plain version's order, taps j = 0..taps-1 from 0.0f,
// so the kernel equals the plain torch version bit for bit.

#include <cuda_runtime.h>
#include <climits>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 1024;   // outputs per block
constexpr int kMeta = 12;
constexpr int kPhases = 32;
constexpr int kRows = 52;

__device__ __forceinline__ float pool_at(const float* __restrict__ pool,
                                         long long pool_len, long long a) {
  a = a < 0 ? 0 : (a >= pool_len ? pool_len - 1 : a);
  return pool[a];
}

// dst[i] = pool[clamp(g0 + i)] for i < n, by the whole block: float4 loads
// over the aligned part that lies inside the pool, single loads around it.
__device__ void stage_run(float* dst, const float* __restrict__ pool,
                          long long pool_len, long long g0, int n) {
  if (n <= 0) return;
  const long long lo = g0 > 0 ? g0 : 0;
  const long long hi = g0 + n < pool_len ? g0 + n : pool_len;
  long long a0 = (lo + 3) & ~3LL;
  long long a1 = hi & ~3LL;
  if (a1 <= a0) a0 = a1 = g0 + n;   // no aligned interior: all single loads
  const float4* p4 = reinterpret_cast<const float4*>(pool);
  for (long long q = a0 / 4 + threadIdx.x; q < a1 / 4; q += kThreads) {
    const float4 v = __ldg(p4 + q);
    float* d = dst + (q * 4 - g0);
    d[0] = v.x;
    d[1] = v.y;
    d[2] = v.z;
    d[3] = v.w;
  }
  const int head = static_cast<int>(a0 - g0);
  for (int i = threadIdx.x; i < head; i += kThreads) {
    dst[i] = pool_at(pool, pool_len, g0 + i);
  }
  for (int i = static_cast<int>(a1 - g0) + threadIdx.x; i < n;
       i += kThreads) {
    dst[i] = pool_at(pool, pool_len, g0 + i);
  }
}

__global__ void __launch_bounds__(kThreads)
resample_span_kernel(const float* __restrict__ pool, long long pool_len,
                     const int* __restrict__ meta, const float* __restrict__ sf,
                     const float* __restrict__ bank, float* __restrict__ out,
                     int W, int taps, int tiles, int cap) {
  extern __shared__ float win[];
  const int v = blockIdx.x / tiles;
  const int t0 = (blockIdx.x - v * tiles) * kTile;
  const int n_out = min(kTile, W - t0);

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

  // The tile's window: frames s0 .. s0 + span - 1.
  const int p0 = pos_int + static_cast<int>((frac0 + t0 * inc) >> 16);
  const int p1 =
      pos_int + static_cast<int>((frac0 + (t0 + n_out - 1) * inc) >> 16);
  const int s0 = p0 - center;
  const int span = p1 - p0 + taps;
  if (span > cap) __trap();   // the wrapper sized `cap` for every voice

  if (has_loop) {
    int a = s0;
    if (s0 >= le || (has_wrapped && s0 < ls)) {
      int r = (s0 - ls) % loop_len;   // C truncates toward zero:
      if (r < 0) r += loop_len;       // make it non-negative like jnp.mod
      a = r + ls;
    }
    const int n1 = min(span, le - a);   // a < le: run A up to loop_end
    stage_run(win, pool, pool_len, off + a, n1);
    for (int d = n1; d < span; d += loop_len) {   // run B from loop_start
      stage_run(win + d, pool, pool_len, off + ls, min(loop_len, span - d));
    }
  } else {
    const int n1 = s0 <= last ? min(span, last - s0 + 1) : 0;
    stage_run(win, pool, pool_len, off + s0, n1);
    if (n1 < span) {   // past the last frame: the end clamp
      const float c = pool_at(pool, pool_len, off + last);
      for (int d = n1 + threadIdx.x; d < span; d += kThreads) win[d] = c;
    }
  }
  __syncthreads();

  const float s = sf[v];
  const long long plane = static_cast<long long>(kRows) * kPhases * taps;
  const bool audible = len > 0;
  for (int k = threadIdx.x; k < n_out; k += kThreads) {
    const int t = t0 + k;
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
    const float* w_src = win + (pos - p0);
    float acc = 0.0f;
    for (int j = 0; j < taps; ++j) {
      const float w0 = __fadd_rn(__ldg(fil + j), __fmul_rn(s, __ldg(scd + j)));
      const float wd = __fadd_rn(__ldg(phd + j), __fmul_rn(s, __ldg(spd + j)));
      const float w = __fadd_rn(w0, __fmul_rn(pf, wd));
      const float val = (audible && pos + j - center >= 0) ? w_src[j] : 0.0f;
      acc = __fadd_rn(acc, __fmul_rn(w, val));
    }
    out[static_cast<long long>(v) * W + t] = acc;
  }
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 on success), or the
// error of raising the kernel's dynamic shared memory limit to `cap`
// floats.  bank: [4 (fil, phd, scd, spd), 52, 32, taps] f32; pool 16-byte
// aligned.
extern "C" int resample_span_launch(const float* pool, long long pool_len,
                                    const int* meta, const float* sf,
                                    const float* bank, float* out, int V,
                                    int W, int taps, int cap, void* stream) {
  if (V <= 0 || W <= 0 || taps <= 0 || pool_len <= 0 || cap < taps) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int tiles = (W + kTile - 1) / kTile;
  const long long blocks = static_cast<long long>(V) * tiles;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(cap) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      resample_span_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  resample_span_kernel<<<static_cast<unsigned>(blocks), kThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      pool, pool_len, meta, sf, bank, out, W, taps, tiles, cap);
  return static_cast<int>(cudaGetLastError());
}
