// The staged-window general-pitch resampler shared by csrc/resample_gen.cu
// (K3), csrc/resample_span.cu (K4) and csrc/resample_voice.cu (K5), for
// NVIDIA Hopper (sm_90a); csrc/resample_unit.cu (K1) stages its windows
// with the same plan_window and stage_window.
//
// K3, K4 and K5 compute ops/resample.py `resample_voices` at any
// increment, for every tier:
//
//   total = pos_frac + t*inc (64-bit),  pos = pos_int + (total >> 16)
//   phase = (total & 0xffff) >> 11,  pf = (total & 2047) / 2048
//   W0 = fil + sf*scd,  WD = phd + sf*spd   (rows [bank_row, phase, j])
//   out[v, t] = sum_{j < taps} (W0 + pf*WD)[phase, j]
//                              * src_v(resolve(pos + j - center))
//
// with the bank sliced to the `taps` columns in use.  resolve() is
// ops/resample.resolve_source_index: loop wrap forward past loop_end and,
// once wrapped, backward below loop_start; end clamp without a loop;
// silence before frame 0 and for empty sources; pool reads clamp to
// [0, pool_len - 1].
//
// A block owns one voice's tile of outputs (K3, K4: at most kTile = 8192,
// the tiles of a row of equal length; K5: the whole row) and stages in
// shared memory:
//
// 1. The voice's weight tables W0 and WD for all 32 phases x taps, once,
//    in the plain version's roundings (ops/resample.py voice_weights), laid
//    out phase-minor ([j][32]): lanes on different phases read different
//    banks and lanes on the same phase the same word.  A tap then costs two
//    shared loads, where computing the weight from the bank took four
//    gathers and four operations per output.
// 2. Source windows.  The tile is cut into windows of equal length, each
//    the most outputs whose frames s0 = pos(t) - center ..
//    pos(t + n - 1) + taps - 1 - center fit the `cap` frames the wrapper
//    sized for the largest increment (so one window per 1024 outputs at
//    that increment, and more, shorter windows for a larger one: every
//    increment is exact).  Frame d of a window holds
//
//      win[d] = (s0 + d >= 0 || wrapped) && src_len > 0
//               ? pool[clamp(off + idx(d))] : 0
//
//    (wrapped: a looping voice that has wrapped; its frames before
//    loop_start are the loop's last ones, even at loop_start 0)
//
//    where, with a = resolve(s0) and n1 the frames of the run that starts
//    there (up to loop_end, or to the last frame without a loop),
//    idx(d) = a + d for d < n1, and past it loop_start + (d - n1) mod
//    loop_len for a looping voice (the loop's runs, resolved frame by frame
//    so that a loop shorter than the window is exact) or the last frame
//    without a loop (the end clamp).  Silence is staged as 0, so no tap
//    tests validity.  Run frames whose 16 bytes are aligned and inside the
//    pool are copied with 16-byte cp.async (the window sits in its buffer
//    at the run's alignment); the rest one frame at a time, zero-filled
//    where silent.
//
// Then each thread computes the window's outputs t + tid, t + tid + 256,
// ..., stepping the 64-bit position by 256*inc (exact integer adds, the
// same as pos_frac + t*inc), and per tap reads W0, WD and the frame from
// shared memory.  Lanes take consecutive outputs, so their frames are at
// most ceil(pitch) words apart (no bank conflict up to 1x, two-way up to
// 2x) and every warp's store is one 128-byte line.
//
// A block stages a window, waits for its copies and computes it.
// Registers are held to 32 a thread (__launch_bounds__ with kMinBlocks =
// 8), so eight blocks of 256 threads stay resident per SM: while one block
// waits for its window, the copies of others are in flight or they
// compute.  Large tiles stage the weights once for up to 8192 outputs.
// (A double-buffered block, issuing window k+1's copies before computing
// window k, measured 2-8 % slower at the same occupancy: PERF.md.)
//
// Exactness: products and sums are rounded one by one (__fmul_rn,
// __fadd_rn) in the plain version's order, taps j = 0..taps-1 from 0.0f,
// and each staged value is the one the plain version gathers, so the
// three kernels equal the plain torch version bit for bit.

#pragma once

#include <cuda_runtime.h>
#include <climits>
#include <cstdint>

namespace rsw {

constexpr int kThreads = 256;
// Resident blocks per SM the register budget must allow (32 registers a
// thread): eight blocks of 256 fill the SM's 2048 threads, so the copies of
// some blocks are in flight while the others compute.
constexpr int kMinBlocks = 8;
constexpr int kTile = 8192;   // outputs per block, at most
constexpr int kMeta = 12;
constexpr int kPhases = 32;
constexpr int kRows = 52;

// One voice's scalars from its meta row: src_off, src_len, loop_start,
// loop_end, has_loop, has_wrapped, pos_int, pos_frac, increment, bank_row,
// (unused) x2.
struct Voice {
  long long off, frac0, inc;
  int len, ls, le, loop_len, last, pos_int, row;
  bool has_loop, has_wrapped;
  float sf;
};

__device__ __forceinline__ Voice load_voice(const int* __restrict__ meta,
                                            const float* __restrict__ sf,
                                            int v) {
  const int* m = meta + static_cast<long long>(kMeta) * v;
  Voice p;
  p.off = m[0];
  p.len = m[1];
  p.ls = m[2];
  p.le = m[3];
  p.has_loop = m[4] != 0;
  p.has_wrapped = m[5] != 0;
  p.pos_int = m[6];
  p.frac0 = m[7];
  p.inc = m[8];
  p.row = m[9];
  p.sf = sf[v];
  p.loop_len = max(p.le - p.ls, 1);
  p.last = max(p.len - 1, 0);
  return p;
}

// w0[j*32 + ph] = fil + sf*scd, wd[j*32 + ph] = phd + sf*spd for the voice's
// bank row; reads of the [32][taps] rows coalesce.
__device__ __forceinline__ void stage_weights(float* w0, float* wd,
                                              const float* __restrict__ bank,
                                              const Voice& p, int taps) {
  const long long plane = static_cast<long long>(kRows) * kPhases * taps;
  const float* fil = bank + static_cast<long long>(p.row) * kPhases * taps;
  for (int i = threadIdx.x; i < kPhases * taps; i += kThreads) {
    const int ph = i / taps;
    const int j = i - ph * taps;
    const float f = __ldg(fil + i);
    const float pd = __ldg(fil + plane + i);
    const float sc = __ldg(fil + 2 * plane + i);
    const float sp = __ldg(fil + 3 * plane + i);
    w0[j * kPhases + ph] = __fadd_rn(f, __fmul_rn(p.sf, sc));
    wd[j * kPhases + ph] = __fadd_rn(pd, __fmul_rn(p.sf, sp));
  }
}

// The source window of outputs [t, t + n).
struct Window {
  long long base;   // (pos_frac + t*inc) >> 16: pos(t) - pos_int
  long long g;      // pool address of frame a (run A's first frame)
  int s0;           // first frame: pos(t) - center
  int span;         // frames: pos(t + n - 1) - pos(t) + taps
  int a;            // resolve(s0)
  int n1;           // frames of run A, in [0, span]
  int sh;           // g mod 4: where frame 0 sits in its buffer
};

__device__ __forceinline__ Window plan_window(const Voice& p, int center,
                                              int taps, long long t, int n) {
  Window w;
  w.base = (p.frac0 + t * p.inc) >> 16;
  const long long b1 = (p.frac0 + (t + n - 1) * p.inc) >> 16;
  w.s0 = p.pos_int + static_cast<int>(w.base) - center;
  w.span = static_cast<int>(b1 - w.base) + taps;
  int a = w.s0;
  long long n1;
  if (p.has_loop) {
    if (w.s0 >= p.le || (p.has_wrapped && w.s0 < p.ls)) {
      int r = (w.s0 - p.ls) % p.loop_len;   // C truncates toward zero:
      if (r < 0) r += p.loop_len;           // make it non-negative like jnp.mod
      a = r + p.ls;
    }
    n1 = static_cast<long long>(p.le) - a;
  } else {
    n1 = static_cast<long long>(p.last) - w.s0 + 1;
  }
  w.a = a;
  w.n1 = static_cast<int>(n1 < 0 ? 0 : (n1 > w.span ? w.span : n1));
  w.g = p.off + a;
  w.sh = static_cast<int>(w.g & 3);
  return w;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 4 bytes, or 4 zero bytes when !fill.
__device__ __forceinline__ void copy4(float* dst, const float* src,
                                      bool fill) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;"
               :: "r"(smem_addr(dst)), "l"(src), "r"(fill ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void copy16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;"
               :: "r"(smem_addr(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

__device__ __forceinline__ void wait_copies() {
  asm volatile("cp.async.wait_group 0;" ::: "memory");
}

// Issue (and commit as one group) the copies of window w into buf: frame d
// lands at buf[w.sh + d].  `vec`: the pool is 16-byte aligned.
__device__ __forceinline__ void stage_window(float* buf,
                                             const float* __restrict__ pool,
                                             long long pool_len,
                                             const Voice& p, const Window& w,
                                             bool vec) {
  const int end = w.sh + w.span;
  const bool audible = p.len > 0;
  const bool wrapped = p.has_loop && p.has_wrapped;
  for (int q = threadIdx.x; 4 * q < end; q += kThreads) {
    const int d0 = 4 * q - w.sh;
    const long long g0 = w.g + d0;   // a multiple of 4
    if (vec && audible && d0 >= 0 && d0 + 4 <= w.n1 && w.s0 + d0 >= 0
        && g0 >= 0 && g0 + 4 <= pool_len) {
      copy16(buf + 4 * q, pool + g0);
      continue;
    }
    for (int k = 0; k < 4; ++k) {
      const int d = d0 + k;
      if (d < 0 || d >= w.span) continue;
      int idx;
      if (d < w.n1) {
        idx = w.a + d;
      } else if (p.has_loop) {
        const int e = d - w.n1;
        idx = p.ls + (e < p.loop_len ? e : e % p.loop_len);
      } else {
        idx = p.last;
      }
      long long ad = p.off + idx;
      ad = ad < 0 ? 0 : (ad >= pool_len ? pool_len - 1 : ad);
      copy4(buf + 4 * q + k, pool + ad,
            audible && (w.s0 + d >= 0 || wrapped));
    }
  }
  commit();
}

// Outputs [t, t + n) of the voice from its staged window (win = frame 0)
// and weight tables, into out_row.
template <int kTaps>
__device__ __forceinline__ void compute_window(
    const float* win, const float* w0, const float* wd, const Voice& p,
    const Window& w, long long t, int n, int taps,
    float* __restrict__ out_row) {
  const int nt = kTaps > 0 ? kTaps : taps;
  const long long step = static_cast<long long>(kThreads) * p.inc;
  long long total = p.frac0 + (t + threadIdx.x) * p.inc;
  for (int k = threadIdx.x; k < n; k += kThreads, total += step) {
    const int rel = static_cast<int>((total >> 16) - w.base);
    const int fr = static_cast<int>(total & 0xFFFF);
    const float pf =
        __fmul_rn(static_cast<float>(fr & 2047), 1.0f / 2048.0f);
    const float* x = win + rel;
    const float* a0 = w0 + (fr >> 11);
    const float* ad = wd + (fr >> 11);
    float acc = 0.0f;
#pragma unroll
    for (int j = 0; j < nt; ++j) {
      const float wj =
          __fadd_rn(a0[j * kPhases], __fmul_rn(pf, ad[j * kPhases]));
      acc = __fadd_rn(acc, __fmul_rn(wj, x[j]));
    }
    out_row[t + k] = acc;
  }
}

// One block per (voice, tile of `tile` outputs).  Shared memory: w0, wd
// (32*taps floats each), then the window buffer of buf_floats >= cap + 3.
template <int kTaps>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
window_kernel(const float* __restrict__ pool, long long pool_len,
              const int* __restrict__ meta, const float* __restrict__ sf,
              const float* __restrict__ bank, float* __restrict__ out, int W,
              int taps, int tile, int tiles, int cap, int vec) {
  extern __shared__ __align__(16) float smem[];
  const int nt = kTaps > 0 ? kTaps : taps;
  float* w0 = smem;
  float* wd = smem + kPhases * nt;
  float* buf = smem + 2 * kPhases * nt;
  const int v = blockIdx.x / tiles;
  const long long t0 = static_cast<long long>(blockIdx.x - v * tiles) * tile;
  const int n_tile = static_cast<int>(min(static_cast<long long>(tile),
                                          W - t0));
  const Voice p = load_voice(meta, sf, v);
  const int center = nt / 2 - 1;
  // The most outputs whose window fits cap frames:
  // (((n-1)*inc + 65535) >> 16) + taps + 1 <= cap.
  const long long fit =
      p.inc > 0 ? ((static_cast<long long>(cap - nt - 1) << 16) / p.inc + 1)
                : n_tile;
  const int nwin = static_cast<int>((n_tile + fit - 1) / fit);
  const int n_w = (n_tile + nwin - 1) / nwin;
  float* out_row = out + static_cast<long long>(v) * W;

  stage_weights(w0, wd, bank, p, nt);   // visible after the first barrier
  for (int i = 0; i < nwin; ++i) {
    const long long t = t0 + static_cast<long long>(i) * n_w;
    const int n = min(n_w, n_tile - i * n_w);
    const Window w = plan_window(p, center, nt, t, n);
    if (i > 0) __syncthreads();   // every thread is done with the buffer
    stage_window(buf, pool, pool_len, p, w, vec != 0);
    wait_copies();
    __syncthreads();
    compute_window<kTaps>(buf + w.sh, w0, wd, p, w, t, n, nt, out_row);
  }
}

// Shared-memory floats of one window buffer: frame 0 sits at an offset of
// up to 3, rounded up to 16 bytes.
inline int buffer_floats(int cap) { return (cap + 3 + 3) & ~3; }

template <int kTaps>
int launch_taps(const float* pool, long long pool_len, const int* meta,
                const float* sf, const float* bank, float* out, int V, int W,
                int taps, int cap, int tile, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (2 * kPhases * static_cast<size_t>(taps)
                                       + buffer_floats(cap));
  const int tiles = (W + tile - 1) / tile;
  const long long blocks = static_cast<long long>(V) * tiles;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  auto* kern = window_kernel<kTaps>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int vec = (reinterpret_cast<uintptr_t>(pool) & 15) == 0;
  kern<<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
      pool, pool_len, meta, sf, bank, out, W, taps, tile, tiles, cap, vec);
  return static_cast<int>(cudaGetLastError());
}

// Launch on `stream` with the taps unrolled for the tiers' tap counts;
// returns a CUDA error code (0 on success).  cap: frames of the window
// buffer, at least taps + 1; tile: outputs per block (K3, K4: tile_for(W);
// K5: W, one block per voice).
inline int launch_tiles(const float* pool, long long pool_len,
                        const int* meta, const float* sf, const float* bank,
                        float* out, int V, int W, int taps, int cap, int tile,
                        void* stream) {
  if (V <= 0 || W <= 0 || taps <= 0 || pool_len <= 0 || cap < taps + 1
      || tile <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (taps) {
    case 1: return launch_taps<1>(pool, pool_len, meta, sf, bank, out, V, W,
                                  taps, cap, tile, s);
    case 2: return launch_taps<2>(pool, pool_len, meta, sf, bank, out, V, W,
                                  taps, cap, tile, s);
    case 4: return launch_taps<4>(pool, pool_len, meta, sf, bank, out, V, W,
                                  taps, cap, tile, s);
    case 12: return launch_taps<12>(pool, pool_len, meta, sf, bank, out, V,
                                    W, taps, cap, tile, s);
    case 24: return launch_taps<24>(pool, pool_len, meta, sf, bank, out, V,
                                    W, taps, cap, tile, s);
    case 48: return launch_taps<48>(pool, pool_len, meta, sf, bank, out, V,
                                    W, taps, cap, tile, s);
    default: return launch_taps<0>(pool, pool_len, meta, sf, bank, out, V, W,
                                   taps, cap, tile, s);
  }
}

// A row cut into tiles of equal length, at most kTile outputs, in
// multiples of 256 (K3, K4; K1 tiles its rows the same way).
inline int tile_for(int W) {
  const int tiles = (W + kTile - 1) / kTile;
  return ((W + tiles - 1) / tiles + kThreads - 1) / kThreads * kThreads;
}

// K3 and K4: tiles of tile_for(W) outputs.
inline int launch(const float* pool, long long pool_len, const int* meta,
                  const float* sf, const float* bank, float* out, int V,
                  int W, int taps, int cap, void* stream) {
  if (W <= 0) return static_cast<int>(cudaErrorInvalidValue);
  return launch_tiles(pool, pool_len, meta, sf, bank, out, V, W, taps, cap,
                      tile_for(W), stream);
}

}  // namespace rsw
