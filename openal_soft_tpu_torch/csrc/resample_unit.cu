// Unit-increment (native-rate) voice resampler for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernels of openal_soft_tpu/ops/pallas/resample_unit.py:
// `_kernel_shared` (all voices read one VMEM image of the active pool
// regions, staged by grid program 0) and `_kernel` (one span DMA per voice
// when the pool is too large to stage).  Here both are this one kernel.
//
//   out[v, t] = sum_{j < taps} w[v, j] * src_v(resolve(pos_int[v] + t + j - center))
//
// resolve() is ops/resample.resolve_source_index: a looping voice wraps
// forward past loop_end and, once it has wrapped, backward below
// loop_start (non-negative modulo); a non-looping voice clamps to its last
// frame; s < 0 or src_len == 0 reads silence.  Pool reads clamp to
// [0, pool_len - 1] like jnp.take(mode="clip").  Any loop length and any
// number of seams in a window is exact (the TPU kernels' single-seam
// window condition does not exist here).
//
// What bounds it: the output writes, V*W floats (268 MB at best_case's
// V = 4096, W = 16384: 0.080 ms at 3.35 TB/s).  The pool (9.2 MB there)
// stays in the 50 MB L2, but each block reads its voice's window from it,
// so L2 carries the output's bytes twice (frames in, outputs out); a tap
// is one multiply and one add, so the arithmetic (~0.5 GFLOP at taps = 4)
// is far below the card's rate, as long as no tap resolves its frame or
// reads global memory on its own.
//
// Design: the staged windows of csrc/resample_window.cuh (K3, K4, K5) at
// increment 1<<16 and phase 0, with one weight row per voice instead of
// phase tables.  A block owns one voice's tile of up to kTile = 8192
// outputs, cut into windows of equal length, at most kWindow outputs each.
// For each window it stages the resolved frames pos_int + t - center ..
// + n + taps - 2 (rsw::plan_window, rsw::stage_window: run A from
// resolve(s0), then the loop frame by frame or the end clamp, silence as 0,
// 16-byte cp.async where aligned), waits, and computes the window's
// outputs: lanes take consecutive outputs (no bank conflict, every warp's
// store one 128-byte line), and a tap is one shared load, one multiply
// and one add.  The voice's taps weights sit in registers, unrolled for the
// tiers' tap counts (1, 2, 4, 12, 24, 48); any other count reads them from
// shared memory.  Up to 12 taps the registers are held to 32 a thread, so
// eight blocks of 256 stay resident per SM (a window takes 16 KB): while
// one block waits for its window, the others' copies are in flight or
// they compute.  24 and 48 taps keep their weights in 64 and 80 registers
// (four and three blocks per SM).
//
// Exactness: the products and sums are rounded one by one
// (__fmul_rn/__fadd_rn, taps in order j = 0..taps-1, starting from 0.0f),
// and each staged frame is the value the plain version gathers, so the
// result equals the plain torch version (ops/kernels/resample_unit.py
// resample_unit_ref) bit for bit.

#include "resample_window.cuh"

namespace {

constexpr int kMetaUnit = 8;
// Outputs a window covers at most; its buffer holds kWindow + taps - 1
// frames (16.4 KB at taps 4), below the 48 KB that needs no opt-in, and
// eight blocks fit an SM.
constexpr int kWindow = 4096;

// Resident blocks per SM the register budget must allow: the weights of
// 24 and 48 taps need 64 and 80 registers.
constexpr int min_blocks(int taps) {
  return taps >= 48 ? 3 : (taps >= 24 ? 4 : rsw::kMinBlocks);
}

// meta row: src_off, src_len, loop_start, loop_end, has_loop, has_wrapped,
// pos_int, (unused); at unit increment every output advances one frame
// from pos_int, whatever the phase.
__device__ __forceinline__ rsw::Voice unit_voice(const int* __restrict__ meta,
                                                 int v) {
  const int* m = meta + static_cast<long long>(kMetaUnit) * v;
  rsw::Voice p;
  p.off = m[0];
  p.len = m[1];
  p.ls = m[2];
  p.le = m[3];
  p.has_loop = m[4] != 0;
  p.has_wrapped = m[5] != 0;
  p.pos_int = m[6];
  p.frac0 = 0;
  p.inc = 1 << 16;
  p.row = 0;
  p.sf = 0.0f;
  p.loop_len = max(p.le - p.ls, 1);
  p.last = max(p.len - 1, 0);
  return p;
}

// Outputs [t, t + n) from the staged window x (x[k + j] is output t + k's
// tap j) and the weights w (registers, or shared memory for kTaps == 0),
// into out_row.
template <int kTaps>
__device__ __forceinline__ void compute_unit(const float* x, const float* w,
                                             int taps, long long t, int n,
                                             float* __restrict__ out_row) {
  const int nt = kTaps > 0 ? kTaps : taps;
  for (int k = threadIdx.x; k < n; k += rsw::kThreads) {
    const float* xk = x + k;
    float acc = 0.0f;
#pragma unroll
    for (int j = 0; j < nt; ++j) {
      acc = __fadd_rn(acc, __fmul_rn(w[j], xk[j]));
    }
    out_row[t + k] = acc;
  }
}

// One block per (voice, tile of `tile` outputs).  Shared memory: for
// kTaps == 0 the weight row (taps floats, rounded up to 16 bytes), then the
// window buffer.
template <int kTaps>
__global__ void __launch_bounds__(rsw::kThreads, min_blocks(kTaps))
unit_kernel(const float* __restrict__ pool, long long pool_len,
            const int* __restrict__ meta, const float* __restrict__ weights,
            float* __restrict__ out, int W, int taps, int tile, int tiles,
            int vec) {
  extern __shared__ __align__(16) float smem[];
  const int nt = kTaps > 0 ? kTaps : taps;
  const int v = blockIdx.x / tiles;
  const long long t0 = static_cast<long long>(blockIdx.x - v * tiles) * tile;
  const int n_tile = static_cast<int>(min(static_cast<long long>(tile),
                                          W - t0));
  const rsw::Voice p = unit_voice(meta, v);
  const int center = nt / 2 - 1;
  const float* wrow = weights + static_cast<long long>(v) * nt;
  float* buf = smem + (kTaps > 0 ? 0 : (nt + 3) & ~3);
  float wreg[kTaps > 0 ? kTaps : 1];
  const float* w = wreg;
  if constexpr (kTaps > 0) {
#pragma unroll
    for (int j = 0; j < kTaps; ++j) wreg[j] = __ldg(wrow + j);
  } else {
    // visible after the first barrier
    for (int j = threadIdx.x; j < nt; j += rsw::kThreads) smem[j] = wrow[j];
    w = smem;
  }
  const int nwin = (n_tile + kWindow - 1) / kWindow;
  const int n_w = (n_tile + nwin - 1) / nwin;
  float* out_row = out + static_cast<long long>(v) * W;

  for (int i = 0; i < nwin; ++i) {
    const long long t = t0 + static_cast<long long>(i) * n_w;
    const int n = min(n_w, n_tile - i * n_w);
    const rsw::Window win = rsw::plan_window(p, center, nt, t, n);
    if (i > 0) __syncthreads();   // every thread is done with the buffer
    rsw::stage_window(buf, pool, pool_len, p, win, vec != 0);
    rsw::wait_copies();
    __syncthreads();
    compute_unit<kTaps>(buf + win.sh, w, nt, t, n, out_row);
  }
}

template <int kTaps>
int launch_unit(const float* pool, long long pool_len, const int* meta,
                const float* weights, float* out, int V, int W, int taps,
                cudaStream_t stream) {
  const int tile = rsw::tile_for(W);
  const int tiles = (W + tile - 1) / tile;
  const long long blocks = static_cast<long long>(V) * tiles;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem =
      sizeof(float) * ((kTaps > 0 ? 0 : (taps + 3) & ~3)
                       + rsw::buffer_floats(kWindow + taps - 1));
  const int vec = (reinterpret_cast<uintptr_t>(pool) & 15) == 0;
  unit_kernel<kTaps><<<static_cast<unsigned>(blocks), rsw::kThreads, smem,
                       stream>>>(pool, pool_len, meta, weights, out, W, taps,
                                 tile, tiles, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 on success).
// meta [V, 8] i32, weights [V, taps] f32, out [V, W] f32.
extern "C" int resample_unit_launch(const float* pool, long long pool_len,
                                    const int* meta, const float* weights,
                                    float* out, int V, int W, int taps,
                                    void* stream) {
  if (V <= 0 || W <= 0 || taps <= 0 || pool_len <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (taps) {
    case 1: return launch_unit<1>(pool, pool_len, meta, weights, out, V, W,
                                  taps, s);
    case 2: return launch_unit<2>(pool, pool_len, meta, weights, out, V, W,
                                  taps, s);
    case 4: return launch_unit<4>(pool, pool_len, meta, weights, out, V, W,
                                  taps, s);
    case 12: return launch_unit<12>(pool, pool_len, meta, weights, out, V,
                                    W, taps, s);
    case 24: return launch_unit<24>(pool, pool_len, meta, weights, out, V,
                                    W, taps, s);
    case 48: return launch_unit<48>(pool, pool_len, meta, weights, out, V,
                                    W, taps, s);
    default: return launch_unit<0>(pool, pool_len, meta, weights, out, V, W,
                                   taps, s);
  }
}
