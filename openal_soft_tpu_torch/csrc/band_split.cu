// The band splitter (BandSplitter::process, core/filters/splitter.cpp) for
// NVIDIA Hopper (sm_90a).
//
// No TPU kernel stands behind this file: the JAX package runs the splitter
// as lax.scan (openal_soft_tpu/ops/filters.py band_split,
// band_split_hf_scale, band_split_scale) or as BandSplitterKernels' chain of
// T/32 chunk steps, and the port ran that chain as a Python loop: ~75
// device operations per call (32 products, 35 sums, the einsums and the
// epilogue).  This kernel is one launch per call.  It computes, per row of
// x [D, T] from state (lp_z1, lp_z2, ap_z1), the plain versions of
// ops/filters.py, sample by sample:
//
//   d0 = (x - lp_z1)*lp;  lp_y0 = lp_z1 + d0;  lp_z1 = lp_y0 + d0
//                                    (variant_3arg: lp_z1 = lp_y0 + d0*lp)
//   d1 = (lp_y0 - lp_z2)*lp;  lp_y1 = lp_z2 + d1;  lp_z2 = lp_y1 + d1
//   ap_y = x*ap + ap_z1;  ap_z1 = x - ap_y*ap;  hp = ap_y - lp_y1
//
// with lp = ap*0.5 + 0.5, and one of three epilogues:
//
//   split     hp, lp_y1                  (band_split)
//   hf_scale  hp*hf + lp_y1              (band_split_hf_scale)
//   scale     hp*hf + lp_y1*lf           (band_split_scale)
//
// with per-row gains hf, lf read on the device (stride 0 broadcasts one
// value), and writes state' [D, 3].
//
// What bounds it: the chain.  At the speaker path's [5, 1024] the call
// moves ~60 KB (18 ns at 3.35 TB/s), but each sample of a row depends on
// the one before: the lp_z1 and lp_z2 recurrences are four dependent FP32
// operations each (sub, mul, add, add), ~16 cycles a sample, 8.3 us for
// 1024 samples at 1.98 GHz, whatever the number of rows.
//
// Design: one thread per row, one warp per block of 32 rows.  The block
// stages x through an 8-deep ring of 32-sample tiles in shared memory with
// coalesced 16-byte cp.async copies, so that seven tiles of loads are in
// flight while the chains run and a chain never waits on device memory.
// Rows are padded to 36 floats: a thread reads its row four samples at a
// time, and the 16-byte reads of eight rows fall in 32 distinct banks.  The
// outputs go out as 16-byte stores of four samples straight from
// registers.
//
// Exactness: every product, sum and difference rounds on its own
// (__fmul_rn, __fadd_rn, __fsub_rn: no FMA contraction) in the plain
// version's order, so the kernel equals the plain torch version bit for
// bit.

#include <cuda_runtime.h>

namespace {

constexpr int kRows = 32;      // rows (threads) per block
constexpr int kTile = 32;      // samples per staged tile
constexpr int kDepth = 8;      // tiles in the ring
constexpr int kRow = kTile + 4;
constexpr int kVecs = kTile / 4;

enum Mode { kSplit = 0, kHfScale = 1, kScale = 2 };

__device__ __forceinline__ float MUL(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float ADD(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float SUB(float a, float b) { return __fsub_rn(a, b); }

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;"
               :: "r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_ring() {
  asm volatile("cp.async.wait_group %0;" :: "n"(kDepth - 2) : "memory");
}

// Tile `tile` of rows [r0, r0 + nr) of x [D, T] into buf.
__device__ __forceinline__ void load_tile(float (*buf)[kRow],
                                          const float* x, int r0, int nr,
                                          int T, int tile) {
  for (int i = threadIdx.x; i < nr * kVecs; i += kRows) {
    const int r = i / kVecs, c = (i % kVecs) * 4;
    cp_async16(&buf[r][c],
               x + static_cast<long long>(r0 + r) * T + tile * kTile + c);
  }
}

struct Chain {
  float lp, ap, z1, z2, za;

  // One sample: returns hp, and the low band in lo.
  template <bool k3arg>
  __device__ __forceinline__ float step(float x, float& lo) {
    const float d0 = MUL(SUB(x, z1), lp);
    const float y0 = ADD(z1, d0);
    z1 = ADD(y0, k3arg ? MUL(d0, lp) : d0);
    const float d1 = MUL(SUB(y0, z2), lp);
    lo = ADD(z2, d1);
    z2 = ADD(lo, d1);
    const float apy = ADD(MUL(x, ap), za);
    za = SUB(x, MUL(apy, ap));
    return SUB(apy, lo);
  }
};

template <int kMode, bool k3arg>
__global__ void __launch_bounds__(kRows)
band_split_kernel(const float* __restrict__ x,
                  const float* __restrict__ st_in, float ap,
                  const float* __restrict__ hf, int hf_stride,
                  const float* __restrict__ lf, int lf_stride,
                  float* __restrict__ y0, float* __restrict__ y1,
                  float* __restrict__ st_out, int D, int T) {
  __shared__ __align__(16) float ring[kDepth][kRows][kRow];
  const int r0 = blockIdx.x * kRows;
  const int nr = min(kRows, D - r0);
  const int r = threadIdx.x;
  const bool live = r < nr;
  const int n_tiles = T / kTile;
  const long long row = static_cast<long long>(r0 + r);

  Chain ch{ADD(MUL(ap, 0.5f), 0.5f), ap, 0.0f, 0.0f, 0.0f};
  float g_hf = 1.0f, g_lf = 1.0f;
  if (live) {
    ch.z1 = st_in[3 * row];
    ch.z2 = st_in[3 * row + 1];
    ch.za = st_in[3 * row + 2];
    if (kMode != kSplit) g_hf = hf[row * hf_stride];
    if (kMode == kScale) g_lf = lf[row * lf_stride];
  }

  for (int k = 0; k < kDepth - 1; ++k) {
    if (k < n_tiles) load_tile(ring[k], x, r0, nr, T, k);
    cp_async_commit();
  }
  for (int k = 0; k < n_tiles; ++k) {
    // Tile k has landed for every thread, and every thread is done with
    // the slot that tile k + kDepth - 1 reuses.
    cp_async_wait_ring();
    __syncthreads();
    if (k + kDepth - 1 < n_tiles)
      load_tile(ring[(k + kDepth - 1) % kDepth], x, r0, nr, T,
                k + kDepth - 1);
    cp_async_commit();
    if (!live) continue;
    const float* in = ring[k % kDepth][r];
    float4* o0 = reinterpret_cast<float4*>(y0 + row * T + k * kTile);
    float4* o1 = nullptr;
    if constexpr (kMode == kSplit)
      o1 = reinterpret_cast<float4*>(y1 + row * T + k * kTile);
#pragma unroll
    for (int v = 0; v < kVecs; ++v) {
      const float4 xv = *reinterpret_cast<const float4*>(in + 4 * v);
      const float xs[4] = {xv.x, xv.y, xv.z, xv.w};
      float a[4], b[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float lo;
        const float hp = ch.step<k3arg>(xs[j], lo);
        if constexpr (kMode == kSplit) {
          a[j] = hp;
          b[j] = lo;
        } else if constexpr (kMode == kHfScale) {
          a[j] = ADD(MUL(hp, g_hf), lo);
        } else {
          a[j] = ADD(MUL(hp, g_hf), MUL(lo, g_lf));
        }
      }
      o0[v] = make_float4(a[0], a[1], a[2], a[3]);
      if constexpr (kMode == kSplit)
        o1[v] = make_float4(b[0], b[1], b[2], b[3]);
    }
  }
  if (live) {
    st_out[3 * row] = ch.z1;
    st_out[3 * row + 1] = ch.z2;
    st_out[3 * row + 2] = ch.za;
  }
}

template <int kMode>
void launch(bool v3, const float* x, const float* st_in, float ap,
            const float* hf, int hf_stride, const float* lf, int lf_stride,
            float* y0, float* y1, float* st_out, int D, int T,
            cudaStream_t stream) {
  const dim3 grid((D + kRows - 1) / kRows);
  if (v3)
    band_split_kernel<kMode, true><<<grid, kRows, 0, stream>>>(
        x, st_in, ap, hf, hf_stride, lf, lf_stride, y0, y1, st_out, D, T);
  else
    band_split_kernel<kMode, false><<<grid, kRows, 0, stream>>>(
        x, st_in, ap, hf, hf_stride, lf, lf_stride, y0, y1, st_out, D, T);
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for D < 1, T < 32, T % 32 != 0 or an unknown mode.
// x [D, T], st_in and st_out [D, 3], y0 (and y1 for split) [D, T] are
// contiguous float32 on the device, x and the outputs 16-byte aligned; hf
// and lf (read by hf_scale and scale) hold a gain per row at the given
// stride, 0 for one gain for every row.  mode: 0 split (y0 = hp, y1 = lp),
// 1 hf_scale, 2 scale (y0 = the scaled sum).
extern "C" int band_split_launch(const float* x, const float* st_in,
                                 float ap, const float* hf, int hf_stride,
                                 const float* lf, int lf_stride, float* y0,
                                 float* y1, float* st_out, int D, int T,
                                 int mode, int variant_3arg, void* stream) {
  if (D < 1 || T < kTile || T % kTile || mode < kSplit || mode > kScale)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool v3 = variant_3arg != 0;
  const auto s = static_cast<cudaStream_t>(stream);
  if (mode == kSplit)
    launch<kSplit>(v3, x, st_in, ap, hf, hf_stride, lf, lf_stride, y0, y1,
                   st_out, D, T, s);
  else if (mode == kHfScale)
    launch<kHfScale>(v3, x, st_in, ap, hf, hf_stride, lf, lf_stride, y0, y1,
                     st_out, D, T, s);
  else
    launch<kScale>(v3, x, st_in, ap, hf, hf_stride, lf, lf_stride, y0, y1,
                   st_out, D, T, s);
  return static_cast<int>(cudaGetLastError());
}
