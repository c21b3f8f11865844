// The effects' per-sample recurrences for NVIDIA Hopper (sm_90a).
//
// No TPU kernel stands behind this file: the JAX package runs these
// recurrences as lax.scan (openal_soft_tpu/effects/compressor.py:49-54,
// autowah.py:55-61 and :77-84).  Written literally in torch they would be
// T x (ops per step) launches per block.  It computes, per line, the plain
// versions of ops/kernels/effect_scan.py:
//
//   compressor_env  amp [B, T] (|wet0| clipped to [0.5, 2], or 1 when off),
//                   env [B], prm = (attack, release) multipliers:
//                     env = a > env ? min(env*am, a)
//                         : a < env ? max(env*rm, a) : env;   gain = 1/env
//                   -> gains [B, T], env' [B]
//   autowah_env     x [B, T], env [B], prm = (peak gain, attack, release):
//                     s = pk*|x|;  env = s + (env - s)*(s > env ? att : rel)
//                   -> envs [B, T], env' [B]
//   swept_tdf2      x [B, T], per-sample normalised coefficients cf [5, T]
//                   (b0, b1, b2, a1, a2) shared by every line, z [B, 2]:
//                     y = x*b0 + z0;  z0 = (x*b1 - y*a1) + z1;
//                     z1 = x*b2 - y*a2
//                   -> y [B, T], z' [B, 2]
//
// Design: one thread per line, one dependent chain each, 32 lines per
// block.  The block stages a tile of 128 samples of its lines' input (and,
// for swept_tdf2, the tile of the five coefficient rows) through shared
// memory with coalesced loads, runs the chains over the tile, and writes
// the tile's output back the same way.  Rows are padded to 129 floats so
// that the 32 chains' column reads fall in 32 banks.
//
// What bounds it: the chain.  Per sample, swept_tdf2's z0 -> y -> z0 path
// is four dependent FP32 operations (add, mul, sub, add), autowah_env's
// env -> env path a compare, a select, a multiply and an add, and
// compressor_env's a multiply, a min or max and a select; the loads and
// the stores of a tile run outside it.
//
// Exactness: every product, sum and difference rounds on its own
// (__fmul_rn, __fadd_rn, __fsub_rn: no FMA contraction), 1/env is the
// correctly rounded __fdiv_rn, and the order is the plain version's, so
// each entry equals its plain torch version bit for bit.

#include <cuda_runtime.h>

namespace {

constexpr int kLines = 32;     // lines (threads) per block
constexpr int kTile = 128;     // samples per staged tile
constexpr int kRow = kTile + 1;

__device__ __forceinline__ float MUL(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float ADD(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float SUB(float a, float b) { return __fsub_rn(a, b); }

// Rows [b0, b0 + nl) of src [B, T], columns [t0, t0 + n), into dst rows.
__device__ __forceinline__ void load_tile(float (*dst)[kRow],
                                          const float* src, int b0, int nl,
                                          int T, int t0, int n) {
  for (int i = threadIdx.x; i < nl * kTile; i += blockDim.x) {
    const int l = i / kTile, c = i % kTile;
    if (c < n) dst[l][c] = src[static_cast<long long>(b0 + l) * T + t0 + c];
  }
}

__device__ __forceinline__ void store_tile(float* dst,
                                           const float (*src)[kRow], int b0,
                                           int nl, int T, int t0, int n) {
  for (int i = threadIdx.x; i < nl * kTile; i += blockDim.x) {
    const int l = i / kTile, c = i % kTile;
    if (c < n) dst[static_cast<long long>(b0 + l) * T + t0 + c] = src[l][c];
  }
}

__global__ void __launch_bounds__(kLines)
compressor_env_kernel(const float* __restrict__ amp,
                      const float* __restrict__ env_in,
                      const float* __restrict__ prm, float* __restrict__ gains,
                      float* __restrict__ env_out, int B, int T) {
  __shared__ float in[kLines][kRow];
  __shared__ float out[kLines][kRow];
  const int b0 = blockIdx.x * kLines;
  const int nl = min(kLines, B - b0);
  const int l = threadIdx.x;
  const float am = prm[0], rm = prm[1];
  float env = l < nl ? env_in[b0 + l] : 1.0f;
  for (int t0 = 0; t0 < T; t0 += kTile) {
    const int n = min(kTile, T - t0);
    load_tile(in, amp, b0, nl, T, t0, n);
    __syncthreads();
    if (l < nl) {
      for (int c = 0; c < n; ++c) {
        const float a = in[l][c];
        const float up = fminf(MUL(env, am), a);
        const float down = fmaxf(MUL(env, rm), a);
        env = a > env ? up : (a < env ? down : env);
        out[l][c] = __fdiv_rn(1.0f, env);
      }
    }
    __syncthreads();
    store_tile(gains, out, b0, nl, T, t0, n);
    __syncthreads();
  }
  if (l < nl) env_out[b0 + l] = env;
}

__global__ void __launch_bounds__(kLines)
autowah_env_kernel(const float* __restrict__ x,
                   const float* __restrict__ env_in,
                   const float* __restrict__ prm, float* __restrict__ envs,
                   float* __restrict__ env_out, int B, int T) {
  __shared__ float in[kLines][kRow];
  __shared__ float out[kLines][kRow];
  const int b0 = blockIdx.x * kLines;
  const int nl = min(kLines, B - b0);
  const int l = threadIdx.x;
  const float pk = prm[0], att = prm[1], rel = prm[2];
  float env = l < nl ? env_in[b0 + l] : 0.0f;
  for (int t0 = 0; t0 < T; t0 += kTile) {
    const int n = min(kTile, T - t0);
    load_tile(in, x, b0, nl, T, t0, n);
    __syncthreads();
    if (l < nl) {
      for (int c = 0; c < n; ++c) {
        const float s = MUL(pk, fabsf(in[l][c]));
        const float a = s > env ? att : rel;
        env = ADD(s, MUL(SUB(env, s), a));
        out[l][c] = env;
      }
    }
    __syncthreads();
    store_tile(envs, out, b0, nl, T, t0, n);
    __syncthreads();
  }
  if (l < nl) env_out[b0 + l] = env;
}

__global__ void __launch_bounds__(kLines)
swept_tdf2_kernel(const float* __restrict__ x, const float* __restrict__ cf,
                  const float* __restrict__ z_in, float* __restrict__ y,
                  float* __restrict__ z_out, int B, int T) {
  __shared__ float io[kLines][kRow];
  __shared__ float co[5][kRow];
  const int b0 = blockIdx.x * kLines;
  const int nl = min(kLines, B - b0);
  const int l = threadIdx.x;
  float z0 = 0.0f, z1 = 0.0f;
  if (l < nl) {
    z0 = z_in[2 * (b0 + l)];
    z1 = z_in[2 * (b0 + l) + 1];
  }
  for (int t0 = 0; t0 < T; t0 += kTile) {
    const int n = min(kTile, T - t0);
    load_tile(io, x, b0, nl, T, t0, n);
    load_tile(co, cf, 0, 5, T, t0, n);
    __syncthreads();
    if (l < nl) {
      for (int c = 0; c < n; ++c) {
        const float xn = io[l][c];
        const float yn = ADD(MUL(xn, co[0][c]), z0);
        z0 = ADD(SUB(MUL(xn, co[1][c]), MUL(yn, co[3][c])), z1);
        z1 = SUB(MUL(xn, co[2][c]), MUL(yn, co[4][c]));
        io[l][c] = yn;
      }
    }
    __syncthreads();
    store_tile(y, io, b0, nl, T, t0, n);
    __syncthreads();
  }
  if (l < nl) {
    z_out[2 * (b0 + l)] = z0;
    z_out[2 * (b0 + l) + 1] = z1;
  }
}

int check(int B, int T) {
  return (B < 1 || T < 1) ? static_cast<int>(cudaErrorInvalidValue) : 0;
}

}  // namespace

// Each entry launches on `stream` and returns cudaGetLastError() (0 on
// success), or cudaErrorInvalidValue for B < 1 or T < 1.  Every array is
// contiguous float32 on the device; prm is read on the device.

extern "C" int compressor_env_launch(const float* amp, const float* env_in,
                                     const float* prm, float* gains,
                                     float* env_out, int B, int T,
                                     void* stream) {
  if (int err = check(B, T)) return err;
  compressor_env_kernel<<<(B + kLines - 1) / kLines, kLines, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      amp, env_in, prm, gains, env_out, B, T);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int autowah_env_launch(const float* x, const float* env_in,
                                  const float* prm, float* envs,
                                  float* env_out, int B, int T,
                                  void* stream) {
  if (int err = check(B, T)) return err;
  autowah_env_kernel<<<(B + kLines - 1) / kLines, kLines, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      x, env_in, prm, envs, env_out, B, T);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int swept_tdf2_launch(const float* x, const float* cf,
                                 const float* z_in, float* y, float* z_out,
                                 int B, int T, void* stream) {
  if (int err = check(B, T)) return err;
  swept_tdf2_kernel<<<(B + kLines - 1) / kLines, kLines, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      x, cf, z_in, y, z_out, B, T);
  return static_cast<int>(cudaGetLastError());
}
