// Interpolating biquad cascades (the voices' direct and send filters, the
// UHJ codecs' all-passes) for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel openal_soft_tpu/ops/pallas/biquad.py `_kernel`
// (time-major (T, V/128, 128) tiles, 1024-voice programs, T % 256 == 0).
// It computes ops/filters.py `biquad_interp`: per line, S = 2 or 4 cascaded
// TDF2 biquads (BiquadInterpFilter::dualProcess, biquad.cpp:284-343), each
//
//   y = x*b0 + z0;  z0 = (x*b1 - y*a1) + z1;  z1 = x*b2 - y*a2
//
// and after every 32 samples the coefficients step toward their targets:
// cnt2 = max(cnt - 32, 0), a = 1/(cnt2/32 + 1), cf = cnt > 0 ? (cnt2 == 0 ?
// target : cf + (target - cf)*a) : cf.  One launch runs P <= 8 filter paths
// over the same input x [V, T] (the direct filter and the aux-send filters
// all read the voices' unfiltered lines), each with its own state, schedule
// and optional active mask: where a line's mask is false its output is x,
// its state is cleared, its coefficients land on their targets and its
// counter on 0 (DoFilters, voice.cpp:254).  State is read at the start and
// written at the end, in place or to separate outputs.
//
// What bounds it.  Bytes: x read once, y written once per path (the main
// path's [4096, 1024] with P = 3: 67 MB, 0.020 ms at 3.35 TB/s).  And the
// chain: each section of each line is a dependent sequence of ~16 cycles
// per sample (add -> mul -> sub -> add through z0), 8.3 us for 1024
// samples at 1.98 GHz, whatever the number of lines.  One thread per line
// with every section leaves V = 4096 at one warp per SM, issuing the
// sections' instructions one after another, and the UHJ cascades' 3-48
// rows in one warp.
//
// Design.  One lane per (line, section): a warp holds 32/S lines, lane
// s*32/S + j runs section s of line j, and section s works one 32-sample
// step behind section s-1, reading the 32 outputs that section s-1 wrote
// to a double-buffered shared-memory row at the step before (eight 16-byte
// loads ahead of the chain; per-sample shuffles put their latency on it).
// So each lane issues ~9 instructions per sample against its 16-cycle
// chain, and the main path's V = 4096 fills twice as many warps as it has
// SMs.  A block holds one line
// group: warp 0 is the producer, warps 1..P the consumers, one per path.
// The producer streams the group's x through an 8-step ring of shared
// memory tiles with cp.async.bulk copies (one 128-byte row step per line)
// that complete on the tile's full mbarrier; each consumer releases a tile
// on its empty mbarrier once its last section has stored that step (an
// inactive line's y is x, read from the tile), so up to 8 steps of loads
// are in flight per group while the chains run.  Rows are padded to 36
// floats: the consumers' 16-byte reads of one sample column of 8 rows hit
// 32 distinct banks.  y goes out as 16-byte stores of each 32-sample row
// step straight from registers.
// What still bounds it: a lane's 32 samples run at the chain's pace (the
// probe below measures the chain alone: ~16 cycles per sample), but each
// step also waits on its tile, loads and hands over 32 values, stores y
// and steps the coefficients, outside the chain; at V = 4096 a step takes
// ~2.3x the chain's 32 samples (chip_smoke.py times it).  A variant that
// overlapped those with the chain (loads and stores a step early and late,
// three steps between sections) took 168 registers and was slower.
//
// Exactness: every product, sum and difference rounds on its own
// (__fmul_rn, __fadd_rn, __fsub_rn, no FMA contraction) in the plain
// version's order, and a is a correctly rounded division, so the kernel
// equals the plain torch version bit for bit.

#include <cuda_runtime.h>

namespace {

constexpr int kStep = 32;      // samples per step = the lerp cadence
constexpr int kDepth = 8;      // x tiles in flight per line group
constexpr int kRow = kStep + 4;
constexpr int kMaxPaths = 8;

__device__ __forceinline__ float MUL(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float ADD(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float SUB(float a, float b) { return __fsub_rn(a, b); }

struct Path {
  const float* z_in;
  float* z_out;
  long long z_ls;                // line strides, in elements
  const float* cf_in;
  float* cf_out;
  long long cf_ls;
  const float* tgt;
  long long tgt_ls;
  const int* cnt_in;
  int* cnt_out;
  long long cnt_ls;
  const unsigned char* fa;       // null: every line active
  long long fa_ls;
  float* y;                      // [V, T]
};

struct Paths {
  Path p[kMaxPaths];
};

__device__ __forceinline__ unsigned smem(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(unsigned long long* bar,
                                          unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(smem(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(unsigned long long* bar,
                                               unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(smem(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(unsigned long long* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];"
               :: "r"(smem(bar)) : "memory");
}

__device__ __forceinline__ void mbar_wait(unsigned long long* bar,
                                          unsigned parity) {
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done) : "r"(smem(bar)), "r"(parity) : "memory");
  }
}

// One row step of x (global -> shared), completing on `bar`.
__device__ __forceinline__ void bulk_load(float* dst, const float* src,
                                          unsigned bytes,
                                          unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];"
      :: "r"(smem(dst)), "l"(src), "r"(bytes), "r"(smem(bar)) : "memory");
}

template <int S>
__global__ void __launch_bounds__(32 * (kMaxPaths + 1))
biquad_paths_kernel(const float* __restrict__ x, const Paths paths, int P,
                    int V, int T) {
  constexpr int Lw = 32 / S;                 // lines per group
  // x tiles [kDepth][Lw][kRow], then per consumer warp the hand-over rows
  // [2][(S-1)*Lw][kRow] (double-buffered by step parity).
  extern __shared__ __align__(128) float sm[];
  __shared__ __align__(8) unsigned long long full[kDepth], empty[kDepth];
  float (*tile)[Lw][kRow] = reinterpret_cast<float (*)[Lw][kRow]>(sm);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int v0 = blockIdx.x * Lw;
  const int rows = min(Lw, V - v0);
  const int n = T / kStep;
  if (threadIdx.x == 0) {
    for (int i = 0; i < kDepth; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], P);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == 0) {                           // producer
    for (int k = 0; k < n; ++k) {
      const int st = k % kDepth;
      if (k >= kDepth) mbar_wait(&empty[st], ((k / kDepth) - 1) & 1);
      if (lane == 0) mbar_expect_tx(&full[st], rows * kStep * 4);
      __syncwarp();
      if (lane < rows)
        bulk_load(&tile[st][lane][0],
                  x + static_cast<long long>(v0 + lane) * T + k * kStep,
                  kStep * 4, &full[st]);
    }
    return;
  }

  const Path& pa = paths.p[warp - 1];
  float (*hand)[(S - 1) * Lw][kRow] =
      reinterpret_cast<float (*)[(S - 1) * Lw][kRow]>(
          sm + kDepth * Lw * kRow + (warp - 1) * 2 * (S - 1) * Lw * kRow);
  const int s = lane / Lw, j = lane % Lw;
  const int v = v0 + j;
  const bool valid = j < rows;
  float z0 = 0.0f, z1 = 0.0f, c[5], g[5];
  int cnt = 0;
  bool fa = true;
#pragma unroll
  for (int i = 0; i < 5; ++i) c[i] = g[i] = 0.0f;
  if (valid) {
    const float* zr = pa.z_in + v * pa.z_ls + 2 * s;
    z0 = zr[0];
    z1 = zr[1];
#pragma unroll
    for (int i = 0; i < 5; ++i) {
      c[i] = pa.cf_in[v * pa.cf_ls + 5 * s + i];
      g[i] = pa.tgt[v * pa.tgt_ls + 5 * s + i];
    }
    cnt = pa.cnt_in[v * pa.cnt_ls];
    fa = pa.fa == nullptr || pa.fa[v * pa.fa_ls] != 0;
  }

  for (int k = 0; k < n + S - 1; ++k) {
    if (k < n) mbar_wait(&full[k % kDepth], (k / kDepth) & 1);
    const int m = k - s;                     // the step this lane runs
    float out[kStep];
    if (m >= 0 && m < n) {
      // Section 0 reads x, section s the outputs section s-1 handed over
      // at the previous step.
      const float4* src = reinterpret_cast<const float4*>(
          s == 0 ? &tile[k % kDepth][j][0]
                 : &hand[(k - 1) & 1][(s - 1) * Lw + j][0]);
      float in[kStep];
#pragma unroll
      for (int i = 0; i < kStep / 4; ++i) {
        const float4 q = src[i];
        in[4 * i] = q.x;
        in[4 * i + 1] = q.y;
        in[4 * i + 2] = q.z;
        in[4 * i + 3] = q.w;
      }
#pragma unroll
      for (int u = 0; u < kStep; ++u) {
        const float xin = in[u];
        const float y = ADD(MUL(xin, c[0]), z0);
        const float n0 = ADD(SUB(MUL(xin, c[1]), MUL(y, c[3])), z1);
        const float n1 = SUB(MUL(xin, c[2]), MUL(y, c[4]));
        z0 = n0;
        z1 = n1;
        out[u] = y;
      }
      const int cnt2 = max(cnt - kStep, 0);
      const float a = __fdiv_rn(1.0f, ADD(static_cast<float>(cnt2 / kStep),
                                          1.0f));
#pragma unroll
      for (int i = 0; i < 5; ++i) {
        const float lerped = ADD(c[i], MUL(SUB(g[i], c[i]), a));
        c[i] = cnt > 0 ? (cnt2 == 0 ? g[i] : lerped) : c[i];
      }
      cnt = cnt2;
      if (s < S - 1) {                       // hand over to section s+1
        float4* dst = reinterpret_cast<float4*>(&hand[k & 1][lane][0]);
#pragma unroll
        for (int i = 0; i < kStep / 4; ++i)
          dst[i] = make_float4(out[4 * i], out[4 * i + 1], out[4 * i + 2],
                               out[4 * i + 3]);
      } else if (valid) {                    // the cascade's output
        float4* yr = reinterpret_cast<float4*>(
            pa.y + static_cast<long long>(v) * T + m * kStep);
        const float4* row = reinterpret_cast<const float4*>(
            &tile[m % kDepth][j][0]);
#pragma unroll
        for (int i = 0; i < kStep / 4; ++i)
          yr[i] = fa ? make_float4(out[4 * i], out[4 * i + 1],
                                   out[4 * i + 2], out[4 * i + 3])
                     : row[i];
      }
    }
    __syncwarp();
    const int mo = k - (S - 1);              // the step leaving the cascade
    if (mo >= 0 && lane == 0) mbar_arrive(&empty[mo % kDepth]);
  }

  if (valid) {
    float* zr = pa.z_out + v * pa.z_ls + 2 * s;
    zr[0] = fa ? z0 : 0.0f;
    zr[1] = fa ? z1 : 0.0f;
#pragma unroll
    for (int i = 0; i < 5; ++i)
      pa.cf_out[v * pa.cf_ls + 5 * s + i] = fa ? c[i] : g[i];
    if (s == 0) pa.cnt_out[v * pa.cnt_ls] = fa ? cnt : 0;
  }
}

template <int S>
int launch(const float* x, const Paths& ps, int P, int V, int T,
           cudaStream_t st) {
  constexpr int Lw = 32 / S;
  const size_t bytes =
      sizeof(float) * kRow * (kDepth * Lw + P * 2 * (S - 1) * Lw);
  cudaError_t err = cudaFuncSetAttribute(
      biquad_paths_kernel<S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  biquad_paths_kernel<S><<<(V + Lw - 1) / Lw, 32 * (P + 1), bytes, st>>>(
      x, ps, P, V, T);
  return static_cast<int>(cudaGetLastError());
}

// The chain that bounds the kernel, alone: one thread runs a section's
// recurrence (x fixed, so only the loop-carried chain through z0 is left)
// over n samples and reports the SM cycles and the nanoseconds it took.
__global__ void chain_probe_kernel(int n, float x, long long* out) {
  const float b0 = 0.25f, b1 = 0.5f, b2 = 0.25f, a1 = -0.5f, a2 = 0.125f;
  float z0 = x, z1 = 0.0f;
  const float m0 = MUL(x, b0), m1 = MUL(x, b1), m2 = MUL(x, b2);
  unsigned long long t0, t1;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t0));
  const long long c0 = clock64();
  for (int t = 0; t < n; t += kStep) {
#pragma unroll
    for (int u = 0; u < kStep; ++u) {
      const float y = ADD(m0, z0);
      const float n0 = ADD(SUB(m1, MUL(y, a1)), z1);
      z1 = SUB(m2, MUL(y, a2));
      z0 = n0;
    }
  }
  const long long c1 = clock64();
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t1));
  out[0] = c1 - c0;
  out[1] = static_cast<long long>(t1 - t0);
  out[2] = static_cast<long long>(__float_as_int(z0));   // keeps the chain
}

}  // namespace

// The chain probe: writes [SM cycles, ns, z] of n samples (n % 32 == 0) to
// the device array `out`.
extern "C" int biquad_chain_probe(int n, long long* out, void* stream) {
  if (n < kStep || n % kStep) return static_cast<int>(cudaErrorInvalidValue);
  chain_probe_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      n, 0.5f, out);
  return static_cast<int>(cudaGetLastError());
}

// Launch on `stream`.  `desc` holds 14 int64 per path: z_in, z_out,
// z_stride, cf_in, cf_out, cf_stride, target, target_stride, counter_in,
// counter_out, counter_stride, active (0: none), active_stride, y (line
// strides in elements).  Returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for V < 1, T < 1, T % 32 != 0, S not 2 or 4, P not
// in 1..8, or x or a y not 16-byte aligned.
extern "C" int biquad_paths_launch(const float* x, int V, int T, int S,
                                   int P, const long long* desc,
                                   void* stream) {
  if (V < 1 || T < 1 || T % kStep != 0 || (S != 2 && S != 4) || P < 1 ||
      P > kMaxPaths || reinterpret_cast<unsigned long long>(x) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Paths ps{};
  for (int p = 0; p < P; ++p) {
    const long long* d = desc + 14 * p;
    Path& q = ps.p[p];
    q.z_in = reinterpret_cast<const float*>(d[0]);
    q.z_out = reinterpret_cast<float*>(d[1]);
    q.z_ls = d[2];
    q.cf_in = reinterpret_cast<const float*>(d[3]);
    q.cf_out = reinterpret_cast<float*>(d[4]);
    q.cf_ls = d[5];
    q.tgt = reinterpret_cast<const float*>(d[6]);
    q.tgt_ls = d[7];
    q.cnt_in = reinterpret_cast<const int*>(d[8]);
    q.cnt_out = reinterpret_cast<int*>(d[9]);
    q.cnt_ls = d[10];
    q.fa = reinterpret_cast<const unsigned char*>(d[11]);
    q.fa_ls = d[12];
    q.y = reinterpret_cast<float*>(d[13]);
    if (d[13] % 16 != 0) return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return S == 2 ? launch<2>(x, ps, P, V, T, st) : launch<4>(x, ps, P, V, T, st);
}
