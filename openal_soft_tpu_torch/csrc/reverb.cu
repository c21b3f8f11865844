// One EAXReverb pipeline over a window, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel openal_soft_tpu/ops/pallas/reverb.py `_kernel`
// (reached through `_reverb_pipeline` and `run_pipeline_pallas`).  It
// computes ops/kernels/reverb.py `reverb_pipeline_ref`: the main-line write,
// then per chunk of `chunk` samples the early half (crossfaded main taps,
// low and high shelves, Allpass4, reflect into the early line, scatter into
// the late-input line) and the late half (modulated cubic read of the late
// line, T60 shelves, late-input taps with the density-gain fade, vector
// all-pass, reverse-scatter refeed).  Six delay rings [4, L] and four
// biquad states are updated in place in global memory.
//
// What bounds it: not bytes.  At the main path's window (W = 16384, 64
// chunks of 256) one launch reads ain (256 KB) and touches about 1.2 MB of
// rings, a few microseconds at HBM rate.  Every chunk depends on the one
// before (the rings feed back), and inside a chunk each stage reads what
// the stage before it wrote: the biquads' 32-step zero-state scans and
// 8-step chunk chains, and the all-pass fixed-point passes, are chains of
// dependent f32 operations separated by barriers.  A thread per (line,
// sample) needs a block-wide barrier around every stage (~59 per chunk at
// 48 kHz) and exposes each ring read after one.
//
// Design.  One 512-thread block per pipeline, two warp-specialised groups
// of 256 threads, a thread per sample holding all four lines:
//  * the early group runs chunk k+1's early half while the late group runs
//    chunk k's late half (one block barrier per step between them).  The
//    early half reads only the main line and its own rings, and writes
//    late_in one chunk ahead of what the late half reads (lags >= 0), so
//    the two never meet when late_in is at least the largest late tap plus
//    two chunks long: the wrapper checks that on the host and otherwise
//    asks for the in-order schedule (early k, barrier, late k, barrier);
//  * each group synchronises on its own named barrier (bar.sync id, 256),
//    and the cross-line mixes (reflection, scatters, the vector all-pass's
//    scatter) are register-local, so an all-pass pass is one group barrier
//    (ping-pong rows) instead of two block-wide ones;
//  * every ring read of a half (main taps, early_ap, early_dl, late_dl's
//    cubic taps, late_in, vecap) lags what the half itself writes, so all
//    are issued at the half's start and land during its biquads;
//  * the filters' balanced-companion constants (A^32, the C*A^k rows) come
//    packed after the parameters in pf, computed on the host once per
//    parameter change (ops/kernels/reverb.py filter_consts), not per launch,
//    and each biquad's chain start (z1 / delta) is taken by the group's
//    second warp while the first runs the zero-state scans;
//  * an all-pass stops its fixed-point passes once they have converged
//    (min(passes, ceil(chunk / shortest lag)): at the default density the
//    lags exceed the chunk and one or two passes do what 12 did).
// What still bounds it: each half is a chain of stages, and in each
// biquad one warp runs the 32-step zero-state scans and four threads the
// 8-step chain while the group waits; the two biquads of a half take most
// of its time (chip_smoke.py times the kernel; PERF.md has the split).
// No mirror rows: every ring index is taken modulo the ring's power-of-two
// length, so no read window can run off a staged copy (ROADMAP C1), and
// the chunk size is a parameter (32..256).
//
// Exactness: every product, sum and quotient is rounded on its own
// (__fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn) in the plain version's
// operand order, so nvcc cannot contract them into FMA; a pass over
// converged rows gives them back bit for bit, and both schedules compute
// every value from the same operands.

#include <cuda_runtime.h>

namespace {

constexpr int NL = 4;
constexpr int kMaxCh = 256;
constexpr int kGroup = kMaxCh;         // threads per group: one per sample
constexpr int kSub = 32;               // biquad sub-chunk
constexpr int kMaxN = kMaxCh / kSub;
constexpr int kRings = 5;              // late_in, early_ap, early_dl, vecap, late_dl
constexpr int kParams = 63;            // pf's parameters; constants follow
constexpr int kKc = 12 + 2 * kSub;     // constants per (filter, line)

__device__ __forceinline__ float MUL(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float ADD(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float SUB(float a, float b) { return __fsub_rn(a, b); }

struct Args {
  const float* ain;
  int W, write_main;
  const long long* offset;
  float* main;
  int len_main;
  float* ring[kRings];
  int len[kRings];
  float* z[4];                         // lp, hp, t60_hf, t60_lf: [4, 2]
  long long* mod_index;
  long long* serial_done;
  const int* pi;
  const float* pf;
  const float* ctab;                   // [256, 4]
  float* early;
  float* late;
  int chunk, e_passes, l_passes, mod_win, ahead;
};

struct Biq {
  float b0, A00, A01, A10, A11, B0, B1, delta, M00, M01, M10, M11;
};

struct __align__(16) Group {            // one group's rows
  float x[NL][kMaxCh], y[NL][kMaxCh], yz[NL][kMaxCh];
  float d[2][NL][kMaxCh];              // all-pass ping-pong
  float sd0[NL][kMaxN], sd1[NL][kMaxN], ss0[NL][kMaxN], ss1[NL][kMaxN];
};

struct __align__(16) Shared {
  Biq bq[4][NL];
  float ws0[4][NL][kSub], ws1[4][NL][kSub];
  float z[4][NL][2];
  Group g[2];                          // early, late
};

__device__ __forceinline__ void group_sync(int g) {
  asm volatile("bar.sync %0, %1;" :: "r"(g + 1), "r"(kGroup) : "memory");
}

// ops/filters.py biquad_apply of biquad q over in -> out ([NL][CH] rows)
// for one group; every thread of the group calls it.
__device__ void biquad_run(Shared& sh, Group& gr, int g, int q,
                           const float (*in)[kMaxCh], float (*out)[kMaxCh],
                           int CH, int tid) {
  const int N = CH / kSub;
  // The chain's start (z1 / delta) and constants, in the group's second
  // warp while the first runs the scans.
  float c0 = 0.0f, c1 = 0.0f;
  if (tid >= kSub && tid < kSub + NL) {
    const int l = tid - kSub;
    c0 = sh.z[q][l][0];
    c1 = __fdiv_rn(sh.z[q][l][1], sh.bq[q][l].delta);
  }
  if (tid < NL * N) {                        // zero-state scans
    const int l = tid / N, n = tid % N;
    const Biq& b = sh.bq[q][l];
    float v[kSub];                           // the sub-chunk, in registers
    const float4* src = reinterpret_cast<const float4*>(&in[l][n * kSub]);
#pragma unroll
    for (int j = 0; j < kSub / 4; ++j) {
      const float4 t = src[j];
      v[4 * j] = t.x; v[4 * j + 1] = t.y; v[4 * j + 2] = t.z; v[4 * j + 3] = t.w;
    }
    float s0 = 0.0f, s1 = 0.0f;
#pragma unroll
    for (int k = 0; k < kSub; ++k) {
      const float xk = v[k];
      v[k] = ADD(s0, MUL(b.b0, xk));
      const float n0 = ADD(ADD(MUL(b.A00, s0), MUL(b.A01, s1)), MUL(b.B0, xk));
      const float n1 = ADD(ADD(MUL(b.A10, s0), MUL(b.A11, s1)), MUL(b.B1, xk));
      s0 = n0; s1 = n1;
    }
    float4* dst = reinterpret_cast<float4*>(&gr.yz[l][n * kSub]);
#pragma unroll
    for (int j = 0; j < kSub / 4; ++j)
      dst[j] = make_float4(v[4 * j], v[4 * j + 1], v[4 * j + 2], v[4 * j + 3]);
    gr.sd0[l][n] = s0;
    gr.sd1[l][n] = s1;
  }
  group_sync(g);
  if (tid >= kSub && tid < kSub + NL) {      // chain over sub-chunk states
    const int l = tid - kSub;
    const Biq& b = sh.bq[q][l];
    float d0[kMaxN], d1[kMaxN];
#pragma unroll
    for (int n = 0; n < kMaxN; ++n) {
      d0[n] = gr.sd0[l][n];
      d1[n] = gr.sd1[l][n];
    }
#pragma unroll
    for (int n = 0; n < kMaxN; ++n) {
      if (n < N) {
        gr.ss0[l][n] = c0;
        gr.ss1[l][n] = c1;
        const float n0 = ADD(ADD(MUL(b.M00, c0), MUL(b.M01, c1)), d0[n]);
        const float n1 = ADD(ADD(MUL(b.M10, c0), MUL(b.M11, c1)), d1[n]);
        c0 = n0; c1 = n1;
      }
    }
    sh.z[q][l][0] = c0;
    sh.z[q][l][1] = MUL(c1, b.delta);
  }
  group_sync(g);
  if (tid < CH) {
    const int i = tid, k = i % kSub, n = i / kSub;
#pragma unroll
    for (int l = 0; l < NL; ++l) {
      const float ys = ADD(MUL(sh.ws0[q][l][k], gr.ss0[l][n]),
                           MUL(sh.ws1[q][l][k], gr.ss1[l][n]));
      out[l][i] = ADD(gr.yz[l][i], ys);
    }
  }
  group_sync(g);
}

// The fixed-point passes an all-pass needs: after p passes the rows are
// exact below p times the shortest lag, and a pass over exact rows gives
// them back bit for bit, so min(passes, ceil(CH / lag)) passes leave what
// `passes` would.
__device__ __forceinline__ int passes_needed(const int* lag, int passes,
                                             int CH) {
  int m = lag[0];
#pragma unroll
  for (int l = 1; l < NL; ++l) m = min(m, lag[l]);
  return m < 1 ? passes : min(passes, (CH + m - 1) / m);
}

// VectorPartialScatter row l of (s0, s1, s2, s3).
__device__ __forceinline__ float scatter(int l, float s0, float s1, float s2,
                                         float s3, float mx, float my) {
  switch (l) {
    case 0: return ADD(MUL(mx, s0), MUL(my, ADD(SUB(s1, s2), s3)));
    case 1: return ADD(MUL(mx, s1), MUL(my, ADD(ADD(-s0, s2), s3)));
    case 2: return ADD(MUL(mx, s2), MUL(my, ADD(SUB(s0, s1), s3)));
    default: return ADD(MUL(mx, s3), MUL(my, SUB(SUB(-s0, s1), s2)));
  }
}

// Chunk k's early half, by the early group (tid = sample).
__device__ void early_half(const Args& a, Shared& sh, int k, bool fade_now,
                           int tid) {
  Group& gr = sh.g[0];
  const int CH = a.chunk;
  const int* pi = a.pi;
  const float* pf = a.pf;
  const long long off = *a.offset + static_cast<long long>(k) * CH;
  const bool act = tid < CH;
  const int i = tid;
  const int mm = a.len_main - 1, m_li = a.len[0] - 1, m_eap = a.len[1] - 1;
  const int m_edl = a.len[2] - 1;
  const float ec0 = pf[0], ec1 = pf[1], e_coeff = pf[2], e_ap_c = pf[4];
  const float mix_x = pf[6], mix_y = pf[7];
  const float fade_step = static_cast<float>(1.0 / CH);
  const float fadec = MUL(static_cast<float>(i), fade_step);
  const float c0 = fade_now ? ec0 : ec1;

  // Every ring read of the half, issued first.
  float w0[NL], w1[NL], win[NL], ewin[NL];
  if (act) {
#pragma unroll
    for (int l = 0; l < NL; ++l) {
      const float* mline = a.main + static_cast<long long>(l) * a.len_main;
      const int tap0 = fade_now ? pi[l] : pi[4 + l];
      w0[l] = mline[(off - tap0 + i) & mm];
      w1[l] = mline[(off - pi[4 + l] + i) & mm];
      win[l] = a.ring[1][static_cast<long long>(l) * a.len[1] +
                         ((off - pi[16 + l] + i) & m_eap)];
      ewin[l] = i < pi[20 + l]
          ? a.ring[2][static_cast<long long>(l) * a.len[2] +
                      ((off - pi[20 + l] + i) & m_edl)]
          : 0.0f;
    }
#pragma unroll
    for (int l = 0; l < NL; ++l)
      gr.x[l][i] = ADD(MUL(MUL(w0[l], c0), SUB(1.0f, fadec)),
                       MUL(MUL(w1[l], ec1), fadec));
  }
  group_sync(0);
  biquad_run(sh, gr, 0, 0, gr.x, gr.y, CH, tid);
  biquad_run(sh, gr, 0, 1, gr.y, gr.x, CH, tid);

  // Allpass4 by fixed-point passes over ping-pong rows.
  float tmp[NL];
  if (act) {
#pragma unroll
    for (int l = 0; l < NL; ++l) {
      tmp[l] = gr.x[l][i];
      gr.d[0][l][i] = tmp[l];
    }
  }
  group_sync(0);
  const int e_passes = passes_needed(pi + 16, a.e_passes, CH);
  for (int p = 0; p < e_passes; ++p) {
    if (act) {
#pragma unroll
      for (int l = 0; l < NL; ++l) {
        const int ap = pi[16 + l], apc = min(max(ap, 0), CH);
        const float back = i >= apc ? gr.d[p & 1][l][i - apc] : 0.0f;
        const float r = i < ap ? win[l] : back;
        const float y = SUB(r, MUL(e_ap_c, tmp[l]));
        gr.d[(p + 1) & 1][l][i] = ADD(tmp[l], MUL(e_ap_c, y));
      }
    }
    group_sync(0);
  }
  const int pe = e_passes & 1;
  float u[NL];
  if (act) {
#pragma unroll
    for (int l = 0; l < NL; ++l) {
      const int ap = pi[16 + l], apc = min(max(ap, 0), CH);
      const float back = i >= apc ? gr.d[pe][l][i - apc] : 0.0f;
      const float r = i < ap ? win[l] : back;
      a.ring[1][static_cast<long long>(l) * a.len[1] + ((off + i) & m_eap)] =
          gr.d[pe][l][i];
      u[l] = SUB(r, MUL(e_ap_c, tmp[l]));
    }
    // Reflect into the early delay line.
#pragma unroll
    for (int l = 0; l < NL; ++l) {
      const float r0 = l == 0 ? 0.5f : -0.5f, r1 = l == 1 ? 0.5f : -0.5f;
      const float r2 = l == 2 ? 0.5f : -0.5f, r3 = l == 3 ? 0.5f : -0.5f;
      const float refl = ADD(ADD(ADD(MUL(r0, u[0]), MUL(r1, u[1])),
                                 MUL(r2, u[2])), MUL(r3, u[3]));
      a.ring[2][static_cast<long long>(l) * a.len[2] + ((off + i) & m_edl)] =
          refl;
      gr.y[l][i] = refl;
    }
  }
  group_sync(0);
  if (act) {
#pragma unroll
    for (int l = 0; l < NL; ++l) {
      const int eo = pi[20 + l], eoc = min(max(eo, 0), CH);
      const float dread = i < eo ? ewin[l]
                                 : (i >= eoc ? gr.y[l][i - eoc] : 0.0f);
      a.early[static_cast<long long>(l) * a.W + k * CH + i] =
          ADD(MUL(dread, e_coeff), u[l]);
      a.ring[0][static_cast<long long>(l) * a.len[0] + ((off + i) & m_li)] =
          scatter(l, u[0], u[1], u[2], u[3], mix_x, mix_y);
    }
  }
}

// Chunk k's late half, by the late group (tid = sample); mod_index is
// the modulation index at the chunk's start.
__device__ void late_half(const Args& a, Shared& sh, int k, bool fade_now,
                          unsigned mod_index, int tid) {
  Group& gr = sh.g[1];
  const int CH = a.chunk;
  const int* pi = a.pi;
  const float* pf = a.pf;
  const long long off = *a.offset + static_cast<long long>(k) * CH;
  const bool act = tid < CH;
  const int i = tid;
  const int m_li = a.len[0] - 1, m_vap = a.len[3] - 1, m_ldl = a.len[4] - 1;
  const unsigned mod_step = static_cast<unsigned>(pi[32]);
  const float dgain = pf[3], l_ap_c = pf[5], mix_x = pf[6], mix_y = pf[7];
  const float md256 = MUL(pf[8], 256.0f);
  const float fade_step = static_cast<float>(1.0 / CH);
  const float fi = static_cast<float>(i);
  const int Wl = CH + a.mod_win;

  // Every ring read of the half, issued first.
  float lw0[NL], lw1[NL], vwin[NL], taps[NL][4];
  const float* cw = a.ctab;
  int pos = 0;
  if (act) {
    const unsigned iidx = mod_index + static_cast<unsigned>(i) * mod_step;
    const float xm = MUL(static_cast<float>(iidx & 0xFFFFFFu),
                         5.9604644775390625e-08f);      // 2^-24
    const float lfo = (iidx & 0x800000u) == 0u
        ? ADD(MUL(MUL(-16.0f, xm), xm), MUL(8.0f, xm))
        : ADD(SUB(MUL(MUL(16.0f, xm), xm), MUL(24.0f, xm)), 8.0f);
    const unsigned idelay = __float2uint_rz(MUL(ADD(lfo, 1.0f), md256));
    pos = i - static_cast<int>(idelay >> 8) + a.mod_win;
    cw = a.ctab + 4 * (idelay & 255u);
#pragma unroll
    for (int l = 0; l < NL; ++l) {
      const float* late_dl = a.ring[4] + static_cast<long long>(l) * a.len[4];
      const float* late_in = a.ring[0] + static_cast<long long>(l) * a.len[0];
      const long long base = off - (pi[28 + l] + a.mod_win);
#pragma unroll
      for (int tap = 0; tap < 4; ++tap) {
        const int q = min(max(pos - tap, 0), Wl - 1);
        taps[l][tap] = late_dl[(base + q) & m_ldl];
      }
      const int ltap0 = fade_now ? pi[8 + l] : pi[12 + l];
      lw0[l] = late_in[(off - ltap0 + i) & m_li];
      lw1[l] = late_in[(off - pi[12 + l] + i) & m_li];
      vwin[l] = a.ring[3][static_cast<long long>(l) * a.len[3] +
                          ((off - pi[24 + l] + i) & m_vap)];
    }
#pragma unroll
    for (int l = 0; l < NL; ++l) {
      float acc = 0.0f;
#pragma unroll
      for (int tap = 0; tap < 4; ++tap)
        acc = ADD(acc, MUL(taps[l][tap], cw[tap]));
      gr.x[l][i] = MUL(acc, pf[9 + l]);
    }
  }
  group_sync(1);
  biquad_run(sh, gr, 1, 2, gr.x, gr.y, CH, tid);
  biquad_run(sh, gr, 1, 3, gr.y, gr.x, CH, tid);

  float tmp[NL];
  if (act) {
#pragma unroll
    for (int l = 0; l < NL; ++l) {
      const int ltap0 = fade_now ? pi[8 + l] : pi[12 + l];
      const float step = ltap0 != pi[12 + l] ? MUL(dgain, fade_step) : 0.0f;
      const float fade0 = SUB(dgain, MUL(step, fi));
      const float fade1 = MUL(step, fi);
      tmp[l] = ADD(ADD(gr.x[l][i], MUL(lw0[l], fade0)), MUL(lw1[l], fade1));
      gr.d[0][l][i] = tmp[l];
    }
  }
  group_sync(1);
  // Vector all-pass by fixed-point passes over ping-pong rows; the scatter
  // mixes the four lines of this thread's sample.
  const int l_passes = passes_needed(pi + 24, a.l_passes, CH);
  for (int p = 0; p < l_passes; ++p) {
    if (act) {
      float uu[NL];
#pragma unroll
      for (int l = 0; l < NL; ++l) {
        const int ap = pi[24 + l], apc = min(max(ap, 0), CH);
        const float back = i >= apc ? gr.d[p & 1][l][i - apc] : 0.0f;
        const float r = i < ap ? vwin[l] : back;
        const float y = SUB(r, MUL(l_ap_c, tmp[l]));
        uu[l] = ADD(tmp[l], MUL(l_ap_c, y));
      }
#pragma unroll
      for (int l = 0; l < NL; ++l)
        gr.d[(p + 1) & 1][l][i] = scatter(l, uu[0], uu[1], uu[2], uu[3],
                                          mix_x, mix_y);
    }
    group_sync(1);
  }
  if (act) {
    const int pl = l_passes & 1;
    float out[NL];
#pragma unroll
    for (int l = 0; l < NL; ++l) {
      const int ap = pi[24 + l], apc = min(max(ap, 0), CH);
      const float back = i >= apc ? gr.d[pl][l][i - apc] : 0.0f;
      const float r = i < ap ? vwin[l] : back;
      out[l] = SUB(r, MUL(l_ap_c, tmp[l]));
      a.ring[3][static_cast<long long>(l) * a.len[3] + ((off + i) & m_vap)] =
          gr.d[pl][l][i];
      a.late[static_cast<long long>(l) * a.W + k * CH + i] = out[l];
    }
#pragma unroll
    for (int l = 0; l < NL; ++l)
      a.ring[4][static_cast<long long>(l) * a.len[4] + ((off + i) & m_ldl)] =
          scatter(l, out[3], out[2], out[1], out[0], mix_x, mix_y);
  }
}

__global__ void __launch_bounds__(2 * kGroup) reverb_kernel(Args a) {
  __shared__ Shared sh;
  const int g = threadIdx.x / kGroup, tid = threadIdx.x % kGroup;
  const int* pi = a.pi;
  const bool do_fade0 = *a.serial_done != static_cast<long long>(pi[33]);

  {                                          // the filters' constants
    const float* kc = a.pf + kParams;
    for (int t = threadIdx.x; t < 4 * NL * kKc; t += blockDim.x) {
      const int ql = t / kKc, c = t % kKc, q = ql / NL, l = ql % NL;
      if (c < 12)
        reinterpret_cast<float*>(&sh.bq[q][l])[c] = kc[t];
      else if (c < 12 + kSub)
        sh.ws0[q][l][c - 12] = kc[t];
      else
        sh.ws1[q][l][c - 12 - kSub] = kc[t];
    }
    if (threadIdx.x < 4 * NL * 2) {
      const int q = threadIdx.x / (2 * NL), r = threadIdx.x % (2 * NL);
      sh.z[q][r / 2][r % 2] = a.z[q][r];
    }
  }
  if (a.write_main) {
    const long long off0 = *a.offset;
    const int mm = a.len_main - 1;
    for (int t = threadIdx.x; t < NL * a.W; t += blockDim.x) {
      const int ll = t / a.W, s = t - ll * a.W;
      a.main[static_cast<long long>(ll) * a.len_main + ((off0 + s) & mm)] =
          a.ain[t];
    }
  }
  __syncthreads();

  const int n_chunks = a.W / a.chunk;
  const unsigned mod_step = static_cast<unsigned>(pi[32]);
  unsigned mod_index = static_cast<unsigned>(*a.mod_index & 0xFFFFFFFFLL);
  if (a.ahead) {
    // Step s: early(s) beside late(s - 1).
    for (int s = 0; s <= n_chunks; ++s) {
      if (g == 0 && s < n_chunks) {
        early_half(a, sh, s, do_fade0 && s == 0, tid);
      } else if (g == 1 && s > 0) {
        late_half(a, sh, s - 1, do_fade0 && s == 1, mod_index, tid);
        mod_index += static_cast<unsigned>(a.chunk) * mod_step;
      }
      __syncthreads();
    }
  } else {
    for (int k = 0; k < n_chunks; ++k) {
      if (g == 0) early_half(a, sh, k, do_fade0 && k == 0, tid);
      __syncthreads();
      if (g == 1) {
        late_half(a, sh, k, do_fade0 && k == 0, mod_index, tid);
        mod_index += static_cast<unsigned>(a.chunk) * mod_step;
      }
      __syncthreads();
    }
  }

  if (threadIdx.x < 4 * NL * 2) {
    const int q = threadIdx.x / (2 * NL), r = threadIdx.x % (2 * NL);
    a.z[q][r] = sh.z[q][r / 2][r % 2];
  }
  if (threadIdx.x == kGroup) {               // a late thread
    *a.mod_index = static_cast<long long>(mod_index);
    *a.serial_done = static_cast<long long>(pi[33]);
  }
}

}  // namespace

// Launch one block on `stream`; returns cudaGetLastError() (0 on success).
// `ahead` runs chunk k+1's early half beside chunk k's late half; the
// caller checks that late_in is long enough for it (ops/kernels/reverb.py
// early_ahead_ok).
extern "C" int reverb_pipeline_launch(
    const float* ain, int W, int write_main, const long long* offset,
    float* main, int len_main,
    float* late_in, int len_late_in, float* early_ap, int len_early_ap,
    float* early_dl, int len_early_dl, float* vecap, int len_vecap,
    float* late_dl, int len_late_dl,
    float* lp_z, float* hp_z, float* t60_hf_z, float* t60_lf_z,
    long long* mod_index, long long* serial_done, const int* pi,
    const float* pf, const float* ctab, float* early, float* late,
    int chunk, int e_passes, int l_passes, int mod_win, int ahead,
    void* stream) {
  if (chunk < kSub || chunk > kMaxCh || chunk % kSub || W <= 0 ||
      W % chunk || W > len_main) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args a{};
  a.ain = ain;
  a.W = W;
  a.write_main = write_main;
  a.offset = offset;
  a.main = main;
  a.len_main = len_main;
  float* rings[kRings] = {late_in, early_ap, early_dl, vecap, late_dl};
  const int lens[kRings] = {len_late_in, len_early_ap, len_early_dl,
                            len_vecap, len_late_dl};
  for (int r = 0; r < kRings; ++r) {
    a.ring[r] = rings[r];
    a.len[r] = lens[r];
  }
  a.z[0] = lp_z;
  a.z[1] = hp_z;
  a.z[2] = t60_hf_z;
  a.z[3] = t60_lf_z;
  a.mod_index = mod_index;
  a.serial_done = serial_done;
  a.pi = pi;
  a.pf = pf;
  a.ctab = ctab;
  a.early = early;
  a.late = late;
  a.chunk = chunk;
  a.e_passes = e_passes;
  a.l_passes = l_passes;
  a.mod_win = mod_win;
  a.ahead = ahead;
  reverb_kernel<<<1, 2 * kGroup, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
