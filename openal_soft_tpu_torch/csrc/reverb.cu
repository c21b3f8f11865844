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
// dependent f32 operations.  The kernel is bound by the latency of that
// sequential chain.
//
// Design: the Pallas grid walks chunks in order on one core; CUDA blocks
// run in no order, so one block runs one pipeline and loops over the
// chunks itself: 4 lines x `chunk` samples = one thread per (line, sample),
// with __syncthreads() between stages (each stage reads rings and shared
// rows that the stage before wrote in the same chunk).  Unlike the TPU
// kernel there are no mirror rows: every ring index is taken modulo the
// ring's power-of-two length, so no read window can run off a staged copy
// (ROADMAP C1), and the chunk size is a parameter (64..256 by sample rate).
// The biquads use the plain version's balanced companion form: 32-sample
// sub-chunks scanned in parallel, an 8-step chain over sub-chunk states,
// and C*A^k rows precomputed once per launch in shared memory.
//
// Exactness: every product, sum and quotient is rounded on its own
// (__fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn, __fsqrt_rn) in the plain
// version's operand order, so nvcc cannot contract them into FMA.

#include <cuda_runtime.h>

namespace {

constexpr int NL = 4;
constexpr int kMaxCh = 256;
constexpr int kSub = 32;               // biquad sub-chunk
constexpr int kMaxN = kMaxCh / kSub;
constexpr int kRings = 5;              // late_in, early_ap, early_dl, vecap, late_dl

__device__ __forceinline__ float MUL(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float ADD(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float SUB(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float DIV(float a, float b) { return __fdiv_rn(a, b); }

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
  int chunk, e_passes, l_passes, mod_win;
};

struct Biq {
  float b0, A00, A01, A10, A11, B0, B1, delta, M00, M01, M10, M11;
};

struct Shared {
  Biq bq[4][NL];
  float ws0[4][NL][kSub], ws1[4][NL][kSub];
  float z[4][NL][2];
  float sd0[NL][kMaxN], sd1[NL][kMaxN], ss0[NL][kMaxN], ss1[NL][kMaxN];
  float x[NL][kMaxCh], y[NL][kMaxCh], yz[NL][kMaxCh];
  float d[NL][kMaxCh], u[NL][kMaxCh];
};

// ops/filters.py biquad_consts for one line.
__device__ void biquad_setup(Biq& b, float* ws0, float* ws1, const float* cf) {
  const float b0 = cf[0], a1 = cf[3], a2 = cf[4];
  const float delta = __fsqrt_rn(fmaxf(fabsf(a2), 1e-8f));
  b.b0 = b0;
  b.A00 = -a1;
  b.A01 = delta;
  b.A10 = DIV(-a2, delta);
  b.A11 = 0.0f;
  b.B0 = SUB(cf[1], MUL(a1, b0));
  b.B1 = DIV(SUB(cf[2], MUL(a2, b0)), delta);
  b.delta = delta;
  float m00 = b.A00, m01 = b.A01, m10 = b.A10, m11 = b.A11;
  for (int s = 1; s < kSub; s <<= 1) {       // A^32 by repeated squaring
    const float n00 = ADD(MUL(m00, m00), MUL(m01, m10));
    const float n01 = ADD(MUL(m00, m01), MUL(m01, m11));
    const float n10 = ADD(MUL(m10, m00), MUL(m11, m10));
    const float n11 = ADD(MUL(m10, m01), MUL(m11, m11));
    m00 = n00; m01 = n01; m10 = n10; m11 = n11;
  }
  b.M00 = m00; b.M01 = m01; b.M10 = m10; b.M11 = m11;
  float w0 = 1.0f, w1 = 0.0f;
  for (int k = 0; k < kSub; ++k) {           // rows C*A^k
    ws0[k] = w0;
    ws1[k] = w1;
    const float n0 = ADD(MUL(b.A00, w0), MUL(b.A10, w1));
    const float n1 = ADD(MUL(b.A01, w0), MUL(b.A11, w1));
    w0 = n0; w1 = n1;
  }
}

// ops/filters.py biquad_apply of biquad q over in -> out ([NL][CH] rows);
// every thread of the block calls it.
__device__ void biquad_run(Shared& sh, int q, const float (*in)[kMaxCh],
                           float (*out)[kMaxCh], int CH, int tid) {
  const int N = CH / kSub;
  if (tid < NL * N) {                        // zero-state scans
    const int l = tid / N, n = tid % N;
    const Biq& b = sh.bq[q][l];
    float s0 = 0.0f, s1 = 0.0f;
    for (int k = 0; k < kSub; ++k) {
      const float xk = in[l][n * kSub + k];
      sh.yz[l][n * kSub + k] = ADD(s0, MUL(b.b0, xk));
      const float n0 = ADD(ADD(MUL(b.A00, s0), MUL(b.A01, s1)), MUL(b.B0, xk));
      const float n1 = ADD(ADD(MUL(b.A10, s0), MUL(b.A11, s1)), MUL(b.B1, xk));
      s0 = n0; s1 = n1;
    }
    sh.sd0[l][n] = s0;
    sh.sd1[l][n] = s1;
  }
  __syncthreads();
  if (tid < NL) {                            // chain over sub-chunk states
    const int l = tid;
    const Biq& b = sh.bq[q][l];
    float c0 = sh.z[q][l][0], c1 = DIV(sh.z[q][l][1], b.delta);
    for (int n = 0; n < N; ++n) {
      sh.ss0[l][n] = c0;
      sh.ss1[l][n] = c1;
      const float n0 = ADD(ADD(MUL(b.M00, c0), MUL(b.M01, c1)), sh.sd0[l][n]);
      const float n1 = ADD(ADD(MUL(b.M10, c0), MUL(b.M11, c1)), sh.sd1[l][n]);
      c0 = n0; c1 = n1;
    }
    sh.z[q][l][0] = c0;
    sh.z[q][l][1] = MUL(c1, b.delta);
  }
  __syncthreads();
  {
    const int l = tid / CH, i = tid % CH, k = i % kSub, n = i / kSub;
    const float ys = ADD(MUL(sh.ws0[q][l][k], sh.ss0[l][n]),
                         MUL(sh.ws1[q][l][k], sh.ss1[l][n]));
    out[l][i] = ADD(sh.yz[l][i], ys);
  }
  __syncthreads();
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

__global__ void __launch_bounds__(NL * kMaxCh) reverb_kernel(Args a) {
  __shared__ Shared sh;
  const int tid = threadIdx.x;
  const int CH = a.chunk;
  const int l = tid / CH, i = tid % CH;
  const int* pi = a.pi;
  const float* pf = a.pf;
  const long long off0 = *a.offset;
  const bool do_fade0 = *a.serial_done != static_cast<long long>(pi[33]);

  if (tid < 4 * NL) {
    const int q = tid / NL, ql = tid % NL;
    const float* cf = q == 0 ? pf + 13 : q == 1 ? pf + 18
                    : q == 2 ? pf + 23 + 5 * ql : pf + 43 + 5 * ql;
    biquad_setup(sh.bq[q][ql], sh.ws0[q][ql], sh.ws1[q][ql], cf);
    sh.z[q][ql][0] = a.z[q][2 * ql];
    sh.z[q][ql][1] = a.z[q][2 * ql + 1];
  }
  const int mm = a.len_main - 1;
  if (a.write_main) {
    for (int t = tid; t < NL * a.W; t += blockDim.x) {
      const int ll = t / a.W, s = t - ll * a.W;
      a.main[static_cast<long long>(ll) * a.len_main + ((off0 + s) & mm)] =
          a.ain[t];
    }
  }
  __syncthreads();

  float* const late_in = a.ring[0] + static_cast<long long>(l) * a.len[0];
  float* const early_ap = a.ring[1] + static_cast<long long>(l) * a.len[1];
  float* const early_dl = a.ring[2] + static_cast<long long>(l) * a.len[2];
  float* const vecap = a.ring[3] + static_cast<long long>(l) * a.len[3];
  float* const late_dl = a.ring[4] + static_cast<long long>(l) * a.len[4];
  const float* const mline = a.main + static_cast<long long>(l) * a.len_main;
  const int m_li = a.len[0] - 1, m_eap = a.len[1] - 1, m_edl = a.len[2] - 1;
  const int m_vap = a.len[3] - 1, m_ldl = a.len[4] - 1;

  const int et0 = pi[l], et1 = pi[4 + l], lt0 = pi[8 + l], lt1 = pi[12 + l];
  const int e_ap_off = pi[16 + l], e_off = pi[20 + l];
  const int l_ap_off = pi[24 + l], l_off = pi[28 + l];
  const unsigned mod_step = static_cast<unsigned>(pi[32]);
  const float ec0 = pf[0], ec1 = pf[1], e_coeff = pf[2], dgain = pf[3];
  const float e_ap_c = pf[4], l_ap_c = pf[5], mix_x = pf[6], mix_y = pf[7];
  const float md256 = MUL(pf[8], 256.0f);
  const float t60_mid = pf[9 + l];
  const float fade_step = static_cast<float>(1.0 / CH);
  const float fi = static_cast<float>(i);
  const float fadec = MUL(fi, fade_step);
  const int eap_c = min(max(e_ap_off, 0), CH);
  const int eoff_c = min(max(e_off, 0), CH);
  const int vap_c = min(max(l_ap_off, 0), CH);
  const int Wl = CH + a.mod_win;
  unsigned mod_index = static_cast<unsigned>(*a.mod_index & 0xFFFFFFFFLL);
  const int n_chunks = a.W / CH;

  for (int k = 0; k < n_chunks; ++k) {
    const long long off = off0 + static_cast<long long>(k) * CH;
    const bool fade_now = do_fade0 && k == 0;

    // --- early ---
    const int tap0 = fade_now ? et0 : et1;
    const float c0 = fade_now ? ec0 : ec1;
    const float w0 = mline[(off - tap0 + i) & mm];
    const float w1 = mline[(off - et1 + i) & mm];
    sh.x[l][i] = ADD(MUL(MUL(w0, c0), SUB(1.0f, fadec)),
                     MUL(MUL(w1, ec1), fadec));
    __syncthreads();
    biquad_run(sh, 0, sh.x, sh.y, CH, tid);
    biquad_run(sh, 1, sh.y, sh.x, CH, tid);
    float tmp = sh.x[l][i];

    const float win = early_ap[(off - e_ap_off + i) & m_eap];
    sh.d[l][i] = tmp;
    __syncthreads();
    for (int p = 0; p < a.e_passes; ++p) {
      const float back = i >= eap_c ? sh.d[l][i - eap_c] : 0.0f;
      const float r = i < e_ap_off ? win : back;
      const float y = SUB(r, MUL(e_ap_c, tmp));
      const float dn = ADD(tmp, MUL(e_ap_c, y));
      __syncthreads();
      sh.d[l][i] = dn;
      __syncthreads();
    }
    {
      const float back = i >= eap_c ? sh.d[l][i - eap_c] : 0.0f;
      const float r = i < e_ap_off ? win : back;
      early_ap[(off + i) & m_eap] = sh.d[l][i];
      tmp = SUB(r, MUL(e_ap_c, tmp));
    }
    sh.u[l][i] = tmp;
    __syncthreads();

    {
      const float t0 = sh.u[0][i], t1 = sh.u[1][i];
      const float t2 = sh.u[2][i], t3 = sh.u[3][i];
      const float r0 = l == 0 ? 0.5f : -0.5f, r1 = l == 1 ? 0.5f : -0.5f;
      const float r2 = l == 2 ? 0.5f : -0.5f, r3 = l == 3 ? 0.5f : -0.5f;
      const float refl = ADD(ADD(ADD(MUL(r0, t0), MUL(r1, t1)), MUL(r2, t2)),
                             MUL(r3, t3));
      early_dl[(off + i) & m_edl] = refl;
      sh.y[l][i] = refl;
    }
    __syncthreads();
    {
      float dread;
      if (i < e_off) {
        dread = early_dl[(off - e_off + i) & m_edl];
      } else {
        dread = i >= eoff_c ? sh.y[l][i - eoff_c] : 0.0f;
      }
      a.early[static_cast<long long>(l) * a.W + k * CH + i] =
          ADD(MUL(dread, e_coeff), tmp);
      late_in[(off + i) & m_li] = scatter(l, sh.u[0][i], sh.u[1][i],
                                          sh.u[2][i], sh.u[3][i], mix_x,
                                          mix_y);
    }
    __syncthreads();

    // --- late ---
    {
      const unsigned iidx = mod_index + static_cast<unsigned>(i) * mod_step;
      const float xm = MUL(static_cast<float>(iidx & 0xFFFFFFu),
                           5.9604644775390625e-08f);      // 2^-24
      const float lfo = (iidx & 0x800000u) == 0u
          ? ADD(MUL(MUL(-16.0f, xm), xm), MUL(8.0f, xm))
          : ADD(SUB(MUL(MUL(16.0f, xm), xm), MUL(24.0f, xm)), 8.0f);
      const unsigned idelay = __float2uint_rz(MUL(ADD(lfo, 1.0f), md256));
      const int pos = i - static_cast<int>(idelay >> 8) + a.mod_win;
      const float* cw = a.ctab + 4 * (idelay & 255u);
      const long long base = off - (l_off + a.mod_win);
      float acc = 0.0f;
      for (int tap = 0; tap < 4; ++tap) {
        const int q = min(max(pos - tap, 0), Wl - 1);
        acc = ADD(acc, MUL(late_dl[(base + q) & m_ldl], cw[tap]));
      }
      sh.x[l][i] = MUL(acc, t60_mid);
    }
    mod_index += static_cast<unsigned>(CH) * mod_step;
    __syncthreads();
    biquad_run(sh, 2, sh.x, sh.y, CH, tid);
    biquad_run(sh, 3, sh.y, sh.x, CH, tid);
    tmp = sh.x[l][i];
    {
      const int ltap0 = fade_now ? lt0 : lt1;
      const float lw0 = late_in[(off - ltap0 + i) & m_li];
      const float lw1 = late_in[(off - lt1 + i) & m_li];
      const float step = ltap0 != lt1 ? MUL(dgain, fade_step) : 0.0f;
      const float fade0 = SUB(dgain, MUL(step, fi));
      const float fade1 = MUL(step, fi);
      tmp = ADD(ADD(tmp, MUL(lw0, fade0)), MUL(lw1, fade1));
    }

    const float vwin = vecap[(off - l_ap_off + i) & m_vap];
    sh.d[l][i] = tmp;
    __syncthreads();
    for (int p = 0; p < a.l_passes; ++p) {
      const float back = i >= vap_c ? sh.d[l][i - vap_c] : 0.0f;
      const float r = i < l_ap_off ? vwin : back;
      const float y = SUB(r, MUL(l_ap_c, tmp));
      sh.u[l][i] = ADD(tmp, MUL(l_ap_c, y));
      __syncthreads();
      sh.d[l][i] = scatter(l, sh.u[0][i], sh.u[1][i], sh.u[2][i], sh.u[3][i],
                           mix_x, mix_y);
      __syncthreads();
    }
    {
      const float back = i >= vap_c ? sh.d[l][i - vap_c] : 0.0f;
      const float r = i < l_ap_off ? vwin : back;
      const float out = SUB(r, MUL(l_ap_c, tmp));
      vecap[(off + i) & m_vap] = sh.d[l][i];
      a.late[static_cast<long long>(l) * a.W + k * CH + i] = out;
      sh.u[l][i] = out;
    }
    __syncthreads();
    late_dl[(off + i) & m_ldl] = scatter(l, sh.u[3][i], sh.u[2][i],
                                         sh.u[1][i], sh.u[0][i], mix_x,
                                         mix_y);
    __syncthreads();
  }

  if (tid < 4 * NL) {
    const int q = tid / NL, ql = tid % NL;
    a.z[q][2 * ql] = sh.z[q][ql][0];
    a.z[q][2 * ql + 1] = sh.z[q][ql][1];
  }
  if (tid == 0) {
    *a.mod_index = static_cast<long long>(mod_index);
    *a.serial_done = static_cast<long long>(pi[33]);
  }
}

}  // namespace

// Launch one block on `stream`; returns cudaGetLastError() (0 on success).
extern "C" int reverb_pipeline_launch(
    const float* ain, int W, int write_main, const long long* offset,
    float* main, int len_main,
    float* late_in, int len_late_in, float* early_ap, int len_early_ap,
    float* early_dl, int len_early_dl, float* vecap, int len_vecap,
    float* late_dl, int len_late_dl,
    float* lp_z, float* hp_z, float* t60_hf_z, float* t60_lf_z,
    long long* mod_index, long long* serial_done, const int* pi,
    const float* pf, const float* ctab, float* early, float* late,
    int chunk, int e_passes, int l_passes, int mod_win, void* stream) {
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
  reverb_kernel<<<1, NL * chunk, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
