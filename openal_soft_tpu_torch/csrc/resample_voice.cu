// General-pitch voice resampler, one voice per thread block, for NVIDIA
// Hopper (sm_90a).
//
// Replaces the TPU kernel openal_soft_tpu/ops/pallas/resample.py `_kernel`
// (the first-generation resampler: one voice per grid program, two window
// DMAs per voice, then lane gathers over the windows).  It computes
// ops/resample.py `resample_voices` at any increment, for every tier, as
// csrc/resample_gen.cu (K3) and csrc/resample_span.cu (K4) do, and keeps
// the TPU kernel's grid: one block per voice, whatever the row's length.
//
// What bounds it: the bytes.  Each voice's source window is read once and
// its output written once: at [4096, 16512] on a 268 MB pool at pitch
// 2**U(-1,-0.6), 0.16 GB of windows and 0.27 GB of output, 0.127 ms at
// 3.35 TB/s.  A block with one voice's whole row must not idle its SM
// while its window arrives: others must be resident to compute meanwhile.
//
// Design: the staged-window kernel of csrc/resample_window.cuh, the one
// K3 and K4 run, behind a third entry point with one tile per row (the
// tile bound kTile is K3's and K4's).  The block stages the voice's weight
// tables W0/WD (32 phases x taps, the plain version's roundings) once, then
// cuts the row into windows that fit a buffer sized for the call's
// largest increment (ops/kernels/resample_gen.py window_frames: 1024
// outputs at that increment), and for each stages its resolved frames
// (16-byte cp.async where aligned), waits, and computes it from shared
// memory: per tap two loads for the weight and one for the frame.
// Registers are held to 32, and a window takes ~3 KB at pitch 0.66, so
// eight blocks stay resident per SM.
//
// Exactness: products and sums are rounded one by one (__fmul_rn,
// __fadd_rn) in the plain version's order, taps j = 0..taps-1 from 0.0f,
// so the kernel equals the plain torch version bit for bit.

#include "resample_window.cuh"

// Launch on `stream`; returns a CUDA error code (0 on success).
// bank: [4 (fil, phd, scd, spd), 52, 32, taps] f32; meta [V, 12] i32;
// cap: frames of the window buffer (ops/kernels/resample_gen.py
// window_frames), at least taps + 1.
extern "C" int resample_voice_launch(const float* pool, long long pool_len,
                                     const int* meta, const float* sf,
                                     const float* bank, float* out, int V,
                                     int W, int taps, int cap, void* stream) {
  return rsw::launch_tiles(pool, pool_len, meta, sf, bank, out, V, W, taps,
                           cap, W, stream);
}
