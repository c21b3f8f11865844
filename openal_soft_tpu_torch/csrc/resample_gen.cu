// General-pitch voice resampler for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel openal_soft_tpu/ops/pallas/resample3.py `_kernel`
// (reached through `_resample3`; all voices read one VMEM image of the
// active pool regions, and the window of each output tile is assembled
// with one-hot MXU products).  It computes ops/resample.py
// `resample_voices` at any increment, for every tier and any loop length
// (the TPU kernel's single-seam condition, loop_len >= window span, does
// not exist here): the device's plan sends it every general-pitch call
// whose pool fits L2, and loops shorter than a span window.
//
// What bounds it: the output writes, V*W floats (268 MB at the loaded
// scene's V = 4096, W = 16384: ~0.080 ms at 3.35 TB/s); the pool (9.2 MB
// there) is read from L2.  The arithmetic, 4 operations per tap, is
// ~1 GFLOP at taps = 4, and every tap needs a weight and a frame: the
// previous design (one thread per output) gathered four bank values and
// resolved the frame (a branch, a `%` and 64-bit clamps) per tap, ~10x the
// write time.
//
// Design: csrc/resample_window.cuh.  One block per (voice, tile of up to
// 8192 outputs) stages the voice's weight tables W0/WD (32 phases x taps,
// the plain version's roundings) once, then for each window of the tile
// stages its resolved source frames, waits, and computes the window's
// outputs from shared memory: per tap two loads for the weight and one
// for the frame, every thread several outputs.  The wrapper sizes the
// window for the call's largest increment (`cap` frames: 8 KB at the
// loaded scene's 2x), and registers are held to 32, so eight blocks stay
// resident per SM: the copies of some (from L2) run while others compute.
//
// Exactness: products and sums are rounded one by one (__fmul_rn,
// __fadd_rn) in the plain version's order, taps j = 0..taps-1 from 0.0f, so
// the kernel equals the plain torch version bit for bit.

#include "resample_window.cuh"

// Launch on `stream`; returns a CUDA error code (0 on success).
// bank: [4 (fil, phd, scd, spd), 52, 32, taps] f32; meta [V, 12] i32;
// cap: frames of the window buffer (ops/kernels/resample_gen.py
// window_frames), at least taps + 1.
extern "C" int resample_gen_launch(const float* pool, long long pool_len,
                                   const int* meta, const float* sf,
                                   const float* bank, float* out, int V, int W,
                                   int taps, int cap, void* stream) {
  return rsw::launch(pool, pool_len, meta, sf, bank, out, V, W, taps, cap,
                     stream);
}
