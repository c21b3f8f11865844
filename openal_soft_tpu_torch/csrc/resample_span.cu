// General-pitch voice resampler for sample pools larger than L2, for NVIDIA
// Hopper (sm_90a).
//
// Replaces the TPU kernel openal_soft_tpu/ops/pallas/resample2.py `_kernel`
// (reached through `_resample2` when the active voices' buffers do not fit
// the shared VMEM image: two span DMAs per voice from HBM, then per-row
// windows assembled in VMEM with one loop seam per row).  It computes
// ops/resample.py `resample_voices` at any increment, for every tier, as
// csrc/resample_gen.cu does, and is exact for any loop length.
//
// What bounds it: the bytes.  Each voice's source window is read once and
// the output written once: at the full-width UHJ scene's V = 4096,
// W = 16512 and pitch 2**U(-1,1) about 0.1 GB of windows and 0.27 GB of
// output.  The pool (~1 GB there) is 19x the 50 MB L2, so every window
// comes from device memory, and a block that waits for its window idles
// its share of the SM unless other work is in flight.
//
// Design: csrc/resample_window.cuh, the staged-window kernel that K3 also
// runs.  One block per (voice, tile of up to 8192 outputs) stages the
// voice's weight tables once, then each window's resolved source frames
// (cp.async, 16 bytes where aligned), and computes the window's outputs
// from shared memory: per tap two loads for the weight and one for the
// frame.  A window is read from device memory once.  Registers are held to
// 32, so eight blocks stay resident per SM and the SM's window copies are
// in flight while its other blocks compute; a double-buffered block (its
// own next window's copies issued before it computes the current one)
// measured 2-8 % slower at that occupancy (PERF.md).
//
// Exactness: products and sums are rounded one by one (__fmul_rn,
// __fadd_rn) in the plain version's order, taps j = 0..taps-1 from 0.0f,
// so the kernel equals the plain torch version bit for bit.

#include "resample_window.cuh"

// Launch on `stream`; returns a CUDA error code (0 on success).
// bank: [4 (fil, phd, scd, spd), 52, 32, taps] f32; meta [V, 12] i32;
// cap: frames of the window buffer (ops/kernels/resample_gen.py
// window_frames), at least taps + 1.
extern "C" int resample_span_launch(const float* pool, long long pool_len,
                                    const int* meta, const float* sf,
                                    const float* bank, float* out, int V,
                                    int W, int taps, int cap, void* stream) {
  return rsw::launch(pool, pool_len, meta, sf, bank, out, V, W, taps, cap,
                     stream);
}
