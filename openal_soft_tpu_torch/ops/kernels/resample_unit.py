"""Unit-increment resampler: plain version and the Hopper kernel's wrapper.

When every active voice plays at increment exactly 1<<16 (native rate), the
resample collapses to a FIR with constant per-voice weights over a
contiguous source window:

    out[v, t] = sum_j w[v, j] * src_v(resolve(pos_int[v] + t + j - center))

``resolve`` is ``ops/resample.resolve_source_index``: loop wrap forward and
(after a wrap) backward, end clamp for non-looping voices, silence before
the start and for empty sources.  Each tap resolves on its own, so any loop
length and any number of seams inside the window is exact.

``resample_unit`` takes a CPU tensor to ``resample_unit_ref`` and a CUDA
tensor to the kernel in ``csrc/resample_unit.cu`` (which replaces the TPU
kernels ``openal_soft_tpu/ops/pallas/resample_unit.py`` ``_kernel_shared``
and ``_kernel``): each block stages a tile's resolved source frames in
shared memory, ``WINDOW`` outputs' worth at a time, with the staging of
K3, K4 and K5 (``csrc/resample_window.cuh``), and keeps the voice's
weights in registers.  On the card there is no fallback: the kernel
launches or the wrapper raises.  ``resample_unit.launches`` counts kernel
launches.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ...constants import MIXER_FRAC_BITS, RESAMPLE_TAPS

from .. import resample as rs_ops
from ._build import check_tensor, load_library

_PHASE_SHIFT = MIXER_FRAC_BITS - 5
WINDOW = 4096                # outputs per staged window (kWindow in the .cu)
_PHASE_SUB_MASK = (1 << _PHASE_SHIFT) - 1
_PHASE_SUB_SCALE = 1.0 / (1 << _PHASE_SHIFT)


def unit_weights_np(bank, bank_row, sf, pos_frac, taps: int):
    """Constant per-voice tap weights [V, taps] (phase fixed at pos_frac).

    Host numpy, f32 — same `(fil + sf*scd) + pf*(phd + sf*spd)` op order as
    do_bsinc/do_cubic (mixer_c.cpp:83-105) and the jnp voice_weights path.
    Valid because pos_frac is invariant at unit increment: it changes only
    on host position writes, which already rebuild the device config.
    """
    lo = RESAMPLE_TAPS // 2 - taps // 2
    pi = pos_frac >> _PHASE_SHIFT
    pf = ((pos_frac & _PHASE_SUB_MASK).astype(np.float32)
          * np.float32(_PHASE_SUB_SCALE))
    sel = lambda k: np.asarray(bank[k])[bank_row, pi, lo:lo + taps]
    sfc = sf.astype(np.float32)[:, None]
    w0 = sel("fil") + sfc * sel("scd")
    wd = sel("phd") + sfc * sel("spd")
    return (w0 + pf[:, None] * wd).astype(np.float32)


def smem_bytes(taps: int) -> int:
    """A block's shared memory: the window buffer of WINDOW + taps - 1
    frames with 3 floats of slack, rounded up to 16 bytes, and for a tap
    count the kernel does not unroll (1, 2, 4, 12, 24, 48) the weight row
    (csrc/resample_unit.cu launch_unit)."""
    row = 0 if taps in (1, 2, 4, 12, 24, 48) else (taps + 3) & ~3
    return 4 * (row + ((WINDOW + taps - 1 + 6) & ~3))


def resample_unit_ref(pool, src_off, src_len, loop_start, loop_end,
                      has_loop, has_wrapped, pos_int, weights,
                      n: int) -> torch.Tensor:
    """Plain torch version of the kernel: [V, n] f32.

    Taps accumulate in order j = 0..taps-1 from 0.0, each product and sum
    rounded on its own — the kernel's op order, so the two agree bit for
    bit on any device."""
    taps = weights.shape[1]
    t = torch.arange(n, dtype=torch.int32, device=pool.device)
    pos = pos_int[:, None] + t[None, :]
    out = torch.zeros((weights.shape[0], n), dtype=torch.float32,
                      device=pool.device)
    center = taps // 2 - 1
    for j in range(taps):
        s = pos + (j - center)
        idx, valid = rs_ops.resolve_source_index(s, loop_start, loop_end,
                                                 has_loop, has_wrapped,
                                                 src_len)
        v = rs_ops.gather_pool(pool, src_off, idx, valid)
        out = out + weights[:, j:j + 1] * v
    return out


def pack_meta(src_off, src_len, loop_start, loop_end, has_loop, has_wrapped,
              pos_int) -> torch.Tensor:
    """[V, 8] int32 per-voice scalars in the kernel's layout."""
    cols = (src_off, src_len, loop_start, loop_end, has_loop, has_wrapped,
            pos_int, torch.zeros_like(src_off))
    return torch.stack([c.to(torch.int32) for c in cols], dim=1).contiguous()


def bind_unit_launch(fn):
    """``fn`` (the kernel's C entry point) with its ctypes signature: pool,
    pool_len, meta, weights, out, V, W, taps, stream."""
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launcher():
    """The C entry point, built on first use, with its ctypes signature."""
    return bind_unit_launch(load_library("resample_unit").resample_unit_launch)


def resample_unit(pool, src_off, src_len, loop_start, loop_end, has_loop,
                  has_wrapped, pos_int, weights, n: int) -> torch.Tensor:
    """Unit-increment resample of V voices: [V, n] f32.

    ``pool`` [P] f32 flat sample pool; the per-voice arguments are [V]
    (int32, or bool for the two flags); ``weights`` [V, taps] f32 from
    ``unit_weights_np``.  A CPU pool runs the plain version; a CUDA pool
    launches the kernel on the current stream."""
    if pool.device.type == "cpu":
        return resample_unit_ref(pool, src_off, src_len, loop_start,
                                 loop_end, has_loop, has_wrapped, pos_int,
                                 weights, n)
    if pool.device.type != "cuda":
        raise ValueError(f"resample_unit: unsupported device {pool.device}")
    V, taps = weights.shape
    if not 1 <= taps <= RESAMPLE_TAPS:
        raise ValueError(f"resample_unit: taps={taps} outside "
                         f"1..{RESAMPLE_TAPS}")
    if n <= 0 or pool.dim() != 1 or pool.numel() == 0:
        raise ValueError("resample_unit: need n > 0 and a non-empty 1-D pool")
    dev = pool.device
    check_tensor("pool", pool, torch.float32, (pool.numel(),), dev)
    check_tensor("weights", weights, torch.float32, (V, taps), dev)
    meta = pack_meta(src_off, src_len, loop_start, loop_end, has_loop,
                     has_wrapped, pos_int)
    check_tensor("meta", meta, torch.int32, (V, 8), dev)
    out = torch.empty((V, n), dtype=torch.float32, device=dev)
    launch = _launcher()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = launch(pool.data_ptr(), pool.numel(), meta.data_ptr(),
                     weights.data_ptr(), out.data_ptr(), V, n, taps, stream)
    if err != 0:
        raise RuntimeError(f"resample_unit kernel launch failed: CUDA "
                           f"error {err}")
    resample_unit.launches += 1
    return out


resample_unit.launches = 0
