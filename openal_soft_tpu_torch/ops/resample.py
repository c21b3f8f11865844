"""Batched voice resampling on torch tensors (port of ops/resample.py).

The plain general resampler for every tier (point, linear, spline/gaussian,
bsinc12/24/48) and the spec that the unit-increment kernel
(``ops/kernels/resample_unit.py``) is held to:

    out[v, i] = sum_j  w[v, phase(v,i), j] * src[v, pos(v,i) + j - taps/2 + 1]

with ``w = (fil + sf*scd) + pf*(phd + sf*spd)`` rows of the global weight
bank (``ops/tables.py``), in the reference's f32 op order.

Differences from the JAX form, none of which changes a value:

* the per-sample phase row is an indexed lookup; the JAX package's one-hot
  MXU contraction (a TPU workaround for a missing gather) selects the same
  weight exactly;
* modular wraps use ``torch.remainder``, whose result is non-negative for a
  positive divisor like ``jnp.mod`` (C's ``fmod`` sign would not be);
* pool reads clamp indices to ``[0, P-1]`` as ``jnp.take(mode="clip")``.
"""

from __future__ import annotations

import torch

from ..constants import (
    MIXER_FRAC_BITS,
    MIXER_FRAC_MASK,
    RESAMPLE_TAPS,
)

_PHASE_SHIFT = MIXER_FRAC_BITS - 5          # 11: frac bits below the phase index
_PHASE_SUB_MASK = (1 << _PHASE_SHIFT) - 1
_PHASE_SUB_SCALE = 1.0 / (1 << _PHASE_SHIFT)


def positions(pos_frac: torch.Tensor, increment: torch.Tensor, n: int):
    """Per-voice affine position streams.

    Args:
      pos_frac: [V] int32 starting fraction (< 2**16).
      increment: [V] int32 16.16 step.
    Returns:
      (pos [V,n] int32 relative integer positions, fr [V,n] int32 fractions).
    The products are taken in 64 bits, so windows whose last ``i*increment``
    passes 2**31 (a 16-block UHJ-padded window at 2x pitch) stay exact; the
    JAX package's int32 form agrees wherever it does not overflow.
    """
    i = torch.arange(n, dtype=torch.int64, device=pos_frac.device)
    total = pos_frac.long()[:, None] + i[None, :] * increment.long()[:, None]
    return ((total >> MIXER_FRAC_BITS).to(torch.int32),
            (total & MIXER_FRAC_MASK).to(torch.int32))


def resolve_source_index(s: torch.Tensor, loop_start: torch.Tensor,
                         loop_end: torch.Tensor, has_loop: torch.Tensor,
                         has_wrapped: torch.Tensor, src_len: torch.Tensor):
    """Map source-frame index to a readable frame, with validity mask.

    Loop wrap per LoadBufferStatic (voice.cpp:509-529), forward past
    loop_end and, once the voice has wrapped, backward below loop_start;
    non-looping sources clamp to the final frame; negative positions
    (delayed starts) and empty sources are silent.
    """
    ls = loop_start[:, None]
    loop_len = torch.clamp(loop_end - loop_start, min=1)[:, None]
    in_wrap = (s >= loop_end[:, None]) | (has_wrapped[:, None] & (s < ls))
    wrapped = torch.where(in_wrap, torch.remainder(s - ls, loop_len) + ls, s)
    clamped = torch.where(has_loop[:, None], wrapped,
                          torch.minimum(s, torch.clamp(src_len - 1,
                                                       min=0)[:, None]))
    valid = (s >= 0) & (src_len[:, None] > 0)
    return clamped, valid


def gather_pool(pool: torch.Tensor, src_off: torch.Tensor, idx: torch.Tensor,
                valid: torch.Tensor) -> torch.Tensor:
    """pool[src_off + idx] with clip-mode indexing, zero where not valid."""
    a = (src_off[:, None].long() + idx.long()).clamp_(0, pool.numel() - 1)
    return torch.where(valid, pool[a], 0.0)


def voice_weights(bank: dict, bank_row: torch.Tensor, sf: torch.Tensor,
                  taps: int):
    """Per-voice phase-weight tables (W0, WD), each [V, 32, taps]:
    W0 = fil + sf*scd, WD = phd + sf*spd (do_bsinc, mixer_c.cpp:83-105)."""
    lo = RESAMPLE_TAPS // 2 - taps // 2
    rows = bank_row.long()
    sel = {k: bank[k][rows, :, lo:lo + taps] for k in ("fil", "phd", "scd",
                                                       "spd")}
    sfb = sf[:, None, None]
    return sel["fil"] + sfb * sel["scd"], sel["phd"] + sfb * sel["spd"]


def resample_voices(pool: torch.Tensor, src_off: torch.Tensor,
                    src_len: torch.Tensor, loop_start: torch.Tensor,
                    loop_end: torch.Tensor, has_loop: torch.Tensor,
                    has_wrapped: torch.Tensor, pos_int: torch.Tensor,
                    pos_frac: torch.Tensor, increment: torch.Tensor,
                    bank_row: torch.Tensor, sf: torch.Tensor, bank: dict,
                    n: int, taps: int) -> torch.Tensor:
    """Resample a batch of voice channels from the flat sample pool.

    Args:
      pool: [P] f32 flat sample pool (planar channel spans).
      src_off: [V] int32 pool offset of each voice channel's frame 0.
      src_len / loop_start / loop_end / has_loop: [V] source extents.
      pos_int/pos_frac/increment: [V] int32 voice position state (16.16).
      bank_row/sf: [V] resampler selection.
      bank: weight bank dict of [52,32,48] f32 tensors on pool's device.
      n: output sample count; taps: unified window width.
    Returns: [V, n] f32 resampled samples.
    """
    pos, fr = positions(pos_frac, increment, n)
    pos = pos + pos_int[:, None]
    pi = (fr >> _PHASE_SHIFT).long()
    pf = (fr & _PHASE_SUB_MASK).to(torch.float32) * _PHASE_SUB_SCALE

    w0, wd = voice_weights(bank, bank_row, sf, taps)
    rows = torch.arange(w0.shape[0], device=w0.device)[:, None]
    w0_t = w0[rows, pi]                                    # [V, n, taps]
    wd_t = wd[rows, pi]

    out = torch.zeros(pos.shape, dtype=torch.float32, device=pool.device)
    center = taps // 2 - 1
    for j in range(taps):
        s = pos + (j - center)
        idx, valid = resolve_source_index(s, loop_start, loop_end, has_loop,
                                          has_wrapped, src_len)
        v = gather_pool(pool, src_off, idx, valid)
        w = w0_t[:, :, j] + pf * wd_t[:, :, j]
        out = out + w * v
    return out


def advance_positions(pos_int: torch.Tensor, pos_frac: torch.Tensor,
                      increment: torch.Tensor, samples_mixed: int):
    """End-of-block position update (voice.cpp:1086-1089), pre loop wrap.
    The step is taken in 64 bits, as the host mirror's Python integers
    take it, so a 16-block window at 2x pitch does not wrap."""
    total = pos_frac.long() + increment.long() * samples_mixed
    return (pos_int + (total >> MIXER_FRAC_BITS).to(torch.int32),
            (total & MIXER_FRAC_MASK).to(torch.int32))
