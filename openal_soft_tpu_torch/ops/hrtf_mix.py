"""Batched HRTF mixing as matrix products (port of ops/hrtf_mix.py).

Each voice's delay-shifted 192-tap HRIR pair convolves its gain-enveloped
samples into one stereo accumulation frame.  Summed over voices this is

    y[e, n] = sum_k P[e, k, n-k],   P[e, k, n] = sum_v c'[v, k, e] w[v, e, n]

so the population reduces to one [2*192, V] x [V, N] float32 matmul (where
the FLOPs are), a skew-sum over the tap axis and the fold of the 128-sample
tail into the next block (hrtfbase.h:121-132).  The matmul is plain
``torch.matmul`` in full float32 (TF32 off, ``_device.resolve_device``),
as the JAX package leaves it to XLA at ``Precision.HIGHEST``.

The JAX package picks the fade or the steady branch with ``lax.cond`` on
``any(fade > 0)``; here the caller passes that fact from its host mirror
(``any_fade``), so no block waits on a device-to-host read.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..constants import (
    GAIN_SILENCE_THRESHOLD,
    HRIR_LENGTH,
    HRTF_HISTORY_LENGTH,
)

HIST = HRTF_HISTORY_LENGTH  # 64
HRIR_EXT = HRIR_LENGTH + HIST  # 192: HRIR shifted by its integer delay


def skew_sum(P: torch.Tensor) -> torch.Tensor:
    """Anti-diagonal sum  y[e, n] = sum_d P[e, d, n - d]  without gathers.

    Pad each tap row by D zeros, flatten, and re-view with a row stride one
    shorter: row d of the new view is row d of the old shifted right by d,
    so a plain sum over rows is the convolution output.
    P: [E, D, N] -> y: [E, N + D - 1].
    """
    E, D, N = P.shape
    W = N + D - 1
    flat = F.pad(P, (0, D)).reshape(E, D * (N + D))
    return flat[:, :D * W].reshape(E, D, W).sum(dim=1)


def _contract(c: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """einsum("vde,vn->edn"): [V, D, E] taps x [V, N] samples -> [E, D, N],
    as ONE [E*D, V] x [V, N] matmul."""
    V, D, E = c.shape
    return torch.matmul(c.permute(2, 1, 0).reshape(E * D, V),
                        x).reshape(E, D, x.shape[1])


def _contract_ears(c: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("vde,ven->edn"): per-ear samples [V, E, N] -> [E, D, N]."""
    return torch.bmm(c.permute(2, 1, 0), w.permute(1, 0, 2))


def _edge_fix(P, gc, delay, head_src, tail_src, T: int):
    """Subtract what the folded-gain steady form overcounts at the per-ear
    window edges: the first HIST-d history samples and the last d block
    samples (``hrtf_voices_accum``'s steady branch).  In place on P."""
    k = torch.arange(HIST, dtype=torch.int32, device=P.device)
    lim = (HIST - delay)[:, :, None]
    w_head = torch.where(k[None, None, :] < lim, head_src[:, None, :], 0.0)
    w_tail = torch.where(k[None, None, :] >= lim, tail_src[:, None, :], 0.0)
    P[:, :, :HIST] -= _contract_ears(gc, w_head)
    P[:, :, T:] -= _contract_ears(gc, w_tail)
    return P


def _fade_sets(x_cat, coeffs, delay, gain, old_coeffs, old_delay, old_gain,
               fade, active, T: int, fade_len: int):
    """The fade branch: old IR ramps out, new IR ramps in (DoHrtfMix)."""
    N = HIST + T
    j = torch.arange(N, dtype=torch.float32, device=x_cat.device)
    fading = (fade > 0)[:, None, None]
    act = active[:, None, None]
    fl = float(fade_len)

    def shifted_env(d, kind):
        # Envelope evaluated at arg = m + d, m the input stream index.
        arg = (j[None, None, :] - HIST) + d[:, :, None].to(torch.float32)
        if kind == "new":
            step = (gain / fl)[:, None, None]
            ramp = torch.where((gain > GAIN_SILENCE_THRESHOLD)[:, None, None],
                               step * arg, 0.0)
            env = torch.where(fading & (arg < fl), ramp, gain[:, None, None])
        else:
            step = (old_gain / fl)[:, None, None]
            env = torch.where(
                fading & (arg < fl)
                & (old_gain > GAIN_SILENCE_THRESHOLD)[:, None, None],
                step * (fl - arg), 0.0)
        valid = (arg >= 0.0) & (arg < T)
        return torch.where(valid & act, env, 0.0)

    def one_set(c, env):
        return _contract_ears(c, x_cat[:, None, :] * env)

    return (one_set(coeffs, shifted_env(delay, "new"))
            + one_set(old_coeffs, shifted_env(old_delay, "old")))


def hrtf_voices_accum(x_cat, coeffs, delay, gain, old_coeffs, old_delay,
                      old_gain, fade, active, T: int, fade_len: int,
                      any_fade: bool):
    """Time-domain stereo accumulation for a voice batch (DoHrtfMix,
    core/voice.cpp:584-658).

    Args:
      x_cat: [L, HIST+T] f32 history ++ block samples.
      coeffs/old_coeffs: [L, 192, 2] f32 delay-shifted HRIRs.
      delay/old_delay: [L, 2] int32; gain/old_gain: [L] f32;
      fade: [L] int32 (0 or fade_len); active: [L] bool.
      any_fade: host-known ``bool(fade.any())`` — picks the branch.
    Returns y_ext [2, HIST+T+191] f32 in the accumulation frame.
    """
    if any_fade:
        P = _fade_sets(x_cat, coeffs, delay, gain, old_coeffs, old_delay,
                       old_gain, fade, active, T, fade_len)
    else:
        # No fades: the gain folds into the IR matrix, so the hot
        # contraction takes a single [L, N] rhs; the window edges are
        # subtracted with two small products.
        gc = coeffs * torch.where(active, gain, 0.0)[:, None, None]
        P = _edge_fix(_contract(gc, x_cat), gc, delay, x_cat[:, :HIST],
                      x_cat[:, T:], T)
    return skew_sum(P)


def hrtf_voices_accum_split(hist, x, coeffs, delay, gain, old_coeffs,
                            old_delay, old_gain, fade, active, T: int,
                            fade_len: int, any_fade: bool):
    """hrtf_voices_accum without materializing [hist ++ x] in the steady
    branch: history and block samples contract separately and the small
    P halves concatenate (the fused super-block path, T = 2..16 blocks)."""
    if any_fade:
        x_cat = torch.cat([hist, x], dim=1)
        P = _fade_sets(x_cat, coeffs, delay, gain, old_coeffs, old_delay,
                       old_gain, fade, active, T, fade_len)
    else:
        gc = coeffs * torch.where(active, gain, 0.0)[:, None, None]
        P = torch.cat([_contract(gc, hist), _contract(gc, x)], dim=2)
        P = _edge_fix(P, gc, delay, hist, x[:, T - HIST:], T)
    return skew_sum(P)


def direct_hrtf_accum(chans: torch.Tensor, c_dir: torch.Tensor,
                      T: int) -> torch.Tensor:
    """Direct B-Format -> binaural (the FIR part of MixDirectHrtf).

    chans: [D, T] hf-scaled dry channels; c_dir: [D, 192, 2] baked-decode
    HRIRs zero-extended to the voice tap frame.
    Returns y_ext [2, HIST+T+191] f32 in the voice accumulation frame.
    """
    return skew_sum(_contract(c_dir, F.pad(chans, (HIST, 0))))


def fold_accum(y_ext: torch.Tensor, tail: torch.Tensor, T: int):
    """The accumulation-buffer fold (hrtfbase.h:121-132).

    y_ext: [2, HIST+T+191]; tail: [128, 2] carry from the previous block.
    Requires T >= 128.  Returns (out [2, T], new_tail [128, 2]).
    """
    y = y_ext[:, HIST:HIST + T + HRIR_LENGTH]
    out = y[:, :T] + F.pad(tail.T, (0, T - HRIR_LENGTH))
    new_tail = y[:, T:T + HRIR_LENGTH].T.contiguous()
    return out, new_tail
