"""Gain-ramped batched mixing on torch tensors (port of ops/mix.py).

The reference's MixLine (core/mixer/mixer_c.cpp:150-186) accumulates one
voice channel into one output line with a linear gain ramp over the first
``Counter`` samples (64-sample fades, core/voice.cpp:1008) and a -100 dB
silence skip.  The voice axis is batched and the sum over voices is a
float32 contraction:

  * samples [0, F): per-(voice, channel, t) ramp gains — a small einsum;
  * samples [F, T): constant target gains — one [C, V] x [V, T-F] matmul.

The per-sample gains equal MixLine's (same f32 ``gain + step*stepcount``
form); only the cross-voice accumulation order differs.  The JAX package
computes these contractions as einsums outside any Pallas kernel, so they
stay ``torch.matmul``/``einsum`` in full float32 here (TF32 is off, see
``_device.resolve_device``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..constants import GAIN_SILENCE_THRESHOLD

_F32_EPS = float(np.finfo(np.float32).eps)


def ramp_gains(cur: torch.Tensor, tgt: torch.Tensor, counter: torch.Tensor,
               fade: int):
    """Per-sample mix gains for the fade region plus steady-state tail gains.

    Args:
      cur / tgt: [V, C] f32 current / target gains.
      counter: [V] int32 fade counters (0 = no fade; otherwise <= fade).
      fade: fade-region length F = min(64, T).
    Returns:
      (head [V, C, F] per-sample gains, tail [V, C] steady gains,
       new_cur [V, C] updated current gains).
    """
    counter_f = counter.to(torch.float32)
    delta = torch.where(counter > 0,
                        1.0 / torch.clamp(counter_f, min=1.0), 0.0)
    step = (tgt - cur) * delta[:, None]
    ramp_active = step.abs() > _F32_EPS
    tgt_masked = torch.where(tgt.abs() > GAIN_SILENCE_THRESHOLD, tgt, 0.0)
    t = torch.arange(fade, dtype=torch.float32, device=cur.device)
    in_fade = t[None, :] < counter_f[:, None]                       # [V, F]
    ramped = cur[:, :, None] + step[:, :, None] * t[None, None, :]  # [V, C, F]
    head = torch.where(ramp_active[:, :, None] & in_fade[:, None, :],
                       ramped, tgt_masked[:, :, None])
    # counter <= F <= T on the render path: the fade completes within the
    # block, so the new current gain is the target.
    return head, tgt_masked, tgt


def mix_voices(x: torch.Tensor, cur: torch.Tensor, tgt: torch.Tensor,
               counter: torch.Tensor, fade: int):
    """Accumulate voice-channel samples into output lines.

    x: [V, T] f32; cur/tgt: [V, C]; counter: [V] int32; fade = min(64, T).
    Returns (out [C, T] f32, new_cur [V, C]).
    """
    head, tail, new_cur = ramp_gains(cur, tgt, counter, fade)
    out_head = torch.einsum("vt,vct->ct", x[:, :fade], head)
    out_tail = torch.matmul(tail.T, x[:, fade:])
    return torch.cat([out_head, out_tail], dim=1), new_cur


def mix_voices_grouped(x: torch.Tensor, cur: torch.Tensor, tgt: torch.Tensor,
                       counter: torch.Tensor, group: torch.Tensor,
                       n_groups: int, fade: int):
    """Like mix_voices, but each voice routes to one of ``n_groups`` output
    buses (the effect-slot wet buses).  group: [V] int bus index per voice.

    The JAX package's one-hot einsum becomes one [G*C, V] x [V, T-F]
    product: row g*C + c of the left factor is tail[:, c] on the voices of
    bus g and zero elsewhere.
    Returns (out [n_groups, C, T], new_cur [V, C]).
    """
    head, tail, new_cur = ramp_gains(cur, tgt, counter, fade)
    V, C = tail.shape
    onehot = torch.nn.functional.one_hot(group.long(), n_groups).to(x.dtype)
    out_head = torch.einsum("vg,vt,vct->gct", onehot, x[:, :fade], head)
    lhs = (onehot[:, :, None] * tail[:, None, :]).reshape(V, n_groups * C)
    out_tail = torch.matmul(lhs.T, x[:, fade:]).reshape(n_groups, C, -1)
    return torch.cat([out_head, out_tail], dim=2), new_cur
