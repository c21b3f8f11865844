"""Near-field compensation filters (core/filters/nfc.cpp) on torch tensors
(port of ops/nfc.py).

Each ambisonic order 1..4 has a shelf-ish IIR built as bass-boost (source
distance, per-voice ``adjust(w0)``) x bass-cut (speaker/control distance,
per-device ``init(w1)``).  The per-voice coefficient math runs on the host
in numpy f32 with the reference's op order (``NfcDeviceConsts``, unchanged
from the JAX package); the per-sample recurrences run batched over voices
through the chunk-parallel 2-state filter (ops/filters.linear2_chunked),
with order 3 and 4 as two cascaded sections, in the JAX package's order.

Host layout per voice (NUM_COEFFS=14):
  [a0_1, b1_1,  a0_2, b1_2, b2_2,  a0_3, b1_3, b2_3, b3_3,
   a0_4, b1_4, b2_4, b3_4, b4_4]
State layout per voice (NUM_STATES=10): order1 z0 | order2 z0 z1 |
order3 z0 z1 z2 | order4 z0 z1 z2 z3.
"""

from __future__ import annotations

import numpy as np
import torch

from .filters import linear2_chunked

f32 = np.float32

SPEED_OF_SOUND = f32(343.3)           # core/context.h:32
NUM_COEFFS = 14
NUM_STATES = 10

_B1 = (1.0,)
_B2 = (3.0, 3.0)
_B3 = (3.6778, 6.4595, 2.3222)
_B4 = (4.2076, 11.4877, 5.7924, 9.1401)


class NfcDeviceConsts:
    """init(w1): base gains + fixed feedback coefficients (nfc.cpp:56-185)."""

    def __init__(self, w1: float) -> None:
        r = f32(0.5) * f32(w1)
        # order 1
        b00 = f32(_B1[0]) * r
        g0 = f32(1.0) + b00
        self.base1 = f32(1.0) / g0
        self.a1_1 = f32(2.0) * b00 / g0
        # order 2
        b10 = f32(_B2[0]) * r
        b11 = f32(_B2[1]) * (r * r)
        g1 = f32(1.0) + b10 + b11
        self.base2 = f32(1.0) / g1
        self.a1_2 = (f32(2.0) * b10 + f32(4.0) * b11) / g1
        self.a2_2 = f32(4.0) * b11 / g1
        # order 3 (2nd-order + 1st-order sections)
        b10 = f32(_B3[0]) * r
        b11 = f32(_B3[1]) * (r * r)
        b00 = f32(_B3[2]) * r
        g1 = f32(1.0) + b10 + b11
        g0 = f32(1.0) + b00
        self.base3 = f32(1.0) / (g1 * g0)
        self.a1_3 = (f32(2.0) * b10 + f32(4.0) * b11) / g1
        self.a2_3 = f32(4.0) * b11 / g1
        self.a3_3 = f32(2.0) * b00 / g0
        # order 4 (two 2nd-order sections)
        b10 = f32(_B4[0]) * r
        b11 = f32(_B4[1]) * (r * r)
        b00 = f32(_B4[2]) * r
        b01 = f32(_B4[3]) * (r * r)
        g1 = f32(1.0) + b10 + b11
        g0 = f32(1.0) + b00 + b01
        self.base4 = f32(1.0) / (g1 * g0)
        self.a1_4 = (f32(2.0) * b10 + f32(4.0) * b11) / g1
        self.a2_4 = f32(4.0) * b11 / g1
        self.a3_4 = (f32(2.0) * b00 + f32(4.0) * b01) / g0
        self.a4_4 = f32(4.0) * b01 / g0

    def adjust(self, w0: np.ndarray) -> np.ndarray:
        """Per-voice coefficients [V, NUM_COEFFS] (NfcFilterAdjust1..4)."""
        w0 = np.asarray(w0, f32)
        r = f32(0.5) * w0
        out = np.empty(w0.shape + (NUM_COEFFS,), f32)
        # order 1
        b00 = f32(_B1[0]) * r
        g0 = f32(1.0) + b00
        out[..., 0] = self.base1 * g0
        out[..., 1] = f32(2.0) * b00 / g0
        # order 2
        b10 = f32(_B2[0]) * r
        b11 = f32(_B2[1]) * (r * r)
        g1 = f32(1.0) + b10 + b11
        out[..., 2] = self.base2 * g1
        out[..., 3] = (f32(2.0) * b10 + f32(4.0) * b11) / g1
        out[..., 4] = f32(4.0) * b11 / g1
        # order 3
        b10 = f32(_B3[0]) * r
        b11 = f32(_B3[1]) * (r * r)
        b00 = f32(_B3[2]) * r
        g1 = f32(1.0) + b10 + b11
        g0 = f32(1.0) + b00
        out[..., 5] = self.base3 * (g1 * g0)
        out[..., 6] = (f32(2.0) * b10 + f32(4.0) * b11) / g1
        out[..., 7] = f32(4.0) * b11 / g1
        out[..., 8] = f32(2.0) * b00 / g0
        # order 4
        b10 = f32(_B4[0]) * r
        b11 = f32(_B4[1]) * (r * r)
        b00 = f32(_B4[2]) * r
        b01 = f32(_B4[3]) * (r * r)
        g1 = f32(1.0) + b10 + b11
        g0 = f32(1.0) + b00 + b01
        out[..., 9] = self.base4 * (g1 * g0)
        out[..., 10] = (f32(2.0) * b10 + f32(4.0) * b11) / g1
        out[..., 11] = f32(4.0) * b11 / g1
        out[..., 12] = (f32(2.0) * b00 + f32(4.0) * b01) / g0
        out[..., 13] = f32(4.0) * b01 / g0
        return out

    def identity_coeffs(self, n: int) -> np.ndarray:
        """Create-state coefficients (a0=1, b=a): exact passthrough."""
        out = np.empty((n, NUM_COEFFS), f32)
        out[:, 0], out[:, 1] = 1.0, self.a1_1
        out[:, 2], out[:, 3], out[:, 4] = 1.0, self.a1_2, self.a2_2
        out[:, 5:9] = [1.0, self.a1_3, self.a2_3, self.a3_3]
        out[:, 9:14] = [1.0, self.a1_4, self.a2_4, self.a3_4, self.a4_4]
        return out


def _sec2_ss(a0, a1: float, a2: float, b1, b2):
    """State space of the 2nd-order section (nfc.cpp NfcFilter2::process):
    y = a0*in - a1*z0 - a2*z1; out = y + b1*z0 + b2*z1; z1 += z0; z0 += y.
    a0, b1, b2 [V]; a1, a2 per device.  Returns (A, B, C, D)."""
    a1 = torch.full_like(a0, float(a1))
    a2 = torch.full_like(a0, float(a2))
    one, zero = torch.ones_like(a0), torch.zeros_like(a0)
    A = torch.stack([torch.stack([1.0 - a1, -a2], -1),
                     torch.stack([one, one], -1)], -2)
    B = torch.stack([a0, zero], -1)
    C = torch.stack([b1 - a1, b2 - a2], -1)
    return A, B, C, a0


def _sec1_ss(a0, a1: float, b1):
    """1st-order section padded to 2 states."""
    a1 = torch.full_like(a0, float(a1))
    zero = torch.zeros_like(a0)
    A = torch.stack([torch.stack([1.0 - a1, zero], -1),
                     torch.stack([zero, zero], -1)], -2)
    B = torch.stack([a0, zero], -1)
    C = torch.stack([b1 - a1, zero], -1)
    return A, B, C, a0


def _run_sections(sections, xs, z):
    """Batch (ss, (lo, hi), order) sections into one linear2_chunked call;
    xs [n*V, T] their stacked inputs.  Returns (ys per order, z slices)."""
    V = z.shape[0]
    A = torch.cat([s[0][0] for s in sections])
    B = torch.cat([s[0][1] for s in sections])
    C = torch.cat([s[0][2] for s in sections])
    D = torch.cat([s[0][3] for s in sections])
    zin = []
    for _, (lo, hi), _ in sections:
        zi = z[:, lo:hi]
        if hi - lo == 1:
            zi = torch.cat([zi, torch.zeros_like(zi)], 1)
        zin.append(zi)
    y, zo = linear2_chunked(xs, torch.cat(zin), A, B, C, D)
    ys, zs = {}, {}
    for i, (_, (lo, hi), order) in enumerate(sections):
        ys[order] = y[i * V:(i + 1) * V]
        zs[(lo, hi)] = zo[i * V:(i + 1) * V, :hi - lo]
    return ys, zs


def process_orders(x: torch.Tensor, z: torch.Tensor, cf: torch.Tensor,
                   consts: NfcDeviceConsts, max_order: int):
    """Filter x [V, T] through the order-1..max_order NFC filters.

    z [V, NUM_STATES]; cf [V, NUM_COEFFS].  The first sections of every
    order run as one batched call, then the second sections of orders 3
    and 4.  Returns ([x1, .., x_maxorder] each [V, T], z')."""
    V = x.shape[0]
    stage1 = []
    if max_order >= 1:
        stage1.append((_sec1_ss(cf[:, 0], consts.a1_1, cf[:, 1]), (0, 1), 1))
    if max_order >= 2:
        stage1.append((_sec2_ss(cf[:, 2], consts.a1_2, consts.a2_2,
                                cf[:, 3], cf[:, 4]), (1, 3), 2))
    if max_order >= 3:
        stage1.append((_sec2_ss(cf[:, 5], consts.a1_3, consts.a2_3,
                                cf[:, 6], cf[:, 7]), (3, 5), 3))
    if max_order >= 4:
        stage1.append((_sec2_ss(cf[:, 9], consts.a1_4, consts.a2_4,
                                cf[:, 10], cf[:, 11]), (6, 8), 4))
    ys, zs = _run_sections(stage1, x.repeat(len(stage1), 1), z)

    # Second stages: order 3 (1st-order section), order 4 (2nd-order).
    stage2 = []
    ones = torch.ones_like(cf[:, 0])
    if max_order >= 3:
        stage2.append((_sec1_ss(ones, consts.a3_3, cf[:, 8]), (5, 6), 3))
    if max_order >= 4:
        stage2.append((_sec2_ss(ones, consts.a3_4, consts.a4_4, cf[:, 12],
                                cf[:, 13]), (8, 10), 4))
    if stage2:
        ys2, zs2 = _run_sections(
            stage2, torch.cat([ys[s[2]] for s in stage2]), z)
        ys.update(ys2)
        zs.update(zs2)

    z_out = z.clone()
    for (lo, hi), val in zs.items():
        z_out[:, lo:hi] = val
    return [ys[o] for o in range(1, max_order + 1)], z_out
