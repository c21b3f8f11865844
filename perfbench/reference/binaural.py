"""The benchmark's plain reference for headphone scenes: mono looping voices
rendered through per-voice HRIRs to float32 stereo, written from OpenAL
Soft's mixer semantics (``HrtfStore::getCoeffs``, ``CalcAttnSourceParams``,
``DoHrtfMix``/``MixHrtf`` and the HRTF accumulation buffer) and from
nothing of the program.

What it renders, and refuses anything else:

- the listener at the origin in its default orientation (its transform is
  the identity), the inverse-clamped distance model at its defaults
  (reference distance 1, rolloff 1, no maximum), source gain 1, no cone,
  no radius, no filter, no send;
- voices that start together at the device's first frame, each looping a
  mono buffer at the device's rate with pitch 1: a 16.16 fixed-point step
  of exactly 1.0, so the read is a copy of the buffer from position
  ``(n * step) >> 16`` wrapped into the loop;
- an HRTF data set with one field.

Per voice, in float32 as OpenAL Soft computes it: the direction (asin of
the normalised height, atan2 of x over -z), the distance gain
``ref / (ref + rolloff * (clamp(d, ref, max) - ref))``, the four HRIRs
around the direction blended bilinearly over elevation and azimuth, and
each ear's delay, the blend of the four stored delays rounded to the
nearest whole sample.  A voice that starts on the first frame mixes
without a fade, and a static voice's later fades blend identical HRIRs,
so the output is the linear convolution

    y[e, t] = sum_v gain_v * sum_j hrir_v[j, e] * x_v[t - delay_v[e] - j]

with x_v[n] = 0 before the voice's start.  The accumulation buffer only
carries this sum across calls, so call k is frames [k N, (k + 1) N) of the
same sum, worked out from the buffers alone.  The sum runs in float64 (or,
for the control, in float32 with TF32 on) as one matrix product over the
voices per tap, in blocks of frames.

Round-off ties.  A delay is the blend rounded to a whole sample, so a
blend that lies within float32 round-off of a half sample rounds either
way, with OpenAL Soft as with any other float32 implementation (whether
``x*x + y*y + z*z`` is fused, or how ``asin`` rounds, decides it; near the
poles ``asin`` magnifies one unit in the last place of the height tens of
times).  The reference finds these voices and ears by recomputing each
delay with every component of the unit direction moved by up to
``TIE_ULPS`` units in the last place; where the delays differ, each of
them is the specification's.  ``render_compared`` takes for each such
voice and ear the delay that fits the program's output of the compared
calls best, jointly over the calls; every other delay is fixed.
"""

from __future__ import annotations

import numpy as np
import torch

from . import mhr

F32 = np.float32
FRAC_BITS = 16
STEP = 1 << FRAC_BITS       # pitch 1 at the device's rate: 1.0 in 16.16
EPS32 = np.finfo(np.float32).eps
TIE_ULPS = 2


def unit(pos: np.ndarray) -> tuple:
    """The unit direction (x, y, z) and distance, float32, of each row seen
    from a listener at the origin facing -z with +y up."""
    p = np.asarray(pos, F32)
    x, y, z = p[:, 0], p[:, 1], p[:, 2]
    dist = np.sqrt((x * x + y * y) + z * z)
    if not (dist > EPS32).all():
        raise ValueError("a voice at the listener has no direction")
    return x / dist, y / dist, z / dist, dist.astype(F32)


def angles(x, y, z) -> tuple:
    ev = np.arcsin(np.clip(y, F32(-1.0), F32(1.0)))
    az = np.arctan2(x, -z)
    return ev.astype(F32), az.astype(F32)


def direction(pos: np.ndarray) -> tuple:
    """(elevation, azimuth, distance), float32, of each [x, y, z] row."""
    x, y, z, dist = unit(pos)
    return (*angles(x, y, z), dist)


def distance_gain(dist: np.ndarray, ref: float = 1.0, rolloff: float = 1.0,
                  max_dist: float = float(np.finfo(np.float32).max)):
    """Inverse clamped distance attenuation, float32, times the default
    source and listener gains (1) within the default gain range [0, 1]."""
    ref, rolloff = F32(ref), F32(rolloff)
    clamped = np.clip(dist, ref, F32(max_dist)).astype(F32)
    d = (ref + (clamped - ref) * rolloff).astype(F32)
    return np.clip(ref / d, F32(0.0), F32(1.0)).astype(F32)


def _blend(hset: mhr.HrirSet, ev: np.ndarray, az: np.ndarray) -> tuple:
    """The four HRIRs around each direction and their bilinear weights."""
    if len(hset.field_ev_count) != 1:
        raise ValueError("the reference reads data sets of one field")
    one = F32(1.0)
    evc = int(hset.field_ev_count[0])
    e = ((F32(1.0 / np.pi) * ev + F32(0.5)) * F32(evc - 1)).astype(F32)
    e_i = np.minimum(np.maximum(e, 0).astype(np.int64), evc - 1)
    e_b = (e - e_i.astype(F32)).astype(F32)
    e_j = np.minimum(e_i + 1, evc - 1)

    def around(row):
        n = hset.az_count[row]
        a = ((F32(0.5 / np.pi) * az + one) * n.astype(F32)).astype(F32)
        i = np.maximum(a, 0).astype(np.int64)
        first = hset.ir_offset[row] + i % n
        second = hset.ir_offset[row] + (i % n + 1) % n
        return first, second, (a - i.astype(F32)).astype(F32)

    i0, i1, a_b0 = around(e_i)
    i2, i3, a_b1 = around(e_j)
    return ((i0, i1, i2, i3),
            ((one - e_b) * (one - a_b0), (one - e_b) * a_b0,
             e_b * (one - a_b1), e_b * a_b1))


def _delays(hset: mhr.HrirSet, idx: tuple, blend: tuple) -> np.ndarray:
    """Each ear's blended delay, rounded to the nearest whole sample."""
    delays = np.zeros((len(idx[0]), 2), np.int64)
    for ear in (0, 1):
        d = np.zeros(len(idx[0]), F32)
        for i, b in zip(idx, blend):
            d = (d + hset.delays[i, ear].astype(F32) * b).astype(F32)
        delays[:, ear] = np.rint(d * F32(1.0 / (1 << mhr.DELAY_FRAC_BITS)))
    return delays


def select_hrirs(hset: mhr.HrirSet, ev: np.ndarray, az: np.ndarray):
    """Blended HRIRs [V, 128, 2] float32 and whole-sample delays [V, 2] for
    each direction, from the data set's one field."""
    idx, blend = _blend(hset, ev, az)
    coeffs = np.zeros((len(ev), mhr.HRIR_LENGTH, 2), F32)
    for i, b in zip(idx, blend):
        coeffs = (hset.coeffs[i] * b[:, None, None] + coeffs).astype(F32)
    return coeffs, _delays(hset, idx, blend)


def delay_range(hset: mhr.HrirSet, pos: np.ndarray) -> tuple:
    """The least and greatest delay [V, 2] over the unit directions within
    ``TIE_ULPS`` units in the last place of each component."""
    x, y, z, _ = unit(pos)
    lo = hi = None
    steps = range(-TIE_ULPS, TIE_ULPS + 1)
    for i in steps:
        for j in steps:
            for k in steps:
                ev, az = angles(x + F32(i) * np.spacing(x),
                                y + F32(j) * np.spacing(y),
                                z + F32(k) * np.spacing(z))
                d = _delays(hset, *_blend(hset, ev, az))
                lo = d if lo is None else np.minimum(lo, d)
                hi = d if hi is None else np.maximum(hi, d)
    return lo, hi


class Binaural:
    """The reference's render of one scene.

    ``buffers``: mono float32 arrays at ``rate``; ``voice_buffer[v]``: the
    buffer voice v loops; ``positions``: [V, 3].  ``render(start, frames)``
    gives output frames [start, start + frames) as [frames, 2] float32;
    ``render_compared`` gives those of the compared calls, with each
    round-off tie resolved by the program's output.
    """

    def __init__(self, hset: mhr.HrirSet, buffers: list, voice_buffer,
                 positions, rate: int, device="cpu",
                 dtype=torch.float64, block: int = 32768) -> None:
        if hset.rate != rate:
            raise ValueError("the reference does not resample HRIRs")
        self.device, self.dtype, self.block = device, dtype, int(block)
        vb = np.asarray(voice_buffer, np.int64)
        ev, az, dist = direction(positions)
        gain = distance_gain(dist)
        coeffs, delays = select_hrirs(hset, ev, az)
        lo, hi = delay_range(hset, positions)
        self.gain, self.coeffs, self.delays = gain, coeffs, delays
        self.ir_size = hset.ir_size
        # Each tie: (voice, ear, the other delays round-off can give).
        self.ties = [(int(v), int(e), [d for d in range(lo[v, e], hi[v, e] + 1)
                                       if d != delays[v, e]])
                     for v, e in zip(*np.nonzero(lo != hi))]
        taps = int(max(delays.max(), hi.max())) + hset.ir_size
        self.taps = taps
        h = np.stack([self._filter(v, delays[v]) for v in range(len(vb))])
        self.h = torch.from_numpy(h.reshape(len(vb), 2 * taps).T.copy()).to(
            device=device, dtype=dtype)                       # [2 taps, V]
        lengths = np.array([len(b) for b in buffers], np.int64)
        starts = np.concatenate([[0], np.cumsum(lengths)[:-1]])
        pool = np.concatenate([np.asarray(b, F32) for b in buffers])
        self.pool = torch.from_numpy(pool.astype(np.float64)).to(
            device=device, dtype=dtype)
        self.base = torch.from_numpy(starts[vb]).to(device)[:, None]
        self.length = torch.from_numpy(lengths[vb]).to(device)[:, None]

    def _filter(self, v: int, delay) -> np.ndarray:
        """h[e, k] = gain_v * hrir_v[k - delay[e], e]: the delay folded into
        a filter of ``taps`` taps, float64."""
        h = np.zeros((2, self.taps), np.float64)
        for ear in (0, 1):
            h[ear, delay[ear]:delay[ear] + self.ir_size] = (
                np.float64(self.gain[v])
                * self.coeffs[v, :self.ir_size, ear].astype(np.float64))
        return h

    def samples(self, first: int, count: int, rows=slice(None)):
        """x_v[n] for n in [first, first + count): [V, count]."""
        n = torch.arange(first, first + count, device=self.device,
                         dtype=torch.int64)[None, :]
        pos = (n.clamp(min=0) * STEP) >> FRAC_BITS
        x = self.pool[self.base[rows] + pos % self.length[rows]]
        return torch.where(n >= 0, x, torch.zeros((), dtype=self.dtype,
                                                  device=self.device))

    def _render64(self, start: int, frames: int) -> np.ndarray:
        out = np.empty((frames, 2), np.float64)
        k = self.taps
        for b0 in range(0, frames, self.block):
            nb = min(self.block, frames - b0)
            x = self.samples(start + b0 - (k - 1), nb + k - 1)
            z = (self.h @ x).view(2, k, nb + k - 1)      # [ear, tap, frame]
            y = torch.zeros((2, nb), dtype=self.dtype, device=self.device)
            for t in range(k):
                y += z[:, t, k - 1 - t:k - 1 - t + nb]
            out[b0:b0 + nb] = y.T.to(torch.float64).cpu().numpy()
            del x, z, y
        return out

    def render(self, start: int, frames: int) -> np.ndarray:
        return self._render64(start, frames).astype(F32)

    def _moved(self, v: int, ear: int, delay: int, start: int,
               frames: int) -> np.ndarray:
        """What voice v adds to ``ear`` with ``delay`` in place of its
        own, less what it adds with its own: [frames], float64."""
        d = self.delays[v].copy()
        d[ear] = delay
        f = self._filter(v, d)[ear] - self._filter(v, self.delays[v])[ear]
        k = self.taps
        x = self.samples(start - (k - 1), frames + k - 1, slice(v, v + 1))[0]
        x = x.to(torch.float64)
        y = torch.zeros(frames, dtype=torch.float64, device=self.device)
        for t in np.nonzero(f)[0]:
            y += float(f[t]) * x[k - 1 - t:k - 1 - t + frames]
        return y.cpu().numpy()

    def render_compared(self, items: list) -> list:
        """``items``: [(start, frames, the program's output)].  The
        reference's output of each, every tie taking the delay whose
        output lies closest (least squares over all the items) to the
        program's."""
        outs = [self._render64(s, n) for s, n, _ in items]
        for v, ear, others in self.ties:
            resid = [np.asarray(p, np.float64)[:, ear] - o[:, ear]
                     for o, (_, _, p) in zip(outs, items)]
            best, best_cost = None, sum(float(r @ r) for r in resid)
            for d in others:
                moved = [self._moved(v, ear, d, s, n) for s, n, _ in items]
                cost = sum(float((r - m) @ (r - m))
                           for r, m in zip(resid, moved))
                if cost < best_cost:
                    best, best_cost = moved, cost
            if best is not None:
                for o, m in zip(outs, best):
                    o[:, ear] += m
        return [o.astype(F32) for o in outs]
