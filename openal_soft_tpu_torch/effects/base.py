"""Effect engine base and shared device helpers (port of effects/base.py).

Mirrors core/effects/base.h EffectState: deviceUpdate (state allocation at
the device rate), update (props -> parameters) and process (block DSP).
``process`` takes (state dict of tensors, params dict of tensors, wet
[B, T]) and returns (output contribution [n_out, T], extra real-output
contribution or None, state); the port updates the state tensors in place
where the JAX package returned new arrays.

Shared device helpers: ``effect_mix`` (the whole-block gain ramps of
MixSamples), ``DelayRing`` (a power-of-two delay line) and
``biquad_fixed`` / ``biquad_fixed4`` (fixed TDF2 sections through the
biquad kernel's wrapper).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.kernels import biquad as biq

f32 = np.float32

effect_registry: dict[str, type] = {}


def register(name: str):
    def deco(cls):
        effect_registry[name] = cls
        cls.name = name
        return cls
    return deco


def get_effect_factory(name: str):
    return effect_registry[name]


_CONSTS: dict = {}


def const(a: np.ndarray, device) -> torch.Tensor:
    """A module-level constant array on ``device``, uploaded once and
    shared read-only."""
    key = (id(a), str(device))
    t = _CONSTS.get(key)
    if t is None:
        t = _CONSTS[key] = torch.tensor(a, device=device)
    return t


class EffectState:
    """Host-side effect instance bound to a slot on a device."""

    name = "base"
    granularity = 128   # block sizes must be multiples of this
    device_params: tuple | None = None   # update() keys uploaded (None: all)

    def __init__(self, device) -> None:
        self.device = device

    def max_window(self) -> int:
        """Largest per-call process() window the state supports (the fused
        super-block path feeds whole windows when every effect allows)."""
        return 1024

    # -- host half --
    def device_update(self, buffer=None) -> dict:
        """Allocate carried device state at the device rate; returns the
        initial state dict of tensors."""
        return {}

    def update(self, slot, props) -> dict:
        """props -> params dict of numpy arrays, uploaded with the config."""
        return {}

    # -- device half --
    def process(self, state: dict, params: dict, wet: torch.Tensor, T: int):
        """wet [B, T] -> (contribution [n_out, T], real extra, state)."""
        raise NotImplementedError


def ambi_mix_params(device, gainbase: float):
    """setAmbiMixParams (core/device.h:127-147): map wet-bus ambi channels
    onto dry-bus channels by matching ACN index.

    Returns (target_index [B] int32 with -1 for unmatched,
             gains [B, n_dry] f32 one-hot rows scaled by target scale * gain).
    """
    layout = device.layout
    B = device.wet_channels
    tgt_idx = np.full(B, -1, np.int32)
    gains = np.zeros((B, device.n_dry), f32)
    for i in range(B):  # wet bus is ACN-ordered with unit scale
        matches = np.nonzero(layout.dry_acn == i)[0]
        if matches.size:
            j = int(matches[0])
            tgt_idx[i] = j
            gains[i, j] = f32(layout.dry_scale[j] * f32(gainbase))
    return tgt_idx, gains


def effect_mix(taps: torch.Tensor, cur: torch.Tensor, tgt: torch.Tensor,
               T: int, counter: int | None = None):
    """Effect-output mixing with gain ramps: MixSamples (mixer_c.cpp Mix_)
    ramps each gain linearly from cur toward tgt over ``counter`` samples,
    the whole block by default (Counter = samplesToDo, e.g.
    alc/effects/echo.cpp:157-159), then holds the target (zero below the
    silence threshold).

    taps: [K, T] effect output lines; cur/tgt: [K, C] gains.
    Returns (out [C, T], new_cur [K, C]); counter <= T lands on tgt.
    """
    counter = T if counter is None else counter
    i = torch.arange(T, dtype=torch.float32, device=taps.device)
    step = (tgt - cur) * f32(1.0 / counter)       # MixLine's delta rounding
    ramp_active = step.abs() > f32(1.1920929e-07)
    tgt_masked = torch.where(tgt.abs() > 1.0e-5, tgt, 0.0)
    ramping = ramp_active[:, :, None]
    if counter < T:
        ramping = ramping & (i < counter)
    gains = torch.where(ramping,
                        cur[:, :, None] + step[:, :, None] * i[None, None, :],
                        tgt_masked[:, :, None])
    return torch.einsum("kt,kct->ct", taps, gains), tgt


class DelayRing:
    """A power-of-two delay line as device state: ``buf`` [lines, length]
    and the write ``offset`` (an int64 scalar tensor).

    The offset advances by exactly T per block and the length is a
    multiple of T, as in the JAX package, whose reads are two-piece
    dynamic slices.  Here a read or a write is index arithmetic on the
    device, (offset - lag + i) mod length, so a lag held in a device
    tensor needs no host round trip.
    """

    @staticmethod
    def length_for(min_samples: int, T: int) -> int:
        n = T
        while n < min_samples:
            n <<= 1
        return n

    @staticmethod
    def init(length: int, lines: int, device) -> dict:
        return {"buf": torch.zeros((lines, length), dtype=torch.float32,
                                   device=device),
                "offset": torch.zeros((), dtype=torch.int64, device=device)}

    @staticmethod
    def _index(state: dict, lag, n: int) -> torch.Tensor:
        buf = state["buf"]
        i = torch.arange(n, dtype=torch.int64, device=buf.device)
        return torch.remainder(state["offset"] - lag + i, buf.shape[1])

    @staticmethod
    def read(state: dict, lag, T: int) -> torch.Tensor:
        """[lines, T]: the ring's samples from (offset - lag) on; ``lag``
        an int or an integer tensor."""
        return state["buf"][:, DelayRing._index(state, lag, T)]

    @staticmethod
    def read_window(state: dict, lookback: int, T: int) -> torch.Tensor:
        """[lines, lookback + T]: block positions [-lookback, T) relative to
        the write start (after a write: this block's samples)."""
        return state["buf"][:, DelayRing._index(state, lookback,
                                                lookback + T)]

    @staticmethod
    def write(state: dict, values: torch.Tensor, T: int) -> None:
        """Write values [lines, T] at the offset and advance it, in place."""
        state["buf"][:, DelayRing._index(state, 0, T)] = values
        state["offset"].copy_(torch.remainder(state["offset"] + T,
                                              state["buf"].shape[1]))


def _aligned(x: torch.Tensor) -> torch.Tensor:
    """x contiguous and 16-byte aligned, as the biquad kernel reads it."""
    x = x.contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


def _run_sections(x: torch.Tensor, z: torch.Tensor, cf: torch.Tensor):
    L = x.shape[0]
    cnt = torch.zeros(L, dtype=torch.int32, device=x.device)
    y, z2, _, _ = biq.biquad_dual(_aligned(x), z, cf, cf, cnt)
    return y, z2


_IDENTITY = np.array([1.0, 0.0, 0.0, 0.0, 0.0], f32)   # b = [1, 0, 0], a = 0


def biquad_fixed(x: torch.Tensor, z: torch.Tensor, coeffs: torch.Tensor):
    """One fixed TDF2 section (coeffs [5]: b0, b1, b2, a1, a2) over each
    line of x [L, T] from state z [L, 2], on the biquad kernel: the section
    and an identity section, counter 0 and target = coeffs, so nothing
    interpolates.  The identity section (its state always +-0, so started
    from zeros each call) passes its input through exactly up to the sign
    of zero.  Returns (y [L, T], z' [L, 2])."""
    L = x.shape[0]
    cf = torch.stack([coeffs.reshape(5), const(_IDENTITY, x.device)]
                     ).expand(L, 2, 5).contiguous()
    y, z2 = _run_sections(x, torch.stack([z, torch.zeros_like(z)], 1), cf)
    return y, z2[:, 0].contiguous()


def biquad_fixed4(x: torch.Tensor, z: torch.Tensor, coeffs: torch.Tensor):
    """Four fixed cascaded TDF2 sections (coeffs [4, 5]) over each line of
    x [L, T] from state z [L, 4, 2], in one kernel call.
    Returns (y [L, T], z' [L, 4, 2])."""
    L = x.shape[0]
    cf = coeffs.reshape(1, 4, 5).expand(L, 4, 5).contiguous()
    return _run_sections(x, z.contiguous(), cf)
