"""EFX effect engines (port of openal_soft_tpu/effects).

Each effect has a host half (property validation and parameter
computation, the analog of EffectState::update) and a device half on torch
tensors (EffectState::process).  This port registers ``null``,
``eaxreverb`` and ``reverb``; the other engines of the JAX package are
listed and raise NotImplementedError naming their ROADMAP item.
"""

from . import null  # noqa: F401  (each module registers itself)
from . import reverb  # noqa: F401
from .base import EffectState, effect_registry

# Engines of the JAX package not ported yet (ROADMAP A12).
UNPORTED = ("autowah", "chorus", "compressor", "convolution",
            "dedicated_dialog", "dedicated_lfe", "distortion", "echo",
            "equalizer", "flanger", "frequency_shifter", "pitch_shifter",
            "ring_modulator", "vocal_morpher")


def get_effect_factory(name: str):
    if name in UNPORTED:
        raise NotImplementedError(f"the {name} effect engine: ROADMAP A12")
    return effect_registry[name]


__all__ = ["EffectState", "effect_registry", "get_effect_factory",
           "UNPORTED"]
