"""EFX effect engines (port of openal_soft_tpu/effects).

Each effect has a host half (property validation and parameter
computation, the analog of EffectState::update) and a device half on torch
tensors (EffectState::process), which returns its dry-bus contribution,
its real-output contribution or None, and its state, updated in place.
Every engine of the JAX package is registered under the same name.
"""

from .base import EffectState, effect_registry, get_effect_factory

from . import autowah  # noqa: F401  (each module registers itself)
from . import chorus  # noqa: F401
from . import compressor  # noqa: F401
from . import convolution  # noqa: F401
from . import dedicated  # noqa: F401
from . import distortion  # noqa: F401
from . import echo  # noqa: F401
from . import equalizer  # noqa: F401
from . import fshifter  # noqa: F401
from . import modulator  # noqa: F401
from . import null  # noqa: F401
from . import pshifter  # noqa: F401
from . import reverb  # noqa: F401
from . import vmorpher  # noqa: F401

__all__ = ["EffectState", "effect_registry", "get_effect_factory"]
