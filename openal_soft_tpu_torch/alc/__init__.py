"""Device/context management layer (port of openal_soft_tpu/alc)."""

from .context import Context
from .device import LoopbackDevice

__all__ = ["Context", "LoopbackDevice"]
