"""AL object layer (port of openal_soft_tpu/al): sources, buffers, filters."""

from .buffer import Buffer
from .source import Source

__all__ = ["Buffer", "Source"]
