"""ALC device objects (port of openal_soft_tpu/alc/device.py).

The loopback device is the deterministic render interface
(alc/alc.cpp:3393 alcLoopbackOpenDeviceSOFT + :3498 alcRenderSamplesSOFT):
no thread, the app pulls sample blocks.  ``device`` picks the torch device
the renderer runs on; it defaults to the card (``"cuda"``, which raises
without one) and never changes on its own.
"""

from __future__ import annotations

import torch

from ..core import panning
from ..core.devformat import DevFmtChannels, DevFmtType

from ..core.device import RenderDevice
from .context import Context

_CHANNELS = {
    "mono": DevFmtChannels.MONO,
    "stereo": DevFmtChannels.STEREO,
    "quad": DevFmtChannels.QUAD,
    "surround51": DevFmtChannels.X51,
    "surround61": DevFmtChannels.X61,
    "surround71": DevFmtChannels.X71,
    "surround714": DevFmtChannels.X714,
    "surround7144": DevFmtChannels.X7144,
    "surround3d71": DevFmtChannels.X3D71,
    "ambi3d": DevFmtChannels.AMBI3D,
}

_TYPES = {
    "uint8": DevFmtType.UBYTE,
    "int8": DevFmtType.BYTE,
    "int16": DevFmtType.SHORT,
    "int32": DevFmtType.INT,
    "float32": DevFmtType.FLOAT,
}


class LoopbackDevice(RenderDevice):
    """A pull-model render device comparable against the reference loopback."""

    def __init__(self, frequency: int = 48000, channels: str = "stereo",
                 sample_type: str = "float32", *, hrtf: bool = False,
                 capacity: int = 256, num_aux_sends: int = 2,
                 ambi_order: int = 1,
                 device: str | torch.device = "cuda") -> None:
        mode = panning.RenderMode.HRTF if hrtf else None
        super().__init__(frequency, _CHANNELS[channels], _TYPES[sample_type],
                         capacity=capacity, num_aux_sends=num_aux_sends,
                         render_mode=mode, ambi_order=ambi_order,
                         device=device)

    def create_context(self, attrs=None) -> Context:
        # Loopback format attributes are fixed at open time here; the
        # reference's ALC_FORMAT_* attrs map to the constructor arguments.
        return Context(self)
