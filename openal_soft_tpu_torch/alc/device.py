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


# Loopback format attributes (AL/alext.h ALC_SOFT_loopback, ALC_SOFT_HRTF,
# ALC_SOFT_loopback_bformat) and the values the renderer serves.
ALC_FREQUENCY = 0x1007
ALC_MONO_SOURCES = 0x1010
ALC_STEREO_SOURCES = 0x1011
ALC_MAX_AUXILIARY_SENDS = 0x20003
ALC_FORMAT_CHANNELS_SOFT = 0x1990
ALC_FORMAT_TYPE_SOFT = 0x1991
ALC_HRTF_SOFT = 0x1992
ALC_AMBISONIC_ORDER_SOFT = 0x199D
_ALC_CHANNELS = {0x1500: "mono", 0x1501: "stereo", 0x1503: "quad",
                 0x1504: "surround51", 0x1505: "surround61",
                 0x1506: "surround71", 0x1507: "ambi3d"}
_ALC_TYPES = {0x1400: "int8", 0x1401: "uint8", 0x1402: "int16",
              0x1404: "int32", 0x1406: "float32"}


class LoopbackDevice(RenderDevice):
    """A pull-model render device comparable against the reference loopback."""

    def __init__(self, frequency: int = 48000, channels: str = "stereo",
                 sample_type: str = "float32", *, hrtf: bool = False,
                 capacity: int = 256, num_aux_sends: int = 2,
                 ambi_order: int = 1,
                 device: str | torch.device = "cuda") -> None:
        self._open_kw = dict(frequency=frequency, channels=channels,
                             sample_type=sample_type, hrtf=hrtf,
                             capacity=capacity, num_aux_sends=num_aux_sends,
                             ambi_order=ambi_order)
        mode = panning.RenderMode.HRTF if hrtf else None
        super().__init__(frequency, _CHANNELS[channels], _TYPES[sample_type],
                         capacity=capacity, num_aux_sends=num_aux_sends,
                         render_mode=mode, ambi_order=ambi_order,
                         device=device)

    def create_context(self, attrs=None) -> Context:
        """A context; ``attrs`` (a flat ALC attribute list, as a C client
        passes it) may set the loopback format before the first context,
        as the reference's alcCreateContext does (UpdateDeviceParams,
        alc/alc.cpp:1299-1391)."""
        if attrs:
            self._apply_attrs(attrs)
        return Context(self)

    def _apply_attrs(self, attrs) -> None:
        flat = [int(v) for v in attrs]
        a = dict(zip(flat[0::2], flat[1::2]))
        kw = dict(self._open_kw)
        if a.get(ALC_FREQUENCY, 0) > 0:
            kw["frequency"] = a[ALC_FREQUENCY]
        if ALC_FORMAT_CHANNELS_SOFT in a:
            kw["channels"] = _ALC_CHANNELS[a[ALC_FORMAT_CHANNELS_SOFT]]
        if ALC_FORMAT_TYPE_SOFT in a:
            kw["sample_type"] = _ALC_TYPES[a[ALC_FORMAT_TYPE_SOFT]]
        if a.get(ALC_HRTF_SOFT, 2) in (0, 1):      # 2: ALC_DONT_CARE_SOFT
            kw["hrtf"] = bool(a[ALC_HRTF_SOFT])
        mono, stereo = a.get(ALC_MONO_SOURCES, -1), a.get(ALC_STEREO_SOURCES,
                                                          -1)
        if mono >= 0 or stereo >= 0:
            kw["capacity"] = max(max(mono, 0) + 2 * max(stereo, 0), 64)
        if a.get(ALC_MAX_AUXILIARY_SENDS, -1) >= 0:
            kw["num_aux_sends"] = min(a[ALC_MAX_AUXILIARY_SENDS], 6)
        if a.get(ALC_AMBISONIC_ORDER_SOFT, 0) > 0:
            kw["ambi_order"] = a[ALC_AMBISONIC_ORDER_SOFT]
        if kw == self._open_kw:
            return
        if self.contexts:
            raise ValueError("the loopback format is set before the first "
                             "context")
        LoopbackDevice.__init__(self, **kw, device=self.torch_device)
