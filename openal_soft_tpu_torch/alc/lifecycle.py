"""ALC playback-device lifecycle: name routing, attributes, pause/resume,
reset, reopen.

The host analog of alc/alc.cpp's device management:

  * ``open_device(name)`` — backend routing like the reference's
    BackendList priority walk (alc/alc.cpp:234-288 + alcOpenDevice :2995):
    ALSA -> null by default; the wave writer opens when configured or named
    (the reference's wave backend likewise only activates via config).
  * attribute parsing & format negotiation — the ALC_FREQUENCY /
    ALC_*_SOURCES / ALC_MAX_AUXILIARY_SENDS / ALC_OUTPUT_MODE_SOFT loop of
    UpdateDeviceParams (alc/alc.cpp:1299-1391), with config-file defaults
    (frequency / channels / sample-type keys, alsoftrc.sample).
  * ``pause()/resume()`` — alcDevicePauseSOFT/alcDeviceResumeSOFT
    (alc/alc.cpp:3522-3560): pause stops the backend thread, resume
    restarts it; resuming an unconfigured device errors.
  * ``reset(attrs)`` — alcResetDeviceSOFT/ResetDeviceParams
    (alc/alc.cpp:1922-1965): renegotiates the format and rebuilds the
    render graph while contexts, buffers, and *playing voices survive*
    (the per-context re-prepare of UpdateDeviceParams :1771-1894).
  * ``reopen(name, attrs)`` — alcReopenDeviceSOFT (alc/alc.cpp:3658):
    moves a live device to another backend, stopping first and restoring
    playback if it was playing.

State machine mirrors DeviceState (alc/device.h): Unprepared ->
Configured (context created / reset) -> Playing (backend started).

Port of openal_soft_tpu/alc/lifecycle.py.  The render device runs on the
torch device named by ``device=`` among the render keywords (``"cuda"``
unless the caller asks for ``"cpu"``); ``reset`` and ``reopen`` build the
new render device on the old one's torch device, and a migrated slot's
effect state is built anew on the new render device.
"""

from __future__ import annotations

import enum

import numpy as np

from ..core import ambidefs
from ..core import logging as log
from ..core.device import RenderDevice
from ..core.devformat import DevFmtChannels, DevFmtType
from ..core import panning
from ..effects import get_effect_factory
from .context import Context
from . import config as alconf

# ALC attribute enums (AL/alc.h, AL/alext.h)
ALC_FREQUENCY = 0x1007
ALC_REFRESH = 0x1008
ALC_SYNC = 0x1009
ALC_MONO_SOURCES = 0x1010
ALC_STEREO_SOURCES = 0x1011
ALC_MAX_AUXILIARY_SENDS = 0x20003
ALC_HRTF_SOFT = 0x1992
ALC_HRTF_ID_SOFT = 0x1996
ALC_OUTPUT_MODE_SOFT = 0x19AC
ALC_DONT_CARE_SOFT = 0x0002

_CHANNELS = {
    "mono": DevFmtChannels.MONO, "stereo": DevFmtChannels.STEREO,
    "quad": DevFmtChannels.QUAD, "surround51": DevFmtChannels.X51,
    "surround61": DevFmtChannels.X61, "surround71": DevFmtChannels.X71,
    "surround714": DevFmtChannels.X714, "surround3d71": DevFmtChannels.X3D71,
    "ambi3d": DevFmtChannels.AMBI3D,
}
_TYPES = {
    "uint8": DevFmtType.UBYTE, "int8": DevFmtType.BYTE,
    "int16": DevFmtType.SHORT, "int32": DevFmtType.INT,
    "float32": DevFmtType.FLOAT,
}

ALSA_DEVICE_NAME = "ALSA Default"
PULSE_DEVICE_NAME = "PulseAudio Default"
NULL_DEVICE_NAME = "Null Output"
WAVE_DEVICE_NAME = "Wave File Writer"


class DeviceState(enum.Enum):
    UNPREPARED = 0
    CONFIGURED = 1
    PLAYING = 2


def enumerate_devices() -> list[str]:
    """ALC_ALL_DEVICES_SPECIFIER-style playback device list."""
    from . import alsa, pulse

    names = []
    if pulse.available():
        names.append(PULSE_DEVICE_NAME)
    if alsa.available():
        names.append(ALSA_DEVICE_NAME)
    names.append(NULL_DEVICE_NAME)
    if alconf.config_value_str("wave", "file"):
        names.append(WAVE_DEVICE_NAME)
    return names


def _parse_attrs(attrs) -> dict:
    """Attribute list (flat ALC int pairs, pair list, or dict) -> dict."""
    if attrs is None:
        return {}
    if isinstance(attrs, dict):
        return dict(attrs)
    flat = list(attrs)
    if flat and isinstance(flat[0], (tuple, list)):
        pairs = [(int(k), int(v)) for k, v in flat]
    else:
        if flat and flat[-1] == 0:
            flat = flat[:-1]
        pairs = [(int(flat[i]), int(flat[i + 1]))
                 for i in range(0, len(flat) - 1, 2)]
    return dict(pairs)


class PlaybackDevice:
    """An alcOpenDevice-style playback device: a RenderDevice plus a
    backend output and lifecycle state."""

    def __init__(self, name: str | None = None, attrs=None,
                 **render_kw) -> None:
        from . import alsa

        self.name = self._route_name(name)
        self.state = DeviceState.UNPREPARED
        self.paused = False
        self.backend = None
        self._attrs: dict = _parse_attrs(attrs)
        self._render_kw = dict(render_kw)
        self.render = self._build_render()
        self._open_backend()

    @staticmethod
    def _route_name(name: str | None) -> str:
        from . import alsa, pulse

        if name in (None, ""):
            # Priority walk (BackendList, alc/alc.cpp:234-288): first
            # factory whose library/device opens wins; wave and null never
            # win the default unless configured.  PulseAudio outranks raw
            # ALSA like the reference's default order (pipewire/pulse
            # before alsa).
            drivers = alconf.config_value_str("", "drivers")
            order = ([d.strip() for d in drivers.split(",") if d.strip()]
                     if drivers else ["pulse", "alsa", "null"])
            for d in order:
                if d in ("pulse", "pulseaudio") and pulse.available():
                    return PULSE_DEVICE_NAME
                if d == "alsa" and alsa.available():
                    return ALSA_DEVICE_NAME
                if d == "null":
                    return NULL_DEVICE_NAME
                if d == "wave" and alconf.config_value_str("wave", "file"):
                    return WAVE_DEVICE_NAME
            return NULL_DEVICE_NAME
        if name in (PULSE_DEVICE_NAME, ALSA_DEVICE_NAME, NULL_DEVICE_NAME,
                    WAVE_DEVICE_NAME):
            return name
        raise ValueError(f"no audio device matching '{name}'")

    # --- format negotiation -------------------------------------------------

    def _negotiated_format(self) -> tuple[int, DevFmtChannels, DevFmtType,
                                          dict]:
        """Config defaults + attribute overrides (UpdateDeviceParams'
        attribute loop, alc/alc.cpp:1299-1391)."""
        a = self._attrs
        freq = alconf.config_value_int("", "frequency", 48000) or 48000
        if a.get(ALC_FREQUENCY, 0) > 0:
            freq = int(np.clip(a[ALC_FREQUENCY], 8000, 192000))
        ch = (alconf.config_value_str("", "channels") or "stereo").replace(
            "-", "")
        fmt_ch = _CHANNELS.get(ch, DevFmtChannels.STEREO)
        ty = alconf.config_value_str("", "sample-type") or "float32"
        fmt_ty = _TYPES.get(ty, DevFmtType.FLOAT)
        kw = dict(self._render_kw)
        mono = a.get(ALC_MONO_SOURCES, -1)
        stereo = a.get(ALC_STEREO_SOURCES, -1)
        if "capacity" not in kw and (mono >= 0 or stereo >= 0):
            kw["capacity"] = max(max(mono, 0) + 2 * max(stereo, 0), 64)
        if (sends := a.get(ALC_MAX_AUXILIARY_SENDS, -1)) >= 0:
            kw["num_aux_sends"] = min(sends, 6)
        elif (csends := alconf.config_value_int("", "sends")) is not None:
            kw.setdefault("num_aux_sends", int(np.clip(csends, 0, 6)))
        # `sources`: voice-table capacity (alc.cpp `sources` / `slots`
        # limits); rounded to the 16-row kernel grain.
        if (srcs := alconf.config_value_int("", "sources")) and srcs > 0:
            kw.setdefault("capacity", -(-int(srcs) // 16) * 16)
        hrtf = a.get(ALC_HRTF_SOFT, ALC_DONT_CARE_SOFT)
        # `stereo-mode` (speakers/headphones) + legacy `hrtf` key: on
        # headphones, unforced stereo output defaults to HRTF
        # (alc.cpp:1486-1529).
        hrtf_conf = (alconf.config_value_str("", "hrtf") or "auto").lower()
        stereo_mode = (alconf.config_value_str("", "stereo-mode")
                       or "speakers").lower()
        if hrtf == ALC_DONT_CARE_SOFT and fmt_ch == DevFmtChannels.STEREO:
            if hrtf_conf in ("true", "yes", "on", "1"):
                hrtf = 1
            elif hrtf_conf in ("false", "no", "off", "0"):
                hrtf = 0
            elif stereo_mode.startswith("headphone"):
                hrtf = 1
        if hrtf == 1 and fmt_ch == DevFmtChannels.STEREO:
            kw["render_mode"] = panning.RenderMode.HRTF
        elif hrtf == 0:
            kw.pop("render_mode", None)
        return freq, fmt_ch, fmt_ty, kw

    def _build_render(self, torch_device=None) -> RenderDevice:
        """A render device for the negotiated format, on ``torch_device``
        when given (a reset or reopen keeps the old device's), else on
        the ``device`` render keyword or RenderDevice's default."""
        freq, fmt_ch, fmt_ty, kw = self._negotiated_format()
        kw.setdefault("capacity", 256)
        if torch_device is not None:
            kw["device"] = torch_device
        return RenderDevice(freq, fmt_ch, fmt_ty, loopback=False, **kw)

    # --- backend ------------------------------------------------------------

    def _open_backend(self, announce: bool = True) -> None:
        from . import alsa
        from .backends import NullBackend, WaveBackend

        if self.name == PULSE_DEVICE_NAME:
            from . import pulse
            sink = alconf.config_value_str("pulse", "sink") or None
            self.backend = pulse.PulseBackend(self.render, sink)
        elif self.name == ALSA_DEVICE_NAME:
            pcm = alconf.config_value_str("alsa", "device") or "default"
            self.backend = alsa.AlsaBackend(self.render, pcm)
        elif self.name == WAVE_DEVICE_NAME:
            path = alconf.config_value_str("wave", "file")
            if not path:
                raise RuntimeError(
                    "wave backend needs the wave/file config key")
            self.backend = WaveBackend(self.render, path)
        else:
            self.backend = NullBackend(self.render)
        log.trace("opened playback device: %s", self.name)
        if announce:
            # Hot-plug-style added event: first open and backend changes
            # only — NOT every alcResetDeviceSOFT (the reference emits
            # device events from the backend enumeration watcher, not
            # resets; alc/events.cpp).
            from . import events as sysevents
            sysevents.emit_event(sysevents.ALC_EVENT_TYPE_DEVICE_ADDED_SOFT,
                                 sysevents.ALC_PLAYBACK_DEVICE_SOFT, self,
                                 self.name)

    # --- contexts -----------------------------------------------------------

    def create_context(self, attrs=None) -> Context:
        if attrs:
            new = _parse_attrs(attrs)
            if new != self._attrs:
                self._attrs.update(new)
                self.reset()
        ctx = Context(self.render)
        if self.state == DeviceState.UNPREPARED:
            self.state = DeviceState.CONFIGURED
        if not self.paused:
            self.start()
        return ctx

    # --- lifecycle ----------------------------------------------------------

    def start(self, period_frames: int = 1024) -> None:
        if self.state == DeviceState.PLAYING:
            return
        self.backend.start(period_frames)
        self.state = DeviceState.PLAYING

    def pause(self) -> None:
        """alcDevicePauseSOFT: stop mixing; sources keep their offsets."""
        if self.state == DeviceState.PLAYING:
            self.backend.stop()
            self.state = DeviceState.CONFIGURED
        self.paused = True

    def resume(self) -> None:
        """alcDeviceResumeSOFT: restart mixing where it left off."""
        if not self.paused:
            return
        if self.state == DeviceState.UNPREPARED:
            raise RuntimeError("cannot resume unconfigured device")
        self.paused = False
        self.start()

    def reset(self, attrs=None) -> None:
        """alcResetDeviceSOFT: renegotiate the format; voices survive."""
        if attrs:
            self._attrs.update(_parse_attrs(attrs))
        was_playing = self.state == DeviceState.PLAYING
        if was_playing:
            self.backend.stop()
            self.state = DeviceState.CONFIGURED
        if hasattr(self.backend, "close"):
            self.backend.close()
        old = self.render
        self.render = self._build_render(old.torch_device)
        _migrate_render_state(old, self.render)
        # Same backend, renegotiated format: no device added/removed events.
        self._open_backend(announce=False)
        if was_playing and not self.paused:
            self.start()

    def reopen(self, name: str | None = None, attrs=None) -> None:
        """alcReopenDeviceSOFT: move the device to another backend."""
        new_name = self._route_name(name)
        was_playing = self.state == DeviceState.PLAYING
        if was_playing:
            self.backend.stop()
            self.state = DeviceState.CONFIGURED
        if hasattr(self.backend, "close"):
            self.backend.close()
        changed = new_name != self.name
        if changed:
            from . import events as sysevents
            sysevents.emit_event(
                sysevents.ALC_EVENT_TYPE_DEVICE_REMOVED_SOFT,
                sysevents.ALC_PLAYBACK_DEVICE_SOFT, self, self.name)
        self.name = new_name
        if attrs:
            self._attrs.update(_parse_attrs(attrs))
            old = self.render
            self.render = self._build_render(old.torch_device)
            _migrate_render_state(old, self.render)
        self._open_backend(announce=changed)
        if was_playing and not self.paused:
            self.start()

    def close(self) -> None:
        if self.backend is not None:
            if hasattr(self.backend, "close"):
                self.backend.close()
            elif hasattr(self.backend, "stop"):
                self.backend.stop()
            self.backend = None
            from . import events as sysevents
            sysevents.emit_event(
                sysevents.ALC_EVENT_TYPE_DEVICE_REMOVED_SOFT,
                sysevents.ALC_PLAYBACK_DEVICE_SOFT, self, self.name)
        self.render.close()
        self.state = DeviceState.UNPREPARED


def open_device(name: str | None = None, attrs=None,
                **render_kw) -> PlaybackDevice:
    """alcOpenDevice: route ``name`` to a backend and open it."""
    return PlaybackDevice(name, attrs, **render_kw)


def _migrate_render_state(old: RenderDevice, new: RenderDevice) -> None:
    """Carry contexts/buffers/voices from ``old`` onto a fresh render device.

    The buffer pool is copied wholesale (same offsets, so every Buffer's
    pool_offset stays valid), contexts re-point at the new device, effect
    slots re-register (their DSP state re-allocates at the new rate, the
    EffectState::deviceUpdate analog), and live voices re-allocate rows and
    recompute mixing parameters against the new layout — the voice-survival
    re-prepare of UpdateDeviceParams (alc/alc.cpp:1771-1894).

    The host image of the pool is copied; the new pool uploads its own
    device copy on the first render.  Each slot's effect state is built
    anew for the new render device, so it holds the new device's rate,
    layout and torch device.
    """
    # Pool: identical offsets on the new device.
    new.pool._host = old.pool._host.copy()
    new.pool._top = old.pool._top
    new.pool._free = list(old.pool._free)
    new.pool._device = None
    new.pool._dirty = True

    for ctx in old.contexts:
        ctx.device = new
        new.contexts.append(ctx)
        for slot in list(ctx.aux_slots.values()):
            slot.device = new
            slot.wet_channels = new.wet_channels
            slot.wet_acn = ambidefs.INDEX_FROM_ACN[: new.wet_channels]
            slot.wet_scale = np.ones(new.wet_channels, np.float32)
            slot.state = get_effect_factory(slot.effect_type)(new)
            slot.index = new.register_slot(slot)
            if slot.effect_props.get("buffer") is not None:
                new.slot_effect_changed(slot, slot.effect_props["buffer"])
            slot.props_dirty = True
        for v in ctx.voices:
            if not v.rows:
                continue
            n = len(v.rows)
            v.rows = new.alloc_rows(n)
            v.props_dirty = True
            v.is_fading = False   # fresh fade-in on the new device
    old.contexts.clear()
    new.mark_config_dirty()
