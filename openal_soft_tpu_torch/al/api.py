"""AL/ALC-named function API over the object layer.

Provides the classic C-style entry points (alGenSources, alSourcei,
alSourcePlay, alcLoopbackOpenDeviceSOFT, alcRenderSamplesSOFT, ...) against
a current-context model, mirroring the export surface of al/*.cpp and
alc/alc.cpp so reference-oriented code ports line by line.  Integer object
ids map to the context's object stores; enums carry the AL numeric values.

Port of openal_soft_tpu/al/api.py with the same names and enums.  The
devices that ``alcLoopbackOpenDeviceSOFT`` and ``alcOpenDevice`` open
render on the card unless the caller passes ``device="cpu"``; without a
card they raise.  The al* entry points turn ALError, KeyError and
ValueError into AL error codes and nothing else: a failure on the card
(a RuntimeError) propagates.  ``AL_DOPPLER_FACTOR`` is defined here, so
``alGetFloat`` answers (the JAX module names it without defining it).
"""

from __future__ import annotations

import threading

import numpy as np

from ..alc.device import LoopbackDevice
from ..core.voice import DistanceModel

# --- AL enums (al/alc headers) ----------------------------------------------
AL_NONE = 0
AL_FALSE, AL_TRUE = 0, 1
AL_SOURCE_RELATIVE = 0x202
AL_CONE_INNER_ANGLE = 0x1001
AL_CONE_OUTER_ANGLE = 0x1002
AL_PITCH = 0x1003
AL_POSITION = 0x1004
AL_DIRECTION = 0x1005
AL_VELOCITY = 0x1006
AL_LOOPING = 0x1007
AL_BUFFER = 0x1009
AL_GAIN = 0x100A
AL_MIN_GAIN = 0x100D
AL_MAX_GAIN = 0x100E
AL_ORIENTATION = 0x100F
AL_SOURCE_STATE = 0x1010
AL_INITIAL, AL_PLAYING, AL_PAUSED, AL_STOPPED = 0x1011, 0x1012, 0x1013, 0x1014
AL_BUFFERS_QUEUED = 0x1015
AL_BUFFERS_PROCESSED = 0x1016
AL_REFERENCE_DISTANCE = 0x1020
AL_ROLLOFF_FACTOR = 0x1021
AL_CONE_OUTER_GAIN = 0x1022
AL_MAX_DISTANCE = 0x1023
AL_SEC_OFFSET = 0x1024
AL_SAMPLE_OFFSET = 0x1025
AL_BYTE_OFFSET = 0x1026
AL_SOURCE_TYPE = 0x1027
AL_STATIC, AL_STREAMING, AL_UNDETERMINED = 0x1028, 0x1029, 0x1030

AL_FORMAT_MONO8 = 0x1100
AL_FORMAT_MONO16 = 0x1101
AL_FORMAT_STEREO8 = 0x1102
AL_FORMAT_STEREO16 = 0x1103
AL_FORMAT_MONO_FLOAT32 = 0x10010
AL_FORMAT_STEREO_FLOAT32 = 0x10011

AL_INVERSE_DISTANCE = 0xD001
AL_INVERSE_DISTANCE_CLAMPED = 0xD002
AL_LINEAR_DISTANCE = 0xD003
AL_LINEAR_DISTANCE_CLAMPED = 0xD004
AL_EXPONENT_DISTANCE = 0xD005
AL_EXPONENT_DISTANCE_CLAMPED = 0xD006

AL_DOPPLER_FACTOR = 0xC000

AL_DIRECT_FILTER = 0x20005
AL_AUXILIARY_SEND_FILTER = 0x20006

# The full user-format zoo (al/buffer.cpp:200-280 DecomposeUserFormat;
# enum values from the public AL/al.h + AL/alext.h headers).
_FORMATS = {
    # core + float/double/law extensions
    0x1100: ("mono", "uint8"), 0x1101: ("mono", "int16"),
    0x1102: ("stereo", "uint8"), 0x1103: ("stereo", "int16"),
    0x10010: ("mono", "float32"), 0x10011: ("stereo", "float32"),
    0x10012: ("mono", "float64"), 0x10013: ("stereo", "float64"),
    0x10014: ("mono", "mulaw"), 0x10015: ("stereo", "mulaw"),
    0x10016: ("mono", "alaw"), 0x10017: ("stereo", "alaw"),
    # ADPCM (AL_EXT_IMA4 / AL_SOFT_MSADPCM)
    0x1300: ("mono", "ima4"), 0x1301: ("stereo", "ima4"),
    0x1302: ("mono", "msadpcm"), 0x1303: ("stereo", "msadpcm"),
    # multichannel (AL_EXT_MCFORMATS)
    0x1204: ("quad", "uint8"), 0x1205: ("quad", "int16"),
    0x1206: ("quad", "float32"),
    0x1207: ("rear", "uint8"), 0x1208: ("rear", "int16"),
    0x1209: ("rear", "float32"),
    0x120A: ("x51", "uint8"), 0x120B: ("x51", "int16"),
    0x120C: ("x51", "float32"),
    0x120D: ("x61", "uint8"), 0x120E: ("x61", "int16"),
    0x120F: ("x61", "float32"),
    0x1210: ("x71", "uint8"), 0x1211: ("x71", "int16"),
    0x1212: ("x71", "float32"),
    0x10021: ("quad", "mulaw"), 0x10022: ("rear", "mulaw"),
    0x10023: ("x51", "mulaw"), 0x10024: ("x61", "mulaw"),
    0x10025: ("x71", "mulaw"),
    # B-Format (AL_EXT_BFORMAT)
    0x20021: ("bformat2d", "uint8"), 0x20022: ("bformat2d", "int16"),
    0x20023: ("bformat2d", "float32"), 0x10031: ("bformat2d", "mulaw"),
    0x20031: ("bformat3d", "uint8"), 0x20032: ("bformat3d", "int16"),
    0x20033: ("bformat3d", "float32"), 0x10032: ("bformat3d", "mulaw"),
    # UHJ (AL_SOFT_UHJ / AL_SOFT_UHJ_ex)
    0x19A2: ("uhj2", "uint8"), 0x19A3: ("uhj2", "int16"),
    0x19A4: ("uhj2", "float32"),
    0x19A5: ("uhj3", "uint8"), 0x19A6: ("uhj3", "int16"),
    0x19A7: ("uhj3", "float32"),
    0x19A8: ("uhj4", "uint8"), 0x19A9: ("uhj4", "int16"),
    0x19AA: ("uhj4", "float32"),
    0x19B3: ("uhj2", "mulaw"), 0x19B4: ("uhj2", "alaw"),
    0x19B5: ("uhj2", "ima4"), 0x19B6: ("uhj2", "msadpcm"),
    0x19B7: ("uhj3", "mulaw"), 0x19B8: ("uhj3", "alaw"),
    0x19B9: ("uhj4", "mulaw"), 0x19BA: ("uhj4", "alaw"),
}

_DIST_MODELS = {
    AL_NONE: DistanceModel.DISABLE,
    AL_INVERSE_DISTANCE: DistanceModel.INVERSE,
    AL_INVERSE_DISTANCE_CLAMPED: DistanceModel.INVERSE_CLAMPED,
    AL_LINEAR_DISTANCE: DistanceModel.LINEAR,
    AL_LINEAR_DISTANCE_CLAMPED: DistanceModel.LINEAR_CLAMPED,
    AL_EXPONENT_DISTANCE: DistanceModel.EXPONENT,
    AL_EXPONENT_DISTANCE_CLAMPED: DistanceModel.EXPONENT_CLAMPED,
}

_tls = threading.local()


def _ctx():
    ctx = getattr(_tls, "context", None)
    if ctx is None:
        raise RuntimeError("no current context (alcMakeContextCurrent)")
    return ctx


# --- ALC ----------------------------------------------------------------------

def alcLoopbackOpenDeviceSOFT(frequency: int = 48000, channels: str = "stereo",
                              sample_type: str = "float32", **kw) -> LoopbackDevice:
    """A loopback device; ``device=`` picks the torch device ("cuda" by
    default)."""
    return LoopbackDevice(frequency=frequency, channels=channels,
                          sample_type=sample_type, **kw)


def alcOpenDevice(name: str | None = None, **kw):
    """alcOpenDevice (alc/alc.cpp:2995): route to a playback backend.
    ``device=`` picks the torch device ("cuda" by default)."""
    from ..alc import lifecycle
    return lifecycle.open_device(name, **kw)


def alcCloseDevice(device) -> bool:
    if hasattr(device, "close"):
        device.close()
    return True


def alcDevicePauseSOFT(device) -> None:
    """ALC_SOFT_pause_device (alc/alc.cpp:3522)."""
    device.pause()


def alcDeviceResumeSOFT(device) -> None:
    device.resume()


def alcResetDeviceSOFT(device, attrs=None) -> bool:
    """ALC_SOFT_HRTF reset (alc/alc.cpp:1922 ResetDeviceParams)."""
    device.reset(attrs)
    return True


def alcReopenDeviceSOFT(device, name: str | None = None, attrs=None) -> bool:
    """ALC_SOFT_reopen_device (alc/alc.cpp:3658)."""
    device.reopen(name, attrs)
    return True


def alcCreateContext(device, attrs=None):
    return device.create_context(attrs)


def alcMakeContextCurrent(context) -> None:
    _tls.context = context


def alcGetCurrentContext():
    return getattr(_tls, "context", None)


def alcRenderSamplesSOFT(device: LoopbackDevice, num_frames: int) -> np.ndarray:
    return device.render_samples(num_frames)


def alcCaptureOpenDevice(backend, frequency: int, fmt: int, samples: int):
    """alc.cpp:3175: a capture device over a pull-model backend.

    ``backend`` replaces the OS device name: an ArrayCaptureBackend /
    WavCaptureBackend (alc/capture.py) acting as the microphone stream."""
    from ..alc.capture import CaptureDevice

    channels, styp = _FORMATS[fmt]
    return CaptureDevice(backend, frequency, channels, styp,
                         buffer_frames=samples)


def alcCaptureCloseDevice(device) -> None:
    device.close()


def alcCaptureStart(device) -> None:
    device.start()


def alcCaptureStop(device) -> None:
    device.stop()


def alcCaptureSamples(device, samples: int) -> np.ndarray:
    return device.capture_samples(samples)


# --- buffers ------------------------------------------------------------------

def alGenBuffers(n: int = 1):
    ids = [(_ctx().create_buffer()).id for _ in range(n)]
    return ids[0] if n == 1 else ids


def alBufferData(bid: int, fmt: int, data, freq: int) -> None:
    channels, styp = _FORMATS[fmt]
    _ctx().buffers[bid].set_data(np.asarray(data), channels, styp, freq)


def alBufferCallbackSOFT(bid: int, fmt: int, freq: int, callback) -> None:
    """AL_SOFT_callback_buffer: ``callback(frames) -> samples`` streams the
    buffer on demand; a short return ends the stream (al/buffer.cpp:874)."""
    channels, styp = _FORMATS[fmt]
    _ctx().buffers[bid].set_callback(callback, channels, styp, freq)


def alBufferDataRaw(bid: int, fmt: int, data: bytes, freq: int) -> None:
    """C-ABI variant: raw little-endian sample bytes (native/alc_shim.cpp).

    The original payload is retained on the buffer so alMapBufferSOFT /
    alBufferSubDataSOFT can expose and splice it (al/buffer.cpp:900-998)."""
    channels, styp = _FORMATS[fmt]
    dtype = {"uint8": np.uint8, "int8": np.int8, "int16": np.int16,
             "int32": np.int32, "float32": np.float32,
             "float64": np.float64, "mulaw": np.uint8, "alaw": np.uint8,
             "ima4": np.uint8, "msadpcm": np.uint8}[styp]
    buf = _ctx().buffers[bid]
    buf.set_data(np.frombuffer(data, dtype), channels, styp, freq)
    if getattr(buf, "_mapped", None) is None:
        buf.orig_bytes = bytearray(data)
        buf.orig_fmt = fmt


# --- sources ------------------------------------------------------------------

def alGenSources(n: int = 1):
    ids = [(_ctx().create_source()).id for _ in range(n)]
    return ids[0] if n == 1 else ids


# Extended source property enums (AL/alext.h)
AL_SOURCE_RADIUS = 0x1031
AL_STEREO_ANGLES = 0x1030
AL_DIRECT_CHANNELS_SOFT = 0x1033
AL_SOURCE_RESAMPLER_SOFT = 0x1210
AL_SOURCE_SPATIALIZE_SOFT = 0x1214
AL_STEREO_MODE_SOFT = 0x19B0
AL_SUPER_STEREO_WIDTH_SOFT = 0x19B1
AL_AIR_ABSORPTION_FACTOR = 0x20007
AL_ROOM_ROLLOFF_FACTOR = 0x20008
AL_CONE_OUTER_GAINHF = 0x20009
AL_DIRECT_FILTER_GAINHF_AUTO = 0x2000A
AL_AUXILIARY_SEND_FILTER_GAIN_AUTO = 0x2000B
AL_AUXILIARY_SEND_FILTER_GAINHF_AUTO = 0x2000C
AL_DOPPLER_FACTOR_SRC = 0xC000
AL_PANNING_ENABLED_SOFT = 0x19EC
AL_PANNING_SOFT = 0x19ED

_SOURCE_F = {
    AL_PITCH: "pitch", AL_GAIN: "gain", AL_MIN_GAIN: "min_gain",
    AL_MAX_GAIN: "max_gain", AL_REFERENCE_DISTANCE: "ref_distance",
    AL_ROLLOFF_FACTOR: "rolloff_factor", AL_MAX_DISTANCE: "max_distance",
    AL_CONE_INNER_ANGLE: "inner_angle", AL_CONE_OUTER_ANGLE: "outer_angle",
    AL_CONE_OUTER_GAIN: "outer_gain",
    AL_SOURCE_RADIUS: "radius",
    AL_SUPER_STEREO_WIDTH_SOFT: "enh_width",
    AL_AIR_ABSORPTION_FACTOR: "air_absorption_factor",
    AL_ROOM_ROLLOFF_FACTOR: "room_rolloff_factor",
    AL_CONE_OUTER_GAINHF: "outer_gain_hf",
    AL_DOPPLER_FACTOR_SRC: "doppler_factor",
    AL_PANNING_SOFT: "panning",
}
_SOURCE_3F = {AL_POSITION: "position", AL_VELOCITY: "velocity",
              AL_DIRECTION: "direction"}
# Integer/bool properties mapping straight onto VoiceProps fields.
_SOURCE_I = {
    AL_DIRECT_FILTER_GAINHF_AUTO: "dry_gain_hf_auto",
    AL_AUXILIARY_SEND_FILTER_GAIN_AUTO: "wet_gain_auto",
    AL_AUXILIARY_SEND_FILTER_GAINHF_AUTO: "wet_gain_hf_auto",
    AL_PANNING_ENABLED_SOFT: "panning_enabled",
}


def alSourcef(sid: int, param: int, value: float) -> None:
    _ctx().sources[sid].set(_SOURCE_F[param], float(value))


def alSource3f(sid: int, param: int, x: float, y: float, z: float) -> None:
    _ctx().sources[sid].set(_SOURCE_3F[param], (float(x), float(y), float(z)))


def alSourcei(sid: int, param: int, value: int) -> None:
    ctx = _ctx()
    src = ctx.sources[sid]
    if param == AL_BUFFER:
        src.buffer(ctx.buffers[value] if value else None)
    elif param == AL_LOOPING:
        src.looping = bool(value)
    elif param == AL_SOURCE_RELATIVE:
        src.set("head_relative", bool(value))
    elif param == AL_DIRECT_FILTER:
        src.direct_filter(ctx.filters.get(value))
    elif param == AL_SAMPLE_OFFSET:
        src.offset = int(value)
    elif param in _SOURCE_I:
        src.set(_SOURCE_I[param], bool(value))
    elif param == AL_SOURCE_SPATIALIZE_SOFT:
        from ..core.voice import SpatializeMode
        src.set("spatialize_mode", {0: SpatializeMode.OFF,
                                    1: SpatializeMode.ON,
                                    2: SpatializeMode.AUTO}[value])
    elif param == AL_SOURCE_RESAMPLER_SOFT:
        from ..core.voice import Resampler
        src.set("resampler", list(Resampler)[value])
    elif param == AL_STEREO_MODE_SOFT:
        # AL_SUPER_STEREO_SOFT reinterprets a stereo buffer as Super
        # Stereo at play time (AL_SOFT_UHJ, al/source.cpp stereo-mode).
        src.super_stereo = bool(value)
    else:
        raise ValueError(f"alSourcei param {param:#x}")


def alSource3i(sid: int, param: int, v1: int, v2: int, v3: int) -> None:
    ctx = _ctx()
    if param == AL_AUXILIARY_SEND_FILTER:
        ctx.sources[sid].send(ctx.aux_slots.get(v1), v2,
                              ctx.filters.get(v3))
    else:
        raise ValueError(f"alSource3i param {param:#x}")


def alSourcePlay(sid: int) -> None:
    _ctx().sources[sid].play()


def alSourceStop(sid: int) -> None:
    _ctx().sources[sid].stop()


def alSourcePause(sid: int) -> None:
    _ctx().sources[sid].pause()


def alSourceRewind(sid: int) -> None:
    _ctx().sources[sid].rewind()


def alSourcePlayAtTimeSOFT(sid: int, start_time_ns: int) -> None:
    """AL_SOFT_source_start_delay (al/source.cpp alSourcePlayAtTimeSOFT):
    start playback when the device clock reaches start_time_ns.

    Maps onto the renderer's native leading-silence handling: the voice
    starts at a negative source position sized to the delay, so the
    mix emits exact silence until the clock target (voice.cpp:847-864)."""
    ctx = _ctx()
    src = ctx.sources[sid]
    dev = ctx.device
    delay_dev = max(0, int(start_time_ns) - dev.clock_ns()) \
        * dev.sample_rate // 1_000_000_000
    if delay_dev > 0 and src.queue:
        ratio = (src.queue[0].sample_rate * float(src.props.pitch)
                 / dev.sample_rate)
        src.offset = -int(round(delay_dev * ratio))
    src.play()
    src.offset = 0


def alSourceQueueBuffers(sid: int, buffer_ids) -> None:
    ctx = _ctx()
    ctx.sources[sid].queue_buffers(*[ctx.buffers[b] for b in buffer_ids])


def alGetSourcei(sid: int, param: int) -> int:
    from .source import SourceState

    src = _ctx().sources[sid]
    if param == AL_BUFFERS_QUEUED:
        return len(src.queue)
    if param == AL_BUFFERS_PROCESSED:
        return src.buffers_processed()
    if param == AL_SOURCE_TYPE:
        return {"static": AL_STATIC, "streaming": AL_STREAMING,
                "undetermined": AL_UNDETERMINED}[src.source_type]
    if param == AL_SOURCE_STATE:
        return {SourceState.INITIAL: AL_INITIAL, SourceState.PLAYING: AL_PLAYING,
                SourceState.PAUSED: AL_PAUSED,
                SourceState.STOPPED: AL_STOPPED}[src.state]
    if param == AL_SAMPLE_OFFSET:
        return src.sample_offset()
    if param == AL_BYTE_OFFSET:
        # Byte offset in the buffer's ORIGINAL storage format
        # (GetSampleOffset inverse, al/source.cpp:550-600): whole ADPCM
        # blocks for block codecs, frames x frame-size otherwise.
        if not src.queue:
            return 0
        from ..core.devformat import FmtType
        buf = src.queue[0]
        off = src.sample_offset()
        styp = getattr(buf, "orig_type", FmtType.FLOAT)
        align = getattr(buf, "orig_align", 1)
        if styp == FmtType.IMA4:
            blocksz = ((align - 1) // 2 + 4) * buf.channels
            return (off // align) * blocksz
        if styp == FmtType.MSADPCM:
            blocksz = ((align - 2) // 2 + 7) * buf.channels
            return (off // align) * blocksz
        nbytes = {FmtType.UBYTE: 1, FmtType.SHORT: 2,
                  FmtType.INT: 4, FmtType.FLOAT: 4, FmtType.DOUBLE: 8,
                  FmtType.MULAW: 1, FmtType.ALAW: 1}.get(styp, 4)
        return off * nbytes * buf.channels
    raise ValueError(f"alGetSourcei param {param:#x}")


# --- listener ------------------------------------------------------------------

def alListenerf(param: int, value: float) -> None:
    ctx = _ctx()
    if param == AL_GAIN:
        ctx.listener.gain = float(value)
    ctx.listener_dirty()


def alListener3f(param: int, x: float, y: float, z: float) -> None:
    ctx = _ctx()
    if param == AL_POSITION:
        ctx.listener.position = (x, y, z)
    elif param == AL_VELOCITY:
        ctx.listener.velocity = (x, y, z)
    ctx.listener_dirty()


def alListenerfv(param: int, values) -> None:
    ctx = _ctx()
    if param == AL_ORIENTATION:
        ctx.listener.orient_at = tuple(values[:3])
        ctx.listener.orient_up = tuple(values[3:6])
    elif param == AL_POSITION:
        ctx.listener.position = tuple(values[:3])
    elif param == AL_VELOCITY:
        ctx.listener.velocity = tuple(values[:3])
    ctx.listener_dirty()


def alDistanceModel(model: int) -> None:
    ctx = _ctx()
    ctx.listener.distance_model = _DIST_MODELS[model]
    ctx.listener_dirty()


def alDopplerFactor(value: float) -> None:
    ctx = _ctx()
    ctx.listener.doppler_factor = float(value)
    ctx.listener_dirty()


def alSpeedOfSound(value: float) -> None:
    ctx = _ctx()
    ctx.listener.speed_of_sound = float(value)
    ctx.listener_dirty()


# --- EFX ------------------------------------------------------------------------

def alGenEffects(n: int = 1):
    ids = [(_ctx().create_effect()).id for _ in range(n)]
    return ids[0] if n == 1 else ids


def alGenFilters(n: int = 1):
    ids = [(_ctx().create_filter()).id for _ in range(n)]
    return ids[0] if n == 1 else ids


def alGenAuxiliaryEffectSlots(n: int = 1):
    ids = [(_ctx().create_aux_slot()).id for _ in range(n)]
    return ids[0] if n == 1 else ids


# --- AL_SOFT_source_latency / ALC_SOFT_device_clock -----------------------------

AL_SAMPLE_OFFSET_LATENCY_SOFT = 0x1200
AL_SEC_OFFSET_LATENCY_SOFT = 0x1201
AL_SAMPLE_OFFSET_CLOCK_SOFT = 0x1202
AL_SEC_OFFSET_CLOCK_SOFT = 0x1203
ALC_DEVICE_CLOCK_SOFT = 0x1600
ALC_DEVICE_LATENCY_SOFT = 0x1601
ALC_DEVICE_CLOCK_LATENCY_SOFT = 0x1602


def alGetSourcei64vSOFT(sid: int, param: int):
    src = _ctx().sources[sid]
    if param == AL_SAMPLE_OFFSET_LATENCY_SOFT:
        return src.sample_offset_latency()
    if param == AL_SAMPLE_OFFSET_CLOCK_SOFT:
        return src.sample_offset_clock()
    raise ValueError(f"alGetSourcei64vSOFT param {param:#x}")


def alGetSourcedvSOFT(sid: int, param: int):
    src = _ctx().sources[sid]
    if param == AL_SEC_OFFSET_LATENCY_SOFT:
        return src.sec_offset_latency()
    if param == AL_SEC_OFFSET_CLOCK_SOFT:
        off, clk = src.sample_offset_clock()
        rate = src.queue[0].sample_rate if src.queue else \
            src.context.device.sample_rate
        return off / 4294967296.0 / float(rate), clk / 1e9
    raise ValueError(f"alGetSourcedvSOFT param {param:#x}")


def alcGetInteger64vSOFT(device, param: int):
    if param == ALC_DEVICE_CLOCK_SOFT:
        return device.clock_ns()
    if param == ALC_DEVICE_LATENCY_SOFT:
        return device.clock_latency_ns()[1]
    if param == ALC_DEVICE_CLOCK_LATENCY_SOFT:
        return device.clock_latency_ns()
    raise ValueError(f"alcGetInteger64vSOFT param {param:#x}")


# --- error model (al/error.cpp) -------------------------------------------------

from .error import (AL_INVALID_ENUM, AL_INVALID_NAME, AL_INVALID_OPERATION,
                    AL_INVALID_VALUE, AL_NO_ERROR, AL_OUT_OF_MEMORY, ALError)


def alGetError() -> int:
    """Pop the context's sticky first error (error.cpp:59-67)."""
    ctx = getattr(_tls, "context", None)
    if ctx is None:
        return AL_INVALID_OPERATION
    return ctx.get_error()


def _al_entry(fn):
    """Entry-point shield: AL never throws; errors go to alGetError.

    ALError keeps its code; unknown object ids (KeyError on the id stores)
    map to AL_INVALID_NAME; bad param enums (ValueError raises in this
    module) map to AL_INVALID_ENUM (error.cpp:70-98)."""
    import functools

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        ctx = getattr(_tls, "context", None)
        try:
            return fn(*args, **kwargs)
        except ALError as e:
            if ctx is not None:
                ctx.set_error(e.code, str(e))
        except KeyError as e:
            if ctx is not None:
                ctx.set_error(AL_INVALID_NAME, f"invalid id {e}")
        except ValueError as e:
            if ctx is not None:
                ctx.set_error(AL_INVALID_ENUM, str(e))
        return 0
    return wrapper


def _install_entry_shields() -> None:
    """Wrap every al* (not alc*) entry point in this module."""
    g = globals()
    for name, fn in list(g.items()):
        if (name.startswith("al") and not name.startswith("alc")
                and callable(fn) and fn.__module__ == __name__
                and name not in ("alGetError",)):
            g[name] = _al_entry(fn)


# --- extension queries (alc/alc.cpp:335-368, alc/context.cpp:64-109) -------------

AL_EXTENSIONS = 0xB004
AL_VERSION = 0xB002
AL_RENDERER = 0xB003
AL_VENDOR = 0xB001
ALC_EXTENSIONS = 0x1006

# The AL extensions this implementation actually provides (subset of the
# reference's list at alc/context.cpp:65-109: entries whose feature exists
# here; grown as the surface grows).
_AL_EXTENSION_LIST = (
    "EAX EAX2.0 EAX3.0 EAX4.0 EAX5.0 EAX-RAM "
    "AL_EXT_debug "
    "AL_EXT_ALAW AL_EXT_BFORMAT AL_EXT_DOUBLE AL_EXT_EXPONENT_DISTANCE "
    "AL_EXT_FLOAT32 AL_EXT_IMA4 AL_EXT_LINEAR_DISTANCE AL_EXT_MCFORMATS "
    "AL_EXT_MULAW AL_EXT_MULAW_BFORMAT AL_EXT_OFFSET "
    "AL_EXT_SOURCE_RADIUS AL_EXT_STEREO_ANGLES "
    "AL_SOFT_bformat_ex AL_SOFT_block_alignment AL_SOFT_callback_buffer "
    "AL_SOFT_deferred_updates "
    "AL_SOFT_direct_channels AL_SOFT_events AL_SOFT_gain_clamp_ex "
    "AL_SOFT_loop_points AL_SOFT_MSADPCM AL_SOFT_source_latency "
    "AL_SOFT_source_length AL_SOFT_source_resampler "
    "AL_SOFT_source_spatialize AL_SOFT_UHJ AL_SOFT_UHJ_ex"
)
_ALC_EXTENSION_LIST = (
    "ALC_ENUMERATE_ALL_EXT ALC_ENUMERATION_EXT ALC_EXT_CAPTURE "
    "ALC_EXT_DEDICATED ALC_EXT_EFX ALC_EXT_thread_local_context "
    "ALC_SOFT_HRTF ALC_SOFT_loopback ALC_SOFT_loopback_bformat "
    "ALC_SOFT_output_limiter ALC_SOFT_pause_device "
    "ALC_SOFT_reopen_device ALC_SOFT_system_events"
)


def _al_extension_list() -> str:
    """`[eax] enable` config key (alc/alc.cpp:2132): disabling EAX removes
    its extension strings and the property-set dispatch."""
    from ..alc import config as alconf

    if alconf.config_value_bool("eax", "enable", True):
        return _AL_EXTENSION_LIST
    return " ".join(s for s in _AL_EXTENSION_LIST.split()
                    if not s.startswith("EAX"))


def alGetString(param: int) -> str:
    if param == AL_EXTENSIONS:
        return _al_extension_list()
    if param == AL_VERSION:
        return "1.1 ALSOFT-TPU"
    if param == AL_RENDERER:
        return "OpenAL Soft TPU"
    if param == AL_VENDOR:
        return "openal_soft_tpu"
    raise ValueError(f"alGetString param {param:#x}")


def alIsExtensionPresent(name: str) -> bool:
    return name.upper() in (s.upper() for s in _al_extension_list().split())


def alcGetString(device, param: int) -> str:
    if param == ALC_EXTENSIONS:
        return _ALC_EXTENSION_LIST
    raise ValueError(f"alcGetString param {param:#x}")


def alcIsExtensionPresent(device, name: str) -> bool:
    return name.upper() in (s.upper() for s in _ALC_EXTENSION_LIST.split())


# --- AL_SOFT_events (al/event.cpp) ------------------------------------------------

AL_EVENT_TYPE_BUFFER_COMPLETED_SOFT = 0x19A4
AL_EVENT_TYPE_SOURCE_STATE_CHANGED_SOFT = 0x19A5
AL_EVENT_TYPE_DISCONNECTED_SOFT = 0x19A6

_EVENT_KINDS = {
    AL_EVENT_TYPE_BUFFER_COMPLETED_SOFT: "buffer_completed",
    AL_EVENT_TYPE_SOURCE_STATE_CHANGED_SOFT: "source_state",
    AL_EVENT_TYPE_DISCONNECTED_SOFT: "disconnected",
}


def alEventControlSOFT(event_types, enable: bool) -> None:
    kinds = [_EVENT_KINDS[t] for t in event_types]
    _ctx().control_events(kinds, bool(enable))


def alEventCallbackSOFT(callback) -> None:
    """callback(kind: str, object_id: int, param) on the event thread."""
    _ctx().set_event_callback(callback)


# --- AL_EXT_debug (al/debug.cpp) ----------------------------------------------

def _debug():
    from . import debug as _dbg
    return _dbg.get_debug(_ctx())


def alDebugMessageCallbackEXT(callback, user_param=None) -> None:
    st = _debug()
    with st.lock:
        st.callback = callback
        st.user_param = user_param


def alDebugMessageInsertEXT(source: int, mtype: int, mid: int, severity: int,
                            message: str) -> None:
    from . import debug as _dbg
    if source not in (_dbg.AL_DEBUG_SOURCE_APPLICATION_EXT,
                      _dbg.AL_DEBUG_SOURCE_THIRD_PARTY_EXT):
        _ctx().set_error(0xA003, "invalid debug source")  # AL_INVALID_ENUM
        return
    _debug().message(source, mtype, mid, severity, message)


def alDebugMessageControlEXT(source: int, mtype: int, severity: int,
                             ids, enable: bool) -> None:
    try:
        _debug().control(source, mtype, severity, list(ids or ()),
                         bool(enable))
    except ValueError:
        _ctx().set_error(0xA002, "invalid debug filter")  # AL_INVALID_VALUE


def alPushDebugGroupEXT(source: int, gid: int, message: str) -> None:
    from . import debug as _dbg
    try:
        _debug().push_group(source, gid, message)
    except OverflowError:
        _ctx().set_error(_dbg.AL_STACK_OVERFLOW_EXT, "debug group overflow")


def alPopDebugGroupEXT() -> None:
    from . import debug as _dbg
    try:
        _debug().pop_group()
    except IndexError:
        _ctx().set_error(_dbg.AL_STACK_UNDERFLOW_EXT, "debug group underflow")


def alGetDebugMessageLogEXT(count: int):
    """Returns a list of (source, type, id, severity, message) tuples."""
    return _debug().get_log(count)


def alObjectLabelEXT(kind: str, oid: int, label: str | None) -> None:
    _debug().set_label(kind, oid, label)


def alGetObjectLabelEXT(kind: str, oid: int) -> str:
    return _debug().get_label(kind, oid)


# --- enum-addressed EFX object surface (the C ABI's view of al/effect.cpp,
# al/filter.cpp, al/auxeffectslot.cpp; enums from AL/efx.h) --------------------

AL_EFFECT_TYPE = 0x8001
AL_FILTER_TYPE = 0x8001
AL_EFFECTSLOT_EFFECT = 0x0001
AL_EFFECTSLOT_GAIN = 0x0002
AL_EFFECTSLOT_AUXILIARY_SEND_AUTO = 0x0003

_EFFECT_TYPE_ENUMS = {
    0x0000: "null", 0x0001: "reverb", 0x0002: "chorus", 0x0003: "distortion",
    0x0004: "echo", 0x0005: "flanger", 0x0006: "frequency_shifter",
    0x0007: "vocal_morpher", 0x0008: "pitch_shifter",
    0x0009: "ring_modulator", 0x000A: "autowah", 0x000B: "compressor",
    0x000C: "equalizer", 0x8000: "eaxreverb",
    0x9000: "dedicated_lfe", 0x9001: "dedicated_dialog",
}

# Per-type param-enum -> property-name tables (AL/efx.h values).
_EFX_PARAMS = {
    "reverb": {1: "density", 2: "diffusion", 3: "gain", 4: "gain_hf",
               5: "decay_time", 6: "decay_hf_ratio", 7: "reflections_gain",
               8: "reflections_delay", 9: "late_reverb_gain",
               0x0A: "late_reverb_delay", 0x0B: "air_absorption_gain_hf",
               0x0C: "room_rolloff_factor", 0x0D: "decay_hf_limit"},
    "eaxreverb": {1: "density", 2: "diffusion", 3: "gain", 4: "gain_hf",
                  5: "gain_lf", 6: "decay_time", 7: "decay_hf_ratio",
                  8: "decay_lf_ratio", 9: "reflections_gain",
                  0x0A: "reflections_delay", 0x0B: "reflections_pan",
                  0x0C: "late_reverb_gain", 0x0D: "late_reverb_delay",
                  0x0E: "late_reverb_pan", 0x0F: "echo_time",
                  0x10: "echo_depth", 0x11: "modulation_time",
                  0x12: "modulation_depth", 0x13: "air_absorption_gain_hf",
                  0x14: "hf_reference", 0x15: "lf_reference",
                  0x16: "room_rolloff_factor", 0x17: "decay_hf_limit"},
    "chorus": {1: "waveform", 2: "phase", 3: "rate", 4: "depth",
               5: "feedback", 6: "delay"},
    "flanger": {1: "waveform", 2: "phase", 3: "rate", 4: "depth",
                5: "feedback", 6: "delay"},
    "distortion": {1: "edge", 2: "gain", 3: "lowpass_cutoff",
                   4: "eq_center", 5: "eq_bandwidth"},
    "echo": {1: "delay", 2: "lr_delay", 3: "damping", 4: "feedback",
             5: "spread"},
    "frequency_shifter": {1: "frequency", 2: "left_direction",
                          3: "right_direction"},
    "vocal_morpher": {1: "phoneme_a", 2: "phoneme_a_coarse", 3: "phoneme_b",
                      4: "phoneme_b_coarse", 5: "waveform", 6: "rate"},
    "pitch_shifter": {1: "coarse_tune", 2: "fine_tune"},
    "ring_modulator": {1: "frequency", 2: "highpass_cutoff", 3: "waveform"},
    "autowah": {1: "attack_time", 2: "release_time", 3: "resonance",
                4: "peak_gain"},
    "compressor": {1: "onoff"},
    "equalizer": {1: "low_gain", 2: "low_cutoff", 3: "mid1_gain",
                  4: "mid1_center", 5: "mid1_width", 6: "mid2_gain",
                  7: "mid2_center", 8: "mid2_width", 9: "high_gain",
                  0x0A: "high_cutoff"},
    "dedicated_lfe": {1: "gain"},
    "dedicated_dialog": {1: "gain"},
    "null": {},
}

_FILTER_TYPE_ENUMS = {0: "null", 1: "lowpass", 2: "highpass", 3: "bandpass"}
_FILTER_PARAMS = {
    "lowpass": {1: "gain", 2: "gain_hf"},
    "highpass": {1: "gain", 2: "gain_lf"},
    "bandpass": {1: "gain", 2: "gain_lf", 3: "gain_hf"},
    "null": {},
}

AL_INVALID_ENUM = 0xA002


def alEffecti(eid: int, param: int, value: int) -> None:
    eff = _ctx().effects[eid]
    if param == AL_EFFECT_TYPE:
        eff.set_type(_EFFECT_TYPE_ENUMS[value])
        return
    eff.set(_EFX_PARAMS[eff.type][param], int(value))


def alEffectf(eid: int, param: int, value: float) -> None:
    eff = _ctx().effects[eid]
    eff.set(_EFX_PARAMS[eff.type][param], float(value))


def alEffectfv(eid: int, param: int, values) -> None:
    eff = _ctx().effects[eid]
    name = _EFX_PARAMS[eff.type][param]
    vals = tuple(float(v) for v in values)
    eff.set(name, vals if len(vals) > 1 else vals[0])


def alGetEffecti(eid: int, param: int) -> int:
    eff = _ctx().effects[eid]
    if param == AL_EFFECT_TYPE:
        inv = {v: k for k, v in _EFFECT_TYPE_ENUMS.items()}
        return inv[eff.type]
    return int(eff.get(_EFX_PARAMS[eff.type][param]))


def alGetEffectf(eid: int, param: int) -> float:
    eff = _ctx().effects[eid]
    return float(eff.get(_EFX_PARAMS[eff.type][param]))


def alFilteri(fid: int, param: int, value: int) -> None:
    flt = _ctx().filters[fid]
    if param == AL_FILTER_TYPE:
        flt.set_type(_FILTER_TYPE_ENUMS[value])
        return
    flt.set(_FILTER_PARAMS[flt.type][param], int(value))


def alFilterf(fid: int, param: int, value: float) -> None:
    flt = _ctx().filters[fid]
    flt.set(_FILTER_PARAMS[flt.type][param], float(value))


def alGetFilteri(fid: int, param: int) -> int:
    flt = _ctx().filters[fid]
    if param == AL_FILTER_TYPE:
        inv = {v: k for k, v in _FILTER_TYPE_ENUMS.items()}
        return inv[flt.type]
    return int(flt.props[_FILTER_PARAMS[flt.type][param]])


def alAuxiliaryEffectSloti(slot_id: int, param: int, value: int) -> None:
    ctx = _ctx()
    slot = ctx.aux_slots[slot_id]
    if param == AL_EFFECTSLOT_EFFECT:
        slot.set_effect(ctx.effects[value] if value else None)
    elif param == AL_EFFECTSLOT_AUXILIARY_SEND_AUTO:
        slot.aux_send_auto = bool(value)
    else:
        raise ValueError(f"alAuxiliaryEffectSloti param {param:#x}")


def alAuxiliaryEffectSlotf(slot_id: int, param: int, value: float) -> None:
    slot = _ctx().aux_slots[slot_id]
    if param == AL_EFFECTSLOT_GAIN:
        slot.gain = float(value)
        slot.props_dirty = True
    else:
        raise ValueError(f"alAuxiliaryEffectSlotf param {param:#x}")


# --- object deletion + remaining getters --------------------------------------

def alDeleteSources(ids) -> None:
    ctx = _ctx()
    for sid in ([ids] if isinstance(ids, int) else ids):
        src = ctx.sources.pop(sid, None)
        if src is not None:
            src.stop()


def alDeleteBuffers(ids) -> None:
    ctx = _ctx()
    for bid in ([ids] if isinstance(ids, int) else ids):
        buf = ctx.buffers.pop(bid, None)
        if buf is not None and buf.pool_offset >= 0:
            with ctx.device.lock:
                ctx.device.pool.free(buf.pool_offset, buf._pool_size)
            buf.pool_offset = -1


def alDeleteEffects(ids) -> None:
    ctx = _ctx()
    for eid in ([ids] if isinstance(ids, int) else ids):
        ctx.effects.pop(eid, None)


def alDeleteFilters(ids) -> None:
    ctx = _ctx()
    for fid in ([ids] if isinstance(ids, int) else ids):
        ctx.filters.pop(fid, None)


def alDeleteAuxiliaryEffectSlots(ids) -> None:
    ctx = _ctx()
    for sid in ([ids] if isinstance(ids, int) else ids):
        slot = ctx.aux_slots.pop(sid, None)
        if slot is not None:
            slot.set_effect(None)


def alSourceUnqueueBuffers(sid: int, n: int = 1):
    """Pop processed queue entries (al/source.cpp alSourceUnqueueBuffers).

    Entries are removed from the source queue and the live voice's cursor
    rebased, so the standard streaming loop (query AL_BUFFERS_PROCESSED,
    unqueue, refill, requeue) round-trips the same buffer objects."""
    popped = [b.id for b in _ctx().sources[sid].unqueue_buffers(n)]
    return popped[0] if n == 1 and popped else popped


def alSourcefv(sid: int, param: int, values) -> None:
    vals = [float(v) for v in values]
    if param in _SOURCE_3F:
        alSource3f(sid, param, *vals[:3])
    else:
        alSourcef(sid, param, vals[0])


def alGetSourcef(sid: int, param: int) -> float:
    src = _ctx().sources[sid]
    if param == AL_SEC_OFFSET:
        return src.sec_offset()
    if param in _SOURCE_F:
        return float(src.get(_SOURCE_F[param]))
    raise ValueError(f"alGetSourcef param {param:#x}")


def alGetSource3f(sid: int, param: int):
    src = _ctx().sources[sid]
    if param in _SOURCE_3F:
        return tuple(float(x) for x in src.get(_SOURCE_3F[param]))
    raise ValueError(f"alGetSource3f param {param:#x}")


AL_FREQUENCY = 0x2001
AL_BITS = 0x2002
AL_CHANNELS = 0x2003
AL_SIZE = 0x2004
AL_LOOP_POINTS_SOFT = 0x2015


def alGetBufferi(bid: int, param: int) -> int:
    buf = _ctx().buffers[bid]
    if param == AL_FREQUENCY:
        return buf.sample_rate
    if param == AL_CHANNELS:
        return buf.channels
    if param == AL_BITS:
        return 32
    if param == AL_SIZE:
        return buf.sample_len * buf.channels * 4
    raise ValueError(f"alGetBufferi param {param:#x}")


def alBufferiv(bid: int, param: int, values) -> None:
    buf = _ctx().buffers[bid]
    if param == AL_LOOP_POINTS_SOFT:
        start, end = int(values[0]), int(values[1])
        if not (0 <= start < end <= buf.sample_len):
            _ctx().set_error(0xA002, "invalid loop points")
            return
        buf.loop_start, buf.loop_end = start, end
    else:
        raise ValueError(f"alBufferiv param {param:#x}")


ALC_FREQUENCY = 0x1007
ALC_MONO_SOURCES = 0x1010
ALC_STEREO_SOURCES = 0x1011
ALC_MAX_AUXILIARY_SENDS = 0x20003
ALC_ATTRIBUTES_SIZE = 0x1002
ALC_ALL_ATTRIBUTES = 0x1003
ALC_CONNECTED = 0x313


ALC_CAPTURE_SAMPLES = 0x312


def alcGetIntegerv(device, param: int):
    """Device attribute queries (alcGetIntegerv, alc/alc.cpp:2425-2570)."""
    if param == ALC_CAPTURE_SAMPLES:
        return device.available_samples()
    render = getattr(device, "render", device)
    attrs = [
        (ALC_FREQUENCY, render.sample_rate),
        (ALC_MONO_SOURCES, render.capacity),
        (ALC_STEREO_SOURCES, render.capacity // 2),
        (ALC_MAX_AUXILIARY_SENDS, render.num_aux_sends),
        (ALC_CONNECTED, int(getattr(render, "connected", True))),
    ]
    if param == ALC_ATTRIBUTES_SIZE:
        return 2 * len(attrs) + 1
    if param == ALC_ALL_ATTRIBUTES:
        flat = []
        for k, v in attrs:
            flat += [k, v]
        return flat + [0]
    for k, v in attrs:
        if param == k:
            return v
    raise ValueError(f"alcGetIntegerv param {param:#x}")


# --- EAX 2.0-5.0 compat (al/eax/) ---------------------------------------------

def EAXSet(property_set_guid: str, property_id: int, source_id: int,
           value) -> None:
    """EAXSet dispatch (al/eax/call.h:26 EaxCall)."""
    from . import eax as _eax
    _eax.eax_set(_ctx(), property_set_guid, property_id, source_id, value)


def EAXGet(property_set_guid: str, property_id: int, source_id: int):
    from . import eax as _eax
    return _eax.eax_get(_ctx(), property_set_guid, property_id, source_id)


def alEnable(capability: int) -> None:
    from . import debug as _dbg
    if capability == _dbg.AL_DEBUG_OUTPUT_EXT:
        _debug().enabled = True
    else:
        _ctx().set_error(0xA003, f"invalid capability {capability:#x}")


def alDisable(capability: int) -> None:
    from . import debug as _dbg
    if capability == _dbg.AL_DEBUG_OUTPUT_EXT:
        _debug().enabled = False
    else:
        _ctx().set_error(0xA003, f"invalid capability {capability:#x}")


def alIsEnabled(capability: int) -> bool:
    from . import debug as _dbg
    if capability == _dbg.AL_DEBUG_OUTPUT_EXT:
        return _debug().enabled
    _ctx().set_error(0xA003, f"invalid capability {capability:#x}")
    return False




# ==============================================================================
# Full get/set matrix + remaining core entry points.  The reference exports
# every f/3f/fv/i/3i/iv (+ d/i64 SOFT) permutation for sources, the listener
# and buffers, plus global state queries (al/source.cpp:1510/2086,
# al/listener.cpp, al/state.cpp); these complete the Python surface the C ABI
# (native/gen_shim.py) forwards to.

AL_METERS_PER_UNIT = 0x20004
AL_DOPPLER_VELOCITY = 0xC001
AL_SPEED_OF_SOUND_ENUM = 0xC003
AL_DISTANCE_MODEL = 0xD000
AL_GAIN_LIMIT_SOFT = 0x200E
AL_NUM_RESAMPLERS_SOFT = 0x1211
AL_DEFAULT_RESAMPLER_SOFT = 0x1212
AL_RESAMPLER_NAME_SOFT = 0x1213
AL_BYTE_LENGTH_SOFT = 0x2009
AL_SAMPLE_LENGTH_SOFT = 0x200A
AL_SEC_LENGTH_SOFT = 0x200B
AL_UNPACK_BLOCK_ALIGNMENT_SOFT = 0x200C
AL_PACK_BLOCK_ALIGNMENT_SOFT = 0x200D
AL_AMBISONIC_LAYOUT_SOFT = 0x1997
AL_AMBISONIC_SCALING_SOFT = 0x1998
AL_UNPACK_AMBISONIC_ORDER_SOFT = 0x199D
AL_FUMA_SOFT = 0x0000
AL_ACN_SOFT = 0x0001
AL_SN3D_SOFT = 0x0001
AL_N3D_SOFT = 0x0002


# --- source matrix ------------------------------------------------------------

def alSourceiv(sid: int, param: int, values) -> None:
    vals = [int(v) for v in values]
    if param == AL_AUXILIARY_SEND_FILTER:
        alSource3i(sid, param, *vals[:3])
    else:
        alSourcei(sid, param, vals[0])


def alGetSource3i(sid: int, param: int):
    if param in _SOURCE_3F:
        return tuple(int(v) for v in alGetSource3f(sid, param))
    raise ValueError(f"alGetSource3i param {param:#x}")


def alGetSourceiv(sid: int, param: int):
    if param in _SOURCE_3F:
        return list(alGetSource3i(sid, param))
    return [alGetSourcei(sid, param)]


def alGetSourcefv(sid: int, param: int):
    if param in _SOURCE_3F:
        return list(alGetSource3f(sid, param))
    return [alGetSourcef(sid, param)]


def alSourcedSOFT(sid: int, param: int, value: float) -> None:
    alSourcef(sid, param, float(value))


def alSource3dSOFT(sid: int, param: int, v1, v2, v3) -> None:
    alSource3f(sid, param, float(v1), float(v2), float(v3))


def alSourcedvSOFT(sid: int, param: int, values) -> None:
    alSourcefv(sid, param, [float(v) for v in values])


def alGetSourcedSOFT(sid: int, param: int) -> float:
    if param == AL_SEC_OFFSET:
        return float(_ctx().sources[sid].sec_offset())
    return float(alGetSourcef(sid, param))


def alGetSource3dSOFT(sid: int, param: int):
    return tuple(float(v) for v in alGetSource3f(sid, param))


def alGetSourcei64SOFT(sid: int, param: int) -> int:
    return int(alGetSourcei(sid, param))


def alGetSource3i64SOFT(sid: int, param: int):
    return alGetSource3i(sid, param)


# --- listener matrix -----------------------------------------------------------

def alListeneri(param: int, value: int) -> None:
    # No integer listener properties exist (al/listener.cpp).
    raise ValueError(f"alListeneri param {param:#x}")


def alListener3i(param: int, v1, v2, v3) -> None:
    if param in (AL_POSITION, AL_VELOCITY):
        alListener3f(param, float(v1), float(v2), float(v3))
    else:
        raise ValueError(f"alListener3i param {param:#x}")


def alListeneriv(param: int, values) -> None:
    alListenerfv(param, [float(v) for v in values])


def alGetListenerf(param: int) -> float:
    lis = _ctx().listener
    if param == AL_GAIN:
        return float(lis.gain)
    if param == AL_METERS_PER_UNIT:
        return float(getattr(lis, "meters_per_unit", 1.0))
    raise ValueError(f"alGetListenerf param {param:#x}")


def alGetListener3f(param: int):
    lis = _ctx().listener
    if param == AL_POSITION:
        return tuple(float(v) for v in lis.position)
    if param == AL_VELOCITY:
        return tuple(float(v) for v in lis.velocity)
    raise ValueError(f"alGetListener3f param {param:#x}")


def alGetListenerfv(param: int):
    lis = _ctx().listener
    if param == AL_ORIENTATION:
        return [float(v) for v in (*lis.orient_at, *lis.orient_up)]
    if param in (AL_POSITION, AL_VELOCITY):
        return list(alGetListener3f(param))
    return [alGetListenerf(param)]


def alGetListeneri(param: int) -> int:
    raise ValueError(f"alGetListeneri param {param:#x}")


def alGetListener3i(param: int):
    return tuple(int(v) for v in alGetListener3f(param))


def alGetListeneriv(param: int):
    return [int(v) for v in alGetListenerfv(param)]


# --- buffer matrix --------------------------------------------------------------

def alBufferi(bid: int, param: int, value: int) -> None:
    buf = _ctx().buffers[bid]
    if param == AL_UNPACK_BLOCK_ALIGNMENT_SOFT:
        buf.unpack_align = int(value)
    elif param == AL_PACK_BLOCK_ALIGNMENT_SOFT:
        buf.pack_align = int(value)
    elif param == AL_AMBISONIC_LAYOUT_SOFT:
        from ..core.devformat import AmbiLayout
        buf.ambi_layout = {AL_FUMA_SOFT: AmbiLayout.FUMA,
                           AL_ACN_SOFT: AmbiLayout.ACN}[value]
    elif param == AL_AMBISONIC_SCALING_SOFT:
        from ..core.devformat import AmbiScaling
        buf.ambi_scaling = {AL_FUMA_SOFT: AmbiScaling.FUMA,
                            AL_SN3D_SOFT: AmbiScaling.SN3D,
                            AL_N3D_SOFT: AmbiScaling.N3D}[value]
    elif param == AL_UNPACK_AMBISONIC_ORDER_SOFT:
        buf.unpack_ambi_order = int(value)
    else:
        raise ValueError(f"alBufferi param {param:#x}")


def alBufferf(bid: int, param: int, value: float) -> None:
    _ctx().buffers[bid]  # name check
    raise ValueError(f"alBufferf param {param:#x}")   # no float buffer props


def alBuffer3f(bid: int, param: int, v1, v2, v3) -> None:
    _ctx().buffers[bid]
    raise ValueError(f"alBuffer3f param {param:#x}")


def alBufferfv(bid: int, param: int, values) -> None:
    _ctx().buffers[bid]
    raise ValueError(f"alBufferfv param {param:#x}")


def alBuffer3i(bid: int, param: int, v1, v2, v3) -> None:
    _ctx().buffers[bid]
    raise ValueError(f"alBuffer3i param {param:#x}")


def alGetBufferf(bid: int, param: int) -> float:
    buf = _ctx().buffers[bid]
    if param == AL_SEC_LENGTH_SOFT:
        return buf.sample_len / float(buf.sample_rate) if buf.sample_rate \
            else 0.0
    raise ValueError(f"alGetBufferf param {param:#x}")


def alGetBuffer3f(bid: int, param: int):
    _ctx().buffers[bid]
    raise ValueError(f"alGetBuffer3f param {param:#x}")


def alGetBufferfv(bid: int, param: int):
    return [alGetBufferf(bid, param)]


def alGetBufferiv(bid: int, param: int):
    buf = _ctx().buffers[bid]
    if param == AL_LOOP_POINTS_SOFT:
        return [buf.loop_start, buf.loop_end]
    return [alGetBufferi(bid, param)]


def alGetBuffer3i(bid: int, param: int):
    _ctx().buffers[bid]
    raise ValueError(f"alGetBuffer3i param {param:#x}")


# --- object queries --------------------------------------------------------------

def alIsBuffer(bid: int) -> bool:
    return bid == 0 or bid in _ctx().buffers


def alIsSource(sid: int) -> bool:
    return sid in _ctx().sources


def alIsEffect(eid: int) -> bool:
    return eid == 0 or eid in _ctx().effects


def alIsFilter(fid: int) -> bool:
    return fid == 0 or fid in _ctx().filters


def alIsAuxiliaryEffectSlot(slot_id: int) -> bool:
    return slot_id in _ctx().aux_slots


# --- global state queries (al/state.cpp) ------------------------------------------

def alGetFloat(param: int) -> float:
    lis = _ctx().listener
    if param == AL_DOPPLER_FACTOR:
        return float(lis.doppler_factor)
    if param == AL_DOPPLER_VELOCITY:
        return float(lis.doppler_velocity)
    if param == AL_SPEED_OF_SOUND_ENUM:
        return float(lis.speed_of_sound)
    if param == AL_GAIN_LIMIT_SOFT:
        return 16.0   # GainMixMax (AL_SOFT_gain_clamp_ex, al/state.cpp)
    raise ValueError(f"alGetFloat param {param:#x}")


def alGetInteger(param: int) -> int:
    from ..core.voice import Resampler
    if param == AL_DISTANCE_MODEL:
        inv = {v: k for k, v in _DIST_MODELS.items()}
        return inv[_ctx().listener.distance_model]
    if param == AL_NUM_RESAMPLERS_SOFT:
        return len(Resampler)
    if param == AL_DEFAULT_RESAMPLER_SOFT:
        return list(Resampler).index(Resampler.GAUSSIAN)
    return int(alGetFloat(param))


def alGetDouble(param: int) -> float:
    return float(alGetFloat(param))


def alGetBoolean(param: int) -> bool:
    return bool(alGetInteger(param))


def alGetFloatv(param: int):
    return [alGetFloat(param)]


def alGetIntegerv(param: int):
    return [alGetInteger(param)]


def alGetDoublev(param: int):
    return [alGetDouble(param)]


def alGetBooleanv(param: int):
    return [alGetBoolean(param)]


def alDopplerVelocity(value: float) -> None:
    """Legacy AL 1.0 doppler velocity: multiplies the speed of sound
    (al/state.cpp; CalcContextParams applies the product)."""
    if value < 0.0:
        raise ValueError("doppler velocity must be non-negative")
    ctx = _ctx()
    ctx.listener.doppler_velocity = float(value)
    ctx.listener_dirty()


def alGetStringiSOFT(param: int, index: int) -> str:
    from ..core.voice import Resampler
    if param == AL_RESAMPLER_NAME_SOFT:
        names = {"point": "Nearest", "linear": "Linear", "cubic": "Cubic",
                 "gaussian": "4-point Gaussian", "bsinc12": "11th order Sinc",
                 "fast_bsinc12": "11th order Sinc (fast)",
                 "bsinc24": "23rd order Sinc",
                 "fast_bsinc24": "23rd order Sinc (fast)",
                 "bsinc48": "47th order Sinc",
                 "fast_bsinc48": "47th order Sinc (fast)",
                 "spline": "Cubic Spline"}
        rs = list(Resampler)[index]
        return names.get(rs.name.lower(), rs.name.lower())
    raise ValueError(f"alGetStringiSOFT param {param:#x}")


def alGetEnumValue(name: str) -> int:
    v = globals().get(name)
    return int(v) if isinstance(v, int) else 0


def alcGetEnumValue(device, name: str) -> int:
    v = globals().get(name)
    return int(v) if isinstance(v, int) else 0


# --- EFX matrix completion ---------------------------------------------------------

def alEffectiv(eid: int, param: int, values) -> None:
    alEffecti(eid, param, int(values[0]))


def alGetEffectfv(eid: int, param: int):
    eff = _ctx().effects[eid]
    v = eff.get(_EFX_PARAMS[eff.type][param])
    return [float(x) for x in v] if isinstance(v, (tuple, list)) \
        else [float(v)]


def alGetEffectiv(eid: int, param: int):
    return [alGetEffecti(eid, param)]


def alFilteriv(fid: int, param: int, values) -> None:
    alFilteri(fid, param, int(values[0]))


def alFilterfv(fid: int, param: int, values) -> None:
    alFilterf(fid, param, float(values[0]))


def alGetFilterf(fid: int, param: int) -> float:
    flt = _ctx().filters[fid]
    return float(flt.props[_FILTER_PARAMS[flt.type][param]])


def alGetFilteriv(fid: int, param: int):
    return [alGetFilteri(fid, param)]


def alGetFilterfv(fid: int, param: int):
    return [alGetFilterf(fid, param)]


def alAuxiliaryEffectSlotiv(slot_id: int, param: int, values) -> None:
    alAuxiliaryEffectSloti(slot_id, param, int(values[0]))


def alAuxiliaryEffectSlotfv(slot_id: int, param: int, values) -> None:
    alAuxiliaryEffectSlotf(slot_id, param, float(values[0]))


def alGetAuxiliaryEffectSloti(slot_id: int, param: int) -> int:
    slot = _ctx().aux_slots[slot_id]
    if param == AL_EFFECTSLOT_EFFECT:
        return slot.effect.id if getattr(slot, "effect", None) else 0
    if param == AL_EFFECTSLOT_AUXILIARY_SEND_AUTO:
        return int(getattr(slot, "aux_send_auto", True))
    raise ValueError(f"alGetAuxiliaryEffectSloti param {param:#x}")


def alGetAuxiliaryEffectSlotf(slot_id: int, param: int) -> float:
    slot = _ctx().aux_slots[slot_id]
    if param == AL_EFFECTSLOT_GAIN:
        return float(slot.gain)
    raise ValueError(f"alGetAuxiliaryEffectSlotf param {param:#x}")


def alGetAuxiliaryEffectSlotiv(slot_id: int, param: int):
    return [alGetAuxiliaryEffectSloti(slot_id, param)]


def alGetAuxiliaryEffectSlotfv(slot_id: int, param: int):
    return [alGetAuxiliaryEffectSlotf(slot_id, param)]


# --- deferred updates (AL_SOFT_deferred_updates) -------------------------------------

def alDeferUpdatesSOFT() -> None:
    _ctx().deferred = True


def alProcessUpdatesSOFT() -> None:
    ctx = _ctx()
    ctx.deferred = False
    ctx.process_updates()


def alIsDeferredSOFT() -> bool:
    return bool(_ctx().deferred)


# --- AL_SOFT_direct_context: explicit-context trampoline -----------------------------
# The reference's *Direct entry points (al/direct_defs.h) take the context
# as the first argument instead of reading the thread-local; the C shim
# forwards every Direct variant through here.

def alDirectCall(name: str, context, *args):
    prev = getattr(_tls, "context", None)
    _tls.context = context
    try:
        return globals()[name](*args)
    finally:
        _tls.context = prev


# --- AL_SOFT_map_buffer / AL_SOFT_buffer_sub_data (al/buffer.cpp:900-998) -----

def alBufferDataStoreOrig(bid: int, fmt: int, data: bytes) -> None:
    buf = _ctx().buffers[bid]
    buf.orig_bytes = bytearray(data)
    buf.orig_fmt = fmt


def alBufferSubDataRawSOFT(bid: int, fmt: int, data: bytes,
                           offset: int) -> None:
    """Splice a byte range of the original-format payload and re-decode
    (alBufferSubDataSOFT, al/buffer.cpp:930-998).  The format must match
    the stored data's."""
    buf = _ctx().buffers[bid]
    orig = getattr(buf, "orig_bytes", None)
    if orig is None or getattr(buf, "orig_fmt", None) != fmt:
        raise ValueError("alBufferSubDataSOFT: format mismatch or no data")
    if offset < 0 or offset + len(data) > len(orig):
        from .error import ALError, AL_INVALID_VALUE
        raise ALError(AL_INVALID_VALUE, "subdata range out of bounds")
    orig[offset:offset + len(data)] = data
    alBufferDataRaw(bid, fmt, bytes(orig), buf.sample_rate)


def alMapBufferSOFT(bid: int, offset: int = 0, length: int = -1):
    """Return a writable view of the original byte payload.  The mapping is
    pinned on the buffer object so the C pointer stays valid until
    alUnmapBufferSOFT re-decodes it."""
    buf = _ctx().buffers[bid]
    orig = getattr(buf, "orig_bytes", None)
    if orig is None:
        from .error import ALError, AL_INVALID_OPERATION
        raise ALError(AL_INVALID_OPERATION, "buffer has no mappable data")
    buf._mapped = orig          # pin
    return memoryview(orig)[offset:offset + length if length >= 0 else None]


def alUnmapBufferSOFT(bid: int) -> None:
    buf = _ctx().buffers[bid]
    if getattr(buf, "_mapped", None) is not None:
        alBufferDataRaw(bid, buf.orig_fmt, bytes(buf.orig_bytes),
                        buf.sample_rate)
        buf._mapped = None


def alFlushMappedBufferSOFT(bid: int, offset: int = 0,
                            length: int = -1) -> None:
    buf = _ctx().buffers[bid]
    if getattr(buf, "orig_bytes", None) is not None:
        alBufferDataRaw(bid, buf.orig_fmt, bytes(buf.orig_bytes),
                        buf.sample_rate)


# --- X-RAM (al/eax/x_ram.h): storage-mode bookkeeping stubs -------------------

AL_STORAGE_AUTOMATIC = 0x1552
AL_STORAGE_HARDWARE = 0x1553
AL_STORAGE_ACCESSIBLE = 0x1554


def alEAXSetBufferMode(buffer_ids, value: int) -> bool:
    ctx = _ctx()
    if value not in (AL_STORAGE_AUTOMATIC, AL_STORAGE_HARDWARE,
                     AL_STORAGE_ACCESSIBLE):
        raise ValueError(f"invalid X-RAM storage mode {value:#x}")
    for bid in ([buffer_ids] if isinstance(buffer_ids, int) else buffer_ids):
        ctx.buffers[bid].x_ram_mode = value
    return True


def alEAXGetBufferMode(bid: int) -> int:
    return getattr(_ctx().buffers[bid], "x_ram_mode", AL_STORAGE_AUTOMATIC)


# --- EAX raw (C ABI) entry points ------------------------------------------------

def EAXSetRaw(guid: str, pid: int, source_id: int, raw: bytes) -> int:
    from .eax import eax_set_raw
    return eax_set_raw(_ctx(), guid, pid, source_id, raw)


def EAXGetRaw(guid: str, pid: int, source_id: int, size: int):
    from .eax import eax_get_raw
    return eax_get_raw(_ctx(), guid, pid, source_id, size)


# --- capture by device name (C ABI alcCaptureOpenDevice) -------------------------

def alcCaptureOpenDeviceByName(name: str, frequency: int, fmt: int,
                               samples: int):
    """alcCaptureOpenDevice with an OS device name (alc/alc.cpp:3175):
    routes to the ALSA record backend when available, else a silent
    synthetic stream (so capture-structured apps still run)."""
    from ..alc import capture as cap

    channels, styp = _FORMATS[fmt]
    backend = cap.open_capture_backend(name, frequency, channels, samples)
    return cap.CaptureDevice(backend, frequency, channels, styp,
                             buffer_frames=samples)


def alcCaptureSamplesRaw(device, samples: int) -> bytes:
    """Capture read returning interleaved bytes in the capture format."""
    arr = device.capture_samples(samples)
    return np.ascontiguousarray(arr).tobytes()


# --- 64-bit source setters (al/source.cpp:301-480) ----------------------------
# The reference's i64 setters share the int property tables with 64-bit
# range checks; Python ints are unbounded so these are direct forwards.

def alSourcei64SOFT(sid: int, param: int, value: int) -> None:
    alSourcei(sid, param, int(value))


def alSource3i64SOFT(sid: int, param: int, v1, v2, v3) -> None:
    alSource3i(sid, param, int(v1), int(v2), int(v3))


def alSourcei64vSOFT(sid: int, param: int, values) -> None:
    alSourceiv(sid, param, [int(v) for v in values])


# --- ALC_SOFT_HRTF string index (alc/alc.cpp alcGetStringiSOFT) ---------------

ALC_NUM_HRTF_SPECIFIERS_SOFT = 0x1994
ALC_HRTF_SPECIFIER_SOFT = 0x1995


def alcGetStringiSOFT(device, param: int, index: int) -> str:
    if param == ALC_HRTF_SPECIFIER_SOFT:
        from ..core import hrtf as hrtf_mod
        names = [n for n, _ in hrtf_mod.enumerate_hrtf()]
        if 0 <= index < len(names):
            return names[index]
        from .error import ALError, AL_INVALID_VALUE
        raise ALError(AL_INVALID_VALUE, "HRTF specifier index out of range")
    raise ValueError(f"alcGetStringiSOFT param {param:#x}")


# --- AL_SOFT_buffer_storage / Apple static data -------------------------------

def alBufferStorageSOFT(bid: int, fmt: int, data: bytes, freq: int,
                        flags: int) -> None:
    """alBufferData with storage flags (al/buffer.cpp alBufferStorageSOFT).
    The map flags are bookkept for alMapBufferSOFT access checks; the
    payload decodes like alBufferData."""
    alBufferDataRaw(bid, fmt, data, freq)
    _ctx().buffers[bid].storage_flags = flags


def alBufferDataStatic(bid: int, fmt: int, data: bytes, freq: int) -> None:
    """AL_EXT_STATIC_BUFFER: the reference adopts the app's memory without
    copying; the render device's pool always keeps its own copy, so
    static and copied storage are indistinguishable here."""
    alBufferDataRaw(bid, fmt, data, freq)


# --- ALC_SOFT_system_events (alc/events.py; resolved via this module by the
# C ABI shim, native/alc_shim.cpp) ---------------------------------------------

from ..alc.events import (alcEventCallbackSOFT,   # noqa: E402,F401
                          alcEventControlSOFT, alcEventIsSupportedSOFT)

_install_entry_shields()
