"""Host-side voice state.

The reference's Voice (core/voice.h:176-270) carries mixing state that the
RT mixer thread owns.  Here the analogous state is split: scalar bookkeeping
(play state, buffer queue position, format) lives on these host objects,
while all per-sample state (filter z's, HRTF history) lives in the device
state pytree, and per-block mixing parameters live in SoA rows of the
device param table (core/device.py).  A voice owns one table row per mixing
channel.
"""

from __future__ import annotations

import dataclasses
import enum

import numpy as np

from ..constants import MAX_SEND_COUNT, RESAMPLER_NAMES, Resampler
from .devformat import AmbiLayout, AmbiScaling, FmtChannels


def default_resampler() -> Resampler:
    """Process default resampler: the `resampler` config key when valid,
    else Spline (core/voice.cpp:139-178, core/voice.h:35)."""
    from ..alc import config as alconf

    name = (alconf.config_value_str("", "resampler") or "").strip().lower()
    return RESAMPLER_NAMES.get(name, Resampler.SPLINE)


class DistanceModel(enum.IntEnum):
    DISABLE = 0
    INVERSE = 1
    INVERSE_CLAMPED = 2
    LINEAR = 3
    LINEAR_CLAMPED = 4
    EXPONENT = 5
    EXPONENT_CLAMPED = 6


class SpatializeMode(enum.IntEnum):
    OFF = 0
    ON = 1
    AUTO = 2


class DirectMode(enum.IntEnum):
    OFF = 0
    DROP_MISMATCH = 1
    REMIX_MISMATCH = 2


@dataclasses.dataclass
class SendProps:
    slot: object | None = None   # EffectSlot
    gain: float = 1.0
    gain_hf: float = 1.0
    hf_reference: float = 5000.0
    gain_lf: float = 1.0
    lf_reference: float = 250.0


@dataclasses.dataclass
class VoiceProps:
    """Mirror of core/voice.h:101-158 VoiceProps with AL defaults."""
    pitch: float = 1.0
    gain: float = 1.0
    outer_gain: float = 0.0
    min_gain: float = 0.0
    max_gain: float = 1.0
    inner_angle: float = 360.0
    outer_angle: float = 360.0
    ref_distance: float = 1.0
    max_distance: float = np.finfo(np.float32).max
    rolloff_factor: float = 1.0
    position: tuple = (0.0, 0.0, 0.0)
    velocity: tuple = (0.0, 0.0, 0.0)
    direction: tuple = (0.0, 0.0, 0.0)
    orient_at: tuple = (0.0, 0.0, -1.0)
    orient_up: tuple = (0.0, 1.0, 0.0)
    head_relative: bool = False
    distance_model: DistanceModel = DistanceModel.INVERSE_CLAMPED
    resampler: Resampler = dataclasses.field(
        default_factory=lambda: default_resampler())
    direct_channels: DirectMode = DirectMode.OFF
    spatialize_mode: SpatializeMode = SpatializeMode.AUTO
    panning_enabled: bool = False

    dry_gain_hf_auto: bool = True
    wet_gain_auto: bool = True
    wet_gain_hf_auto: bool = True
    outer_gain_hf: float = 1.0

    air_absorption_factor: float = 0.0
    room_rolloff_factor: float = 0.0
    doppler_factor: float = 1.0

    stereo_pan: tuple = (np.deg2rad(30.0), np.deg2rad(-30.0))

    radius: float = 0.0
    enh_width: float = 0.46          # AL_SUPER_STEREO_WIDTH default (source.h:120)
    panning: float = 0.0

    direct_gain: float = 1.0
    direct_gain_hf: float = 1.0
    direct_hf_reference: float = 5000.0
    direct_gain_lf: float = 1.0
    direct_lf_reference: float = 250.0

    send: tuple = dataclasses.field(
        default_factory=lambda: tuple(SendProps() for _ in range(MAX_SEND_COUNT)))


class PlayState(enum.IntEnum):
    STOPPED = 0
    PLAYING = 1
    STOPPING = 2
    PENDING = 3


@dataclasses.dataclass
class BufferItem:
    """A queue entry: where the (decoded f32 planar) data sits in the pool."""
    pool_offset: int = 0        # frame 0 of channel 0
    sample_len: int = 0         # frames
    loop_start: int = 0
    loop_end: int = 0
    channels: int = 1           # buffer channel count (planar span stride)
    callback: object = None     # AL_SOFT_callback_buffer source Buffer
    plane_stride: int = 0       # pool frames between channel planes
                                # (0 = sample_len; callback segments differ)


class Voice:
    """One mixing voice: play state + queue position + table row ownership."""

    def __init__(self) -> None:
        self.props = VoiceProps()
        self.source_id = 0
        self.state = PlayState.STOPPED
        self.position = 0           # frames into current buffer item
        self.position_frac = 0
        self.queue: list[BufferItem] = []
        self.queue_index = 0        # current buffer item
        self.is_stream = False      # AL_STREAMING source (queue semantics)
        self.looping = False
        self.has_wrapped = False
        self.start_time_ns = 0

        self.fmt_channels = FmtChannels.MONO
        self.frequency = 44100
        self.ambi_layout = AmbiLayout.ACN
        self.ambi_scaling = AmbiScaling.N3D
        self.ambi_order = 0
        self.duplicate_mono = False

        self.step = 0
        self.bank_row = 0
        self.sf = np.float32(0.0)

        self.is_fading = False      # VoiceFlag::IsFading
        self.has_hrtf = False
        self.has_nfc = False
        self.is_ambisonic = False

        self.rows: list[int] = []   # param-table rows (one per mixing channel)
        self.props_dirty = True

    @property
    def is_static(self) -> bool:
        # A streaming source whose queue is momentarily one entry deep (the
        # app unqueued the rest) keeps whole-queue loop/advance semantics.
        return not self.is_stream and len(self.queue) == 1

    def current_buffer(self) -> BufferItem | None:
        if 0 <= self.queue_index < len(self.queue):
            return self.queue[self.queue_index]
        return None

    def num_mix_channels(self, panning_enabled: bool | None = None) -> int:
        """Mixing channel count (Voice::prepare, core/voice.cpp:1206-1208)."""
        from .devformat import channels_from_fmt

        if self.fmt_channels == FmtChannels.MONO:
            return 2 if self.props.panning_enabled else 1
        if self.fmt_channels in (FmtChannels.UHJ2, FmtChannels.SUPER_STEREO):
            return 3
        return channels_from_fmt(self.fmt_channels, self.ambi_order)

    def advance(self, samples_done: int) -> tuple[int, bool]:
        """End-of-block position/queue update (core/voice.cpp:1086-1155).

        Returns (buffers_completed, voice_ended).
        """
        buf = self.current_buffer()
        if buf is None:
            return 0, True
        pos = self.position + samples_done
        buffers_done = 0
        if self.is_static:
            if self.looping and buf.loop_end > buf.loop_start:
                if pos >= buf.loop_end:
                    pos = ((pos - buf.loop_start) % (buf.loop_end - buf.loop_start)
                           + buf.loop_start)
                    self.has_wrapped = True
                self.position = pos
                return 0, False
            if pos >= buf.sample_len:
                self.position = pos
                return 0, True
            self.position = pos
            return 0, False
        # Streaming queue: walk buffers.
        while buf is not None and pos >= buf.sample_len:
            pos -= buf.sample_len
            buffers_done += 1
            self.queue_index += 1
            if self.queue_index >= len(self.queue):
                if self.looping:
                    self.queue_index = 0
                else:
                    self.position = pos
                    return buffers_done, True
            buf = self.current_buffer()
        self.position = pos
        return buffers_done, False
