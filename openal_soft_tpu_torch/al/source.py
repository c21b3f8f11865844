"""AL source objects (al/source.cpp); port of openal_soft_tpu/al/source.py,
changed only in its imports.

A source owns properties and a buffer queue; playing binds it to a voice
(StartSources, al/source.cpp:2561-2728; InitVoice :639), whose mixing
parameters are then maintained by the context update cycle.  Property writes
mark the voice's props dirty — the batched analog of the reference's
atomically-swapped VoiceProps updates.
"""

from __future__ import annotations

import dataclasses

from ..constants import MIXER_FRAC_BITS
from ..core import panning
from ..core.devformat import (AmbiLayout, AmbiScaling, FmtChannels,
                              is_ambisonic)
from ..core.voice import BufferItem, PlayState, Voice, VoiceProps
from ..ops import tables

from ..alc.context import Context, VChange, VoiceChange
from .buffer import Buffer


class SourceState:
    INITIAL = "initial"
    PLAYING = "playing"
    PAUSED = "paused"
    STOPPED = "stopped"


class Source:
    def __init__(self, sid: int, context: Context) -> None:
        self.id = sid
        self.context = context
        self.props = VoiceProps()
        self.queue: list[Buffer] = []
        self.looping = False
        self.state = SourceState.INITIAL
        self.voice: Voice | None = None
        self.offset = 0            # requested start offset in frames
        # AL_SOURCE_TYPE (al/source.cpp mSourceType): static via AL_BUFFER,
        # streaming via alSourceQueueBuffers, undetermined when empty.
        self.source_type = "undetermined"
        self._props_dirty = True

    # --- property access ---

    def set(self, name: str, value) -> None:
        setattr(self.props, name, value)
        self._props_dirty = True
        if self.voice is not None and self.voice.source_id == self.id:
            self.voice.props = dataclasses.replace(self.props)
            self.voice.props_dirty = True

    def get(self, name: str):
        return getattr(self.props, name)

    def direct_filter(self, flt) -> None:
        """AL_DIRECT_FILTER: apply an EFX filter to the direct path."""
        if flt is None:
            self.set("direct_gain", 1.0)
            self.set("direct_gain_hf", 1.0)
            self.set("direct_gain_lf", 1.0)
            return
        gain, ghf, glf = flt.gains()
        self.set("direct_gain", gain)
        self.set("direct_gain_hf", ghf)
        self.set("direct_gain_lf", glf)

    def send(self, slot, send_idx: int = 0, flt=None) -> None:
        """AL_AUXILIARY_SEND_FILTER: route this source to an effect slot."""
        sp = self.props.send[send_idx]
        sp.slot = slot
        if flt is None:
            sp.gain, sp.gain_hf, sp.gain_lf = 1.0, 1.0, 1.0
        else:
            sp.gain, sp.gain_hf, sp.gain_lf = flt.gains()
        self._props_dirty = True
        if self.voice is not None and self.voice.source_id == self.id:
            self.voice.props = dataclasses.replace(self.props)
            self.voice.props_dirty = True

    def buffer(self, buf: Buffer | None) -> None:
        """AL_BUFFER: set the static buffer (clears the queue)."""
        self.queue = [buf] if buf is not None else []
        self.source_type = "static" if buf is not None else "undetermined"

    @staticmethod
    def _buffer_item(b: Buffer) -> BufferItem:
        return BufferItem(pool_offset=b.pool_offset, sample_len=b.sample_len,
                          loop_start=b.loop_start, loop_end=b.loop_end,
                          channels=b.channels,
                          callback=(b if b.callback is not None else None),
                          plane_stride=b.plane_stride)

    def queue_buffers(self, *bufs: Buffer) -> None:
        """alSourceQueueBuffers (al/source.cpp:2748): append to the queue,
        extending the live voice's item list so a playing stream picks the
        new entries up without a replay."""
        with self.context.device.lock:
            self.queue.extend(bufs)
            self.source_type = "streaming"
            v = self.voice
            if v is not None and v.source_id == self.id:
                v.is_stream = True
                v.queue.extend(self._buffer_item(b) for b in bufs)
                if any(b.callback is not None for b in bufs):
                    self.context._cb_scan_due = True

    def buffers_processed(self) -> int:
        """AL_BUFFERS_PROCESSED (al/source.cpp:1851-1862): queue entries the
        mixer has fully consumed and not yet unqueued.  Looping sources
        report 0 (their entries are never 'done')."""
        if self.state == SourceState.INITIAL:
            return 0
        v = self.voice
        if v is not None and v.source_id == self.id \
                and self.state in (SourceState.PLAYING, SourceState.PAUSED):
            if v.looping:
                return 0
            return min(v.queue_index, len(self.queue))
        if self.state == SourceState.STOPPED:
            return len(self.queue)
        return 0

    def unqueue_buffers(self, n: int) -> list[Buffer]:
        """Pop up to n processed queue entries, rebasing the live voice's
        queue cursor (al/source.cpp alSourceUnqueueBuffers)."""
        with self.context.device.lock:
            take = min(n, self.buffers_processed())
            popped = self.queue[:take]
            del self.queue[:take]
            v = self.voice
            if v is not None and v.source_id == self.id and take:
                del v.queue[:take]
                v.queue_index = max(v.queue_index - take, 0)
            return popped

    # --- playback control ---

    def play(self) -> None:
        """alSourcePlay → StartSources (al/source.cpp:2561).

        Serialized on the device lock: concurrent plays/stops on one source
        must observe each other's voice handoff (the reference serializes
        source ops on the context property lock, al/source.cpp:2561)."""
        with self.context.device.lock:
            self._play_locked()

    def _play_locked(self) -> None:
        ctx = self.context
        dev = ctx.device
        if not self.queue or (self.queue[0].sample_len == 0
                              and self.queue[0].callback is None):
            # No audio to play; sources with an empty queue go stopped.
            # (Callback buffers start empty and fill on demand.)
            self.state = SourceState.STOPPED
            return

        old_voice = None
        if self.voice is not None and self.voice.source_id == self.id:
            old_voice = self.voice

        v = ctx.new_voice()
        v.source_id = self.id
        v.props = dataclasses.replace(self.props)
        v.looping = self.looping
        v.position = self.offset
        v.position_frac = 0
        v.state = PlayState.PENDING
        v.is_fading = False
        v.props_dirty = True

        buf0 = self.queue[0]
        v.fmt_channels = buf0.fmt_channels
        if (getattr(self, "super_stereo", False)
                and buf0.fmt_channels == FmtChannels.STEREO):
            # AL_STEREO_MODE_SOFT = AL_SUPER_STEREO_SOFT: a stereo buffer
            # plays through the Super Stereo decoder (AL_SOFT_UHJ).
            v.fmt_channels = FmtChannels.SUPER_STEREO
        v.frequency = buf0.sample_rate
        v.ambi_order = buf0.ambi_order
        v.is_ambisonic = is_ambisonic(buf0.fmt_channels)
        if v.is_ambisonic:
            # UHJ decodes to N3D/FuMa-ordered B-Format (al/source.cpp:655-656)
            is_uhj = buf0.fmt_channels in (FmtChannels.UHJ2, FmtChannels.UHJ3,
                                           FmtChannels.UHJ4,
                                           FmtChannels.SUPER_STEREO)
            v.ambi_layout = AmbiLayout.FUMA if is_uhj else buf0.ambi_layout
            v.ambi_scaling = (AmbiScaling.N3D if is_uhj
                              else buf0.ambi_scaling)
        v.queue = [self._buffer_item(b) for b in self.queue]
        v.is_stream = self.source_type == "streaming"
        v.queue_index = 0
        if (self.state == SourceState.PAUSED and old_voice is not None
                and self.offset == 0):
            # Resuming a paused source continues from the paused voice's
            # position (al/source.cpp:2643-2650) instead of frame 0.
            v.position = old_voice.position
            v.position_frac = old_voice.position_frac
            v.queue_index = min(old_voice.queue_index, len(v.queue) - 1)
            v.has_wrapped = old_voice.has_wrapped

        n_rows = self._num_rows(v, dev)
        v.rows = dev.alloc_rows(n_rows)
        dev.set_taps(tables.resampler_max_taps(self.props.resampler))

        ctx.queue_change(VoiceChange(VChange.PLAY, v, old_voice, self.id))
        self.voice = v
        self.state = SourceState.PLAYING
        ctx.sources[self.id] = self

    def _num_rows(self, v: Voice, dev) -> int:
        if v.is_ambisonic:
            return v.num_mix_channels()   # decoded B-Format lines
        hrtf = (dev.layout.mode == panning.RenderMode.HRTF
                and dev.layout.hrtf_full)
        if v.fmt_channels == FmtChannels.MONO:
            return 2 if (hrtf and self.props.panning_enabled) else 1
        return v.num_mix_channels()

    def stop(self) -> None:
        with self.context.device.lock:
            if self.voice is not None and self.voice.source_id == self.id:
                self.context.queue_change(VoiceChange(VChange.STOP, self.voice,
                                                      source_id=self.id))
            self.state = SourceState.STOPPED
            self.offset = 0

    def pause(self) -> None:
        with self.context.device.lock:
            if self.state == SourceState.PLAYING and self.voice is not None:
                self.context.queue_change(VoiceChange(VChange.PAUSE, self.voice,
                                                      source_id=self.id))
                self.state = SourceState.PAUSED

    def rewind(self) -> None:
        with self.context.device.lock:
            if self.voice is not None and self.voice.source_id == self.id:
                self.context.queue_change(VoiceChange(VChange.RESET, self.voice,
                                                      source_id=self.id))
            self.state = SourceState.INITIAL
            self.offset = 0

    def voice_ended(self) -> None:
        self.state = SourceState.STOPPED
        self.voice = None

    # --- offset queries (AL_SAMPLE_OFFSET etc.) ---

    def sample_offset(self) -> int:
        if self.voice is None or self.voice.source_id != self.id:
            return 0
        v = self.voice
        # Whole-queue offset: add the lengths of completed queue items.
        off = sum(item.sample_len for item in v.queue[:v.queue_index])
        return off + v.position

    def sec_offset(self) -> float:
        if not self.queue:
            return 0.0
        return self.sample_offset() / float(self.queue[0].sample_rate)

    # --- AL_SOFT_source_latency / device-clock queries (al/source.cpp:301) ---

    def sample_offset_latency(self) -> tuple[int, int]:
        """(offset in 32.32 fixed point, latency in nanoseconds).

        GetSourceSampleOffsetClock (al/source.cpp:301-360): the offset is
        the voice position including the fractional resample phase; the
        latency is the span between the device clock and when the next
        mixed sample will be heard.  In the pull-model loopback device that
        span is the rendered-ahead carry (zero right after a whole-block
        pull), matching the reference's loopback behavior of mix-ahead=0.
        """
        if self.voice is None or self.voice.source_id != self.id:
            return 0, 0
        v = self.voice
        off = (self.sample_offset() << 32) | (int(v.position_frac)
                                              << (32 - MIXER_FRAC_BITS))
        dev = self.context.device
        carry = dev._carry.shape[0] if dev._carry is not None else 0
        latency_ns = int(carry * 1_000_000_000 // dev.sample_rate)
        return off, latency_ns

    def sec_offset_latency(self) -> tuple[float, float]:
        """(offset seconds, latency seconds) — AL_SEC_OFFSET_LATENCY_SOFT."""
        off, lat = self.sample_offset_latency()
        rate = self.queue[0].sample_rate if self.queue else \
            self.context.device.sample_rate
        return off / 4294967296.0 / float(rate), lat / 1e9

    def sample_offset_clock(self) -> tuple[int, int]:
        """(offset 32.32, device clock ns) — AL_SAMPLE_OFFSET_CLOCK_SOFT."""
        off, _ = self.sample_offset_latency()
        return off, self.context.device.clock_ns()
