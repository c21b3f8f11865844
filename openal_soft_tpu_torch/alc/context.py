"""The rendering context: voices, listener, and the per-block update cycle.

Port of openal_soft_tpu/alc/context.py.  The context is host code; it
differs from the reference only in its imports (the port's own copies of
the host modules and its al/, core/ and effects/ objects).

Host analog of ContextBase + the parameter-update half of ProcessContexts
(alc/alu.cpp:2147-2168): voice changes drain at block boundaries, dirty
voice/listener properties recompute mixing parameters, and the results are
written into the device's SoA param table.  After each block the context
mirrors the deterministic state evolution (gain ramps complete, filter
coefficients advance, positions update) so no device→host readback is
needed between blocks.
"""

from __future__ import annotations

import dataclasses
import enum

import numpy as np

from ..constants import GAIN_FADE_SAMPLES, MIXER_FRAC_BITS, MIXER_FRAC_MASK
from ..core import context as cparams
from ..core.voice import PlayState, Voice, VoiceStore

from ..ops import filters as f_ops

# Raw-bytes callback returns (the C-ABI trampoline) decode with the sample
# type registered at alBufferCallbackSOFT time.
_CB_DTYPES = {"uint8": np.uint8, "int8": np.int8, "int16": np.int16,
              "int32": np.int32, "float32": np.float32,
              "float64": np.float64, "mulaw": np.uint8, "alaw": np.uint8}

f32 = np.float32
_COEFF_EPS = f32(0.015625)  # 1/64, biquad.cpp check_set


class VChange(enum.Enum):
    RESET = "reset"
    STOP = "stop"
    PLAY = "play"
    PAUSE = "pause"
    RESTART = "restart"


@dataclasses.dataclass
class VoiceChange:
    kind: VChange
    voice: Voice | None
    old_voice: Voice | None = None
    source_id: int = 0


@dataclasses.dataclass
class _MirrorPlan:
    """How ``finish_chunk`` splits a context's voices, built under one
    uploaded device config and kept while that config is live: every
    change to a voice's state, rows, step or buffer dirties the config
    (queueing onto a stream drops the plan itself).

    Candidates are the PLAYING static voices with a buffer and no
    callback; per chunk, those whose advance can neither end the voice
    nor complete a buffer (a loop, or a stop short of the buffer's end)
    step together.  ``stepped`` holds the others (STOPPING, streaming,
    callback and bufferless voices), which always take the per-voice
    path."""
    cfg: object                 # the device config it was built under
    rows: np.ndarray            # every PLAYING voice's rows, voice order
    stepped: list[int]          # indices into Context.voices
    order: np.ndarray           # the candidates' indices into voices
    slot: np.ndarray            # their VoiceStore slots
    step: np.ndarray            # int64 increments
    loop: np.ndarray            # looping with loop_end > loop_start
    loop_start: np.ndarray
    loop_end: np.ndarray
    span: np.ndarray            # loop_end - loop_start (1 when not looping)
    sample_len: np.ndarray


class Context:
    """One rendering context on a device."""

    def __init__(self, device) -> None:
        self.device = device
        device.contexts.append(self)
        self.listener = cparams.ContextProps()
        self._listener_dirty = True
        self.params = cparams.calc_context_params(self.listener)
        self.voices: list[Voice] = []
        self._vstore = VoiceStore()
        self._mirror_plan: _MirrorPlan | None = None
        # Voice advances of finish_chunk: by the batched step, and by the
        # per-voice path (logged when the device closes).
        self.mirror_voices_batched = 0
        self.mirror_voices_stepped = 0
        self.voice_changes: list[VoiceChange] = []
        self.events: list[tuple] = []     # (kind, source_id, ...)
        self.sources: dict[int, object] = {}
        self.buffers: dict[int, object] = {}
        self.effects: dict[int, object] = {}
        self.filters: dict[int, object] = {}
        self.aux_slots: dict[int, object] = {}
        self.deferred = False
        # Callback-buffer voices need the per-dispatch feed + pack; the flag
        # is rescanned only when the playing population changes.
        self._has_cb_voices = False
        self._cb_scan_due = False
        self._horizon_unbounded = False
        self._packed_this_update = False
        # AL_SOFTX_hold_on_disconnect (core/context.h:94): keep voices
        # playing through a device disconnect instead of stopping them.
        self.hold_on_disconnect = False
        self._next_id = 1
        # AL error model (al/error.cpp:59-98): first error sticks until
        # alGetError pops it.
        self.last_error = 0               # AL_NO_ERROR
        # AL_SOFT_events dispatch (al/event.cpp): callback + enabled kinds,
        # delivered off-thread like the reference's event thread.
        self._event_callback = None
        self._event_mask: set[str] = set()
        self._event_queue = None
        self._event_thread = None

    # --- AL error model ---

    def set_error(self, code: int, message: str = "") -> None:
        """Context::setError: keep the FIRST unqueried error (error.cpp:87);
        `trap-al-error` config key / ALSOFT_TRAP_AL_ERROR raises SIGTRAP for
        debugger breaks (error.cpp:40-57)."""
        if self.last_error == 0:
            self.last_error = code
        self._last_error_message = message
        import os

        from . import config as alconf
        if (alconf.config_value_bool("", "trap-al-error", False)
                or os.environ.get("ALSOFT_TRAP_AL_ERROR", "") in
                ("1", "true", "yes", "on")
                or os.environ.get("ALSOFT_TRAP_ERROR", "") in
                ("1", "true", "yes", "on")):
            import signal
            os.kill(os.getpid(), signal.SIGTRAP)

    def get_error(self) -> int:
        err, self.last_error = self.last_error, 0
        return err

    # --- async event dispatch (AL_SOFT_events) ---

    def set_event_callback(self, callback) -> None:
        import queue as _queue
        import threading

        self._event_callback = callback
        if callback is not None and self._event_thread is None:
            self._event_queue = _queue.Queue()

            def _run():
                while True:
                    evt = self._event_queue.get()
                    if evt is None:
                        return
                    cb = self._event_callback
                    if cb is not None:
                        try:
                            cb(*evt)
                        except Exception:
                            pass
            self._event_thread = threading.Thread(target=_run, daemon=True)
            self._event_thread.start()

    def control_events(self, kinds, enable: bool) -> None:
        if enable:
            self._event_mask.update(kinds)
        else:
            self._event_mask.difference_update(kinds)

    def _emit(self, kind: str, object_id: int, param) -> None:
        self.events.append((kind, object_id, param))
        if (self._event_callback is not None and kind in self._event_mask
                and self._event_queue is not None):
            self._event_queue.put((kind, object_id, param))

    # --- object creation ---

    def _new_id(self) -> int:
        nid = self._next_id
        self._next_id += 1
        return nid

    def create_buffer(self):
        from ..al.buffer import Buffer

        buf = Buffer(self._new_id(), self)
        self.buffers[buf.id] = buf
        return buf

    def create_source(self):
        from ..al.source import Source

        src = Source(self._new_id(), self)
        self.sources[src.id] = src
        return src

    def create_aux_slot(self):
        from ..al.error import ALError
        from ..core.effectslot import EffectSlot
        from . import config as alconf

        limit = alconf.config_value_int("", "slots", 64) or 64
        if len(self.aux_slots) >= max(limit, 1):
            raise ALError(0xA005,     # AL_OUT_OF_MEMORY (alAuxiliaryEffect-
                          "effect slot limit reached")   # Slot.cpp:122)
        slot = EffectSlot(self._new_id(), self)
        self.aux_slots[slot.id] = slot
        return slot

    def create_effect(self, effect_type: str = "null"):
        from ..al.effect import Effect

        eff = Effect(self._new_id(), effect_type)
        self.effects[eff.id] = eff
        return eff

    def create_filter(self, filter_type: str = "null"):
        from ..al.filter import Filter

        flt = Filter(self._new_id(), filter_type)
        self.filters[flt.id] = flt
        return flt

    # --- API-side entry points ---

    def new_voice(self) -> Voice:
        v = Voice(self._vstore)
        self.voices.append(v)
        return v

    def queue_change(self, change: VoiceChange) -> None:
        self.voice_changes.append(change)

    def listener_dirty(self) -> None:
        self._listener_dirty = True

    # --- block-boundary processing (mixer-thread side in the reference) ---

    def process_updates(self, block_len: int = 1024) -> None:
        updated = bool(self.voice_changes)
        self._process_voice_changes()
        if self.deferred:
            self._packed_this_update = False
            return
        force = self._listener_dirty
        if force:
            self.params = cparams.calc_context_params(self.listener)
            self._listener_dirty = False
        for slot in self.aux_slots.values():
            if slot.props_dirty:
                self.device.mark_config_dirty()
                slot.props_dirty = False
                force = True  # CalcEffectSlotParams forces voice updates
        for v in self.voices:
            if v.source_id and (v.props_dirty or force) \
                    and v.state in (PlayState.PLAYING, PlayState.STOPPING):
                self._update_voice_params(v)
                v.props_dirty = False
                self.device.mark_config_dirty()
                updated = True
        if self._cb_scan_due:
            self._has_cb_voices = any(
                v.rows and v.state == PlayState.PLAYING
                and any(it.callback is not None for it in v.queue)
                for v in self.voices)
            self._cb_scan_due = False
        if self._has_cb_voices:
            self._feed_callbacks(block_len)
        # Steady-state short-circuit: with no host-side change the row pack
        # would rewrite the table with the values it already holds (the
        # device evolves its own copy) — at 4096 voices the per-voice
        # Python walk costs more than a block.  The device packs all
        # contexts' mirrors anyway before any config/ev re-upload
        # (_render_dispatch_inner), so skipping here can never leave a
        # stale mirror visible to the device.
        if updated or force or self._has_cb_voices:
            self._pack_block_fields(block_len)
            self._packed_this_update = True
        else:
            self._packed_this_update = False

    def event_horizon_blocks(self, T: int) -> int:
        """Blocks until the next host-visible event (voice end, queue item
        transition, first loop wrap, stop fade).  Within this horizon the
        per-block parameter update pass is a no-op, so the device can run
        multiple blocks per dispatch.

        An all-looping steady population has no horizon at all; that result
        is cached while the device config stays live (any scene change
        invalidates it by dirtying the config), skipping the per-voice walk
        on every dispatch."""
        if self._horizon_unbounded and self.device._cfg_dev is not None:
            return 1 << 30
        horizon = 1 << 30
        for v in self.voices:
            if not v.rows:
                continue
            if v.state == PlayState.STOPPING:
                return 1
            if v.state != PlayState.PLAYING:
                continue
            buf = v.current_buffer()
            if buf is None or buf.callback is not None:
                return 1
            per_block = v.step * T
            if per_block <= 0:
                continue
            if v.is_static and v.looping and buf.loop_end > buf.loop_start:
                # Loop wraps are device-local (the graph rebases positions
                # and flips has_wrapped itself): no host event, no limit.
                continue
            limit_frac = (buf.sample_len << 16)
            cur = (v.position << 16) + v.position_frac
            n = (limit_frac - cur) // per_block  # blocks fully before limit
            horizon = min(horizon, max(int(n), 1))
        self._horizon_unbounded = (horizon >= (1 << 29)
                                   and self.device._cfg_dev is not None)
        return max(horizon, 1)

    def _process_voice_changes(self) -> None:
        """ProcessVoiceChanges (alu.cpp:2051-2145)."""
        if self.voice_changes:
            self.device.mark_config_dirty()
            self._cb_scan_due = True
        for ch in self.voice_changes:
            if ch.kind in (VChange.RESET, VChange.STOP):
                v = ch.voice
                sendevt = False
                if v is not None:
                    sendevt = v.source_id != 0
                    v.source_id = 0
                    v.queue = []
                    if v.state == PlayState.PLAYING:
                        v.state = PlayState.STOPPING
                if ch.kind == VChange.RESET:
                    sendevt = True
                if sendevt:
                    self._emit("source_state", ch.source_id, ch.kind.value)
            elif ch.kind == VChange.PAUSE:
                v = ch.voice
                if v.state == PlayState.PLAYING:
                    v.state = PlayState.STOPPING
                    self._emit("source_state", ch.source_id, "pause")
            elif ch.kind == VChange.PLAY:
                sendevt = True
                if ch.old_voice is not None:
                    ov = ch.old_voice
                    ov.queue = []
                    ov.source_id = 0
                    sendevt = ov.state != PlayState.PLAYING
                    if ov.state == PlayState.PLAYING:
                        ov.state = PlayState.STOPPING
                ch.voice.state = PlayState.PLAYING
                if sendevt:
                    self._emit("source_state", ch.source_id, "play")
            elif ch.kind == VChange.RESTART:
                ov = ch.old_voice
                ov.queue = []
                if ov.source_id != 0:
                    ov.source_id = 0
                    was_playing = ov.state == PlayState.PLAYING
                    if was_playing:
                        ov.state = PlayState.STOPPING
                    ch.voice.state = (PlayState.PLAYING if was_playing
                                      else PlayState.STOPPED)
        self.voice_changes.clear()

    def _update_voice_params(self, v: Voice) -> None:
        dev = self.device
        mp = cparams.calc_voice_params(v, self.params, dev)
        v.step = mp.step
        t = dev.table
        t.ramp_pending[v.rows] = True
        for c, r in enumerate(v.rows):
            t.increment[r] = mp.step
            t.bank_row[r] = mp.bank_row
            t.sf[r] = mp.sf
            if mp.dry_target is not None and not v.has_hrtf:
                t.dry_tgt[r] = mp.dry_target[c]
            for snd in range(self.device.num_aux_sends):
                slot = v.props.send[snd].slot
                t.wet_active[r, snd] = slot is not None
                if slot is not None:
                    t.wet_slot[r, snd] = slot.index
                    t.wet_tgt[r, snd] = mp.wet_target[c, snd]
                    self._set_send_filter_target(
                        t, r, snd, np.stack([mp.send_lp_coeffs[snd],
                                             mp.send_hp_coeffs[snd]]))
                    t.send_filter_active[r, snd] = bool(mp.send_filter_active[snd])
            if v.has_hrtf:
                # Old ← previous target on fade (DoHrtfMix handles the blend).
                # Device coeffs are 192-tap: HRIR shifted by its integer
                # delay per ear (exact host-side shift; no device phase).
                shifted = np.zeros((192, 2), f32)
                for e in range(2):
                    d = int(mp.hrtf_delay[c, e])
                    shifted[d:d + 128, e] = mp.hrtf_coeffs[c][:, e]
                t.hrtf_old_coeffs[r] = t.hrtf_coeffs[r]
                t.hrtf_old_delay[r] = t.hrtf_delay[r]
                t.hrtf_coeffs[r] = shifted
                t.hrtf_delay[r] = mp.hrtf_delay[c]
                t.hrtf_gain[r] = mp.hrtf_gain[c]
                if not v.is_fading:
                    t.hrtf_old_gain[r] = mp.hrtf_gain[c]
                    t.hrtf_old_coeffs[r] = shifted
                    t.hrtf_old_delay[r] = mp.hrtf_delay[c]
            self._set_filter_target(t, r, np.stack([mp.lp_coeffs, mp.hp_coeffs]))
            t.filter_active[r] = mp.filter_active
            # NFC (HasNfc flag + per-channel w0; alu.cpp:919-940, 1324-1336,
            # 1411-1424).  NaN = leave the row's prior adjust untouched
            # (ambisonic non-W channels).
            if mp.nfc_w0 is not None:
                t.nfc_active[r] = True
                if not np.isnan(mp.nfc_w0[c]):
                    t.nfc_w0[r] = mp.nfc_w0[c]
            else:
                t.nfc_active[r] = False

    @staticmethod
    def _set_filter_target(t, r: int, new_target: np.ndarray) -> None:
        """BiquadInterpFilter::setParams counter logic (biquad.cpp:131-149)."""
        changed = bool(np.any(np.abs(new_target - t.filter_target[r]) > _COEFF_EPS))
        t.filter_target[r] = new_target
        if not changed:
            if t.filter_counter[r] <= 0:
                t.filter_counter[r] = 0
                t.filter_coeffs[r] = new_target
        elif t.filter_counter[r] >= 0:
            t.filter_counter[r] = f_ops.INTERP_SAMPLES
        else:
            t.filter_counter[r] = 0
            t.filter_coeffs[r] = new_target

    @staticmethod
    def _set_send_filter_target(t, r: int, snd: int, new_target) -> None:
        changed = bool(np.any(np.abs(new_target - t.send_filter_target[r, snd])
                              > _COEFF_EPS))
        t.send_filter_target[r, snd] = new_target
        if not changed:
            if t.send_filter_counter[r, snd] <= 0:
                t.send_filter_counter[r, snd] = 0
                t.send_filter_coeffs[r, snd] = new_target
        elif t.send_filter_counter[r, snd] >= 0:
            t.send_filter_counter[r, snd] = f_ops.INTERP_SAMPLES
        else:
            t.send_filter_counter[r, snd] = 0
            t.send_filter_coeffs[r, snd] = new_target

    def _feed_callbacks(self, block_len: int) -> None:
        """Pull callback-buffer samples ahead of each dispatch.

        AL_SOFT_callback_buffer (al/buffer.cpp:874 + core/voice.cpp's
        mCallback pulls): the host fetches enough interleaved samples from
        the app callback to cover this dispatch at the voice's pitch (plus
        resampler padding), decodes to planar f32 in the buffer's fixed
        pool segment, and compacts the segment as the voice advances.  A
        short or empty return marks end-of-stream; the voice then ends at
        the final fill count through the normal queue logic."""
        from ..constants import MAX_RESAMPLER_PADDING
        from ..core.devformat import decode_to_float32

        pool = self.device.pool
        for v in self.voices:
            if not v.rows or v.state != PlayState.PLAYING:
                continue
            item = v.current_buffer()
            if item is None or item.callback is None:
                continue
            buf = item.callback          # the al Buffer holding cb state
            seg = buf.plane_stride
            host = pool._host

            # Compact: drop consumed frames once past half the segment.
            if v.position > seg // 2:
                shift = v.position
                keep = max(buf.cb_fill - shift, 0)
                for c in range(buf.channels):
                    base = buf.pool_offset + c * seg
                    host[base:base + keep] = \
                        host[base + shift:base + shift + keep]
                buf.cb_fill = keep
                v.position = 0
                pool._dirty = True
                self.device.mark_config_dirty()

            need = (v.position + ((v.step * block_len) >> MIXER_FRAC_BITS)
                    + MAX_RESAMPLER_PADDING + 2)
            while not buf.cb_done and buf.cb_fill < min(need, seg):
                want = min(4096, seg - buf.cb_fill)
                res = buf.callback(want)
                if isinstance(res, (bytes, bytearray, memoryview)):
                    # C-ABI trampoline (native/alc_shim.cpp) returns the raw
                    # interleaved bytes in the registered sample type.
                    ct = getattr(buf.cb_type, "value", buf.cb_type)
                    res = np.frombuffer(res, dtype=_CB_DTYPES[ct])
                arr = np.asarray(res)
                flat = decode_to_float32(arr.ravel(), buf.cb_type)
                frames = flat.size // buf.channels
                planar = flat[:frames * buf.channels].reshape(
                    frames, buf.channels).T
                for c in range(buf.channels):
                    base = buf.pool_offset + c * seg + buf.cb_fill
                    host[base:base + frames] = planar[c]
                buf.cb_fill += frames
                pool._dirty = True
                if frames < want:
                    buf.cb_done = True
            new_len = buf.cb_fill
            if item.sample_len != new_len:
                item.sample_len = new_len
                self.device.mark_config_dirty()

    def _pack_block_fields(self, block_len: int) -> None:
        """Per-dispatch row refresh: positions, fade counters, play state.

        Batched over the whole voice population: per-row values are
        collected into flat index arrays and applied as single
        fancy-indexed assignments (a per-voice numpy loop cost ~0.5 ms per
        dispatch per voice at 512+ voices, dominating the block budget).
        """
        t = self.device.table
        fade = min(GAIN_FADE_SAMPLES, block_len)
        rows, playing, fades, slots = [], [], [], []
        s_off, s_len, l_start, l_end = [], [], [], []
        # Per row: the loop end under which it loops (0: never, positions
        # are not negative), and whether it reports its voice's wrap.
        # Positions come from the VoiceStore in one gather after the walk.
        loop_lim, wraps = [], []
        for v in self.voices:
            if not v.rows or v.state not in (PlayState.PLAYING, PlayState.STOPPING):
                continue
            is_playing = v.state == PlayState.PLAYING
            buf = v.current_buffer()
            fade_v = fade if v.is_fading else 0
            lim = (buf.loop_end if buf is not None and v.looping
                   and v.is_static else 0)
            for c, r in enumerate(v.rows):
                rows.append(r)
                playing.append(is_playing)
                fades.append(fade_v)
                slots.append(v.store_slot)
                if buf is not None:
                    if c >= buf.channels and v.is_ambisonic:
                        # UHJ2/SuperStereo T line etc: zero-filled channel
                        # (core/voice.cpp:986-987).
                        s_off.append(0)
                        s_len.append(0)
                        l_start.append(0)
                        l_end.append(1)
                        loop_lim.append(0)
                        wraps.append(False)
                        continue
                    chan = min(c, buf.channels - 1)
                    stride = buf.plane_stride or buf.sample_len
                    s_off.append(buf.pool_offset + chan * stride)
                    s_len.append(buf.sample_len)
                    l_start.append(buf.loop_start)
                    l_end.append(max(buf.loop_end, buf.loop_start + 1))
                    loop_lim.append(lim)
                    wraps.append(True)
                else:
                    s_off.append(int(t.src_off[r]))
                    s_len.append(0)  # silence
                    l_start.append(int(t.loop_start[r]))
                    l_end.append(int(t.loop_end[r]))
                    loop_lim.append(0)
                    wraps.append(False)
        if not rows:
            return
        ri = np.array(rows, np.int64)
        playing = np.array(playing)
        st = self._vstore
        sl = np.array(slots, np.int64)
        pos = st.pos[sl]
        s_off = np.array(s_off, np.int32)
        s_len = np.array(s_len, np.int32)
        l_start = np.array(l_start, np.int32)
        l_end = np.array(l_end, np.int32)
        h_loop = pos < np.array(loop_lim, np.int64)
        h_wrap = np.array(wraps) & st.wrapped[sl]
        changed = (bool(np.any(~t.active[ri]))
                   or bool(np.any(t.playing[ri] != playing))
                   or bool(np.any(t.src_off[ri] != s_off))
                   or bool(np.any(t.src_len[ri] != s_len))
                   or bool(np.any(t.loop_start[ri] != l_start))
                   or bool(np.any(t.loop_end[ri] != l_end))
                   or bool(np.any(t.has_loop[ri] != h_loop)))
        if changed:
            self.device.mark_config_dirty()
        t.active[ri] = True
        t.playing[ri] = playing
        t.fade[ri] = np.array(fades, np.int32)
        t.pos_int[ri] = pos
        t.pos_frac[ri] = st.frac[sl]
        t.src_off[ri] = s_off
        t.src_len[ri] = s_len
        t.loop_start[ri] = l_start
        t.loop_end[ri] = l_end
        t.has_loop[ri] = h_loop
        t.has_wrapped[ri] = h_wrap

    def finish_chunk(self, T: int, n_blocks: int = 1) -> None:
        """Deterministic post-dispatch state evolution (host mirror).

        Costs work in proportion to the voices with something to do: the
        static voices whose advance can neither end them nor complete a
        buffer advance in one numpy step over the VoiceStore, with
        Voice.advance's integer math; every other voice takes the
        per-voice path in voice order, so events and config changes fire
        as they always did.  The table copies and interp schedules run
        only on rows with a ramp or a schedule pending."""
        t = self.device.table
        frames = T * n_blocks
        plan = self._mirror_plan
        if plan is None or plan.cfg is None \
                or plan.cfg is not self.device._cfg_dev:
            plan = self._mirror_plan = self._build_mirror_plan()
        stepped = plan.stepped
        if plan.slot.size:
            st = self._vstore
            total = st.frac[plan.slot] + plan.step * frames
            pos = st.pos[plan.slot] + (total >> MIXER_FRAC_BITS)
            ok = plan.loop | (pos < plan.sample_len)
            wrap = plan.loop & (pos >= plan.loop_end)
            pos = np.where(wrap, plan.loop_start
                           + (pos - plan.loop_start) % plan.span, pos)
            slot = plan.slot
            if not ok.all():
                # These end inside the chunk: the per-voice path emits.
                stepped = sorted(stepped + plan.order[~ok].tolist())
                slot, pos, total, wrap = slot[ok], pos[ok], total[ok], wrap[ok]
            st.pos[slot] = pos
            st.frac[slot] = total & MIXER_FRAC_MASK
            st.wrapped[slot] |= wrap
            self.mirror_voices_batched += int(slot.size)
        for i in stepped:
            self._advance_voice(self.voices[i], frames)

        rows = plan.rows
        if not rows.size:
            return
        # Gain ramps complete within the first block: Current <- Target.
        ramp = rows[t.ramp_pending[rows]]
        if ramp.size:
            pl = t.playing[ramp]
            t.dry_cur[ramp] = np.where(pl[:, None], t.dry_tgt[ramp], 0.0)
            t.wet_cur[ramp] = np.where(pl[:, None, None], t.wet_tgt[ramp],
                                       0.0)
            t.hrtf_old_gain[ramp] = t.hrtf_gain[ramp]
            t.hrtf_old_coeffs[ramp] = t.hrtf_coeffs[ramp]
            t.hrtf_old_delay[ramp] = t.hrtf_delay[ramp]
            t.ramp_pending[ramp] = False
        # The interp schedule completes within 256 samples; cap the loop.
        # A row at counter 0 is its fixed point, and -1 (a fresh filter)
        # is left alone.
        n = min(frames, f_ops.INTERP_SAMPLES)
        live = rows[t.filter_counter[rows] > 0]
        if live.size:
            t.filter_coeffs[live], t.filter_counter[live] = \
                f_ops.host_advance_interp(t.filter_coeffs[live],
                                          t.filter_target[live],
                                          t.filter_counter[live], n)
        for snd in range(self.device.num_aux_sends):
            live = rows[t.send_filter_counter[rows, snd] > 0]
            if live.size:
                t.send_filter_coeffs[live, snd], \
                    t.send_filter_counter[live, snd] = \
                    f_ops.host_advance_interp(
                        t.send_filter_coeffs[live, snd],
                        t.send_filter_target[live, snd],
                        t.send_filter_counter[live, snd], n)

    def _build_mirror_plan(self) -> _MirrorPlan:
        rows: list[int] = []
        stepped: list[int] = []
        cand: list[tuple] = []
        for i, v in enumerate(self.voices):
            if not v.rows or v.state not in (PlayState.PLAYING,
                                             PlayState.STOPPING):
                continue
            if v.state == PlayState.STOPPING:
                stepped.append(i)
                continue
            rows.extend(v.rows)
            buf = v.current_buffer()
            if buf is None or buf.callback is not None or not v.is_static:
                stepped.append(i)
                continue
            # Every chunk marks a playing voice fading; the plan lives no
            # longer than this holds (a play or a device reset dirties it).
            v.is_fading = True
            loop = v.looping and buf.loop_end > buf.loop_start
            cand.append((i, v.store_slot, v.step, loop, buf.loop_start,
                         buf.loop_end,
                         buf.loop_end - buf.loop_start if loop else 1,
                         buf.sample_len))
        order, slot, step, loop, ls, le, span, slen = np.array(
            cand, np.int64).reshape(-1, 8).T
        return _MirrorPlan(self.device._cfg_dev, np.array(rows, np.int64),
                           stepped, order, slot, step, loop.astype(bool),
                           ls, le, span, slen)

    def _advance_voice(self, v: Voice, frames: int) -> None:
        """The per-voice path: a STOPPING voice stops and frees its rows; a
        PLAYING one advances through Voice.advance, emitting its buffer
        completions and its end."""
        if v.state == PlayState.STOPPING:
            # Mixed one silent-target block; now fully stopped.
            v.state = PlayState.STOPPED
            self.device.free_rows(v.rows)
            v.rows = []
            return
        self.mirror_voices_stepped += 1
        v.is_fading = True
        # Position advance (voice.cpp:1086-1089)
        total = v.position_frac + v.step * frames
        samples_done = total >> MIXER_FRAC_BITS
        v.position_frac = total & MIXER_FRAC_MASK
        buffers_done, ended = v.advance(samples_done)
        if buffers_done:
            self._emit("buffer_completed", v.source_id, buffers_done)
            self.device.mark_config_dirty()
        if ended:
            v.state = PlayState.STOPPING
            self._emit("source_state", v.source_id, "stop")
            src = self.sources.get(v.source_id)
            if src is not None:
                src.voice_ended()
            v.source_id = 0
            self.device.mark_config_dirty()
