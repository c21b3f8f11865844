"""EAX 2.0–5.0 compatibility layer (API-level, no DSP of its own).

Host re-realization of al/eax/ (~4.2 kLoC in the reference): EAXSet/EAXGet
dispatch by property-set GUID (al/eax/call.h:26 EaxCall), four effect slots
(al/eax/fx_slots.h:16), listener/reverb property translation onto the
existing EAXReverb EFX engine (al/effects/reverb.cpp:982-1070
EaxReverbCommitter::translate/commit), and per-source filter-gain math
(al/source.cpp:4027-4133 eax_create_direct_filter_param /
eax_create_room_filter_param).

All values route onto the normal EFX objects, so the render path is the
ordinary effect-slot graph — exactly the reference's design.

Port of openal_soft_tpu/al/eax.py, unchanged: the EAX mapping writes
the same source, filter and effect properties, which the render device
picks up at its next dispatch.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

# --- property-set GUIDs (al/eax/api.cpp; ABI constants) ----------------------

DSPROPSETID_EAX20_ListenerProperties = \
    "0306a6a8-b224-11d2-99e5-0000e8d8c722"
DSPROPSETID_EAX20_BufferProperties = \
    "0306a6a7-b224-11d2-99e5-0000e8d8c722"
DSPROPSETID_EAX30_ListenerProperties = \
    "a8fa6882-b476-11d3-bdb9-00c0f02ddf87"
DSPROPSETID_EAX30_BufferProperties = \
    "a8fa6881-b476-11d3-bdb9-00c0f02ddf87"
EAXPROPERTYID_EAX40_Context = "1d4870ad-0def-43c0-a40c-523632296342"
EAXPROPERTYID_EAX40_FXSlot0 = "c4d79f1e-f1ac-436b-a81d-a738e7045469"
EAXPROPERTYID_EAX40_FXSlot1 = "08c00e96-74be-4491-93aa-e8ad35a49117"
EAXPROPERTYID_EAX40_FXSlot2 = "1d433b88-f0f6-4637-919f-60e7e06b5edd"
EAXPROPERTYID_EAX40_FXSlot3 = "efff08ea-c7d8-44ab-93ad-6dbd5f910064"
EAXPROPERTYID_EAX40_Source = "1b86b823-22df-4eae-8b3c-1278ce544227"

_FXSLOT_GUIDS = {EAXPROPERTYID_EAX40_FXSlot0: 0,
                 EAXPROPERTYID_EAX40_FXSlot1: 1,
                 EAXPROPERTYID_EAX40_FXSlot2: 2,
                 EAXPROPERTYID_EAX40_FXSlot3: 3}

# Effect GUIDs loadable into a slot (api.cpp EAX_REVERB_EFFECT etc.)
EAX_NULL_GUID = "00000000-0000-0000-0000-000000000000"
EAX_REVERB_EFFECT = "0cf95c8f-a3cc-4849-b0b6-832ecc1822df"
EAX_CHORUS_EFFECT = "de6d6fe2-0ab5-11d2-90f5-00c04fc28aca"
EAX_ECHO_EFFECT = "e9f1bc01-d021-11d1-b0a7-00a0c95a7e09"

_EFFECT_GUIDS = {EAX_NULL_GUID: "null", EAX_REVERB_EFFECT: "eaxreverb",
                 EAX_CHORUS_EFFECT: "chorus", EAX_ECHO_EFFECT: "echo"}

# DSPROPERTY_EAX20LISTENER_* (api.h:84-100)
L20_NONE, L20_ALL, L20_ROOM, L20_ROOMHF, L20_ROOMROLLOFF, L20_DECAYTIME, \
    L20_DECAYHFRATIO, L20_REFLECTIONS, L20_REFLECTIONSDELAY, L20_REVERB, \
    L20_REVERBDELAY, L20_ENVIRONMENT, L20_ENVIRONMENTSIZE, \
    L20_ENVIRONMENTDIFFUSION, L20_AIRABSORPTIONHF, L20_FLAGS = range(16)

# DSPROPERTY_EAX20BUFFER_* (api.h:222-237)
B20_NONE, B20_ALL, B20_DIRECT, B20_DIRECTHF, B20_ROOM, B20_ROOMHF, \
    B20_ROOMROLLOFF, B20_OBSTRUCTION, B20_OBSTRUCTIONLFRATIO, B20_OCCLUSION, \
    B20_OCCLUSIONLFRATIO, B20_OCCLUSIONROOMRATIO, B20_OUTSIDEVOLUMEHF, \
    B20_AIRABSORPTIONFACTOR, B20_FLAGS = range(15)

EAX_DEFER = 0x80000000      # property-id flag: defer commit

# EAX2 environment list == the first 26 EFX reverb presets, in enum order
# (api.h:118-148 / efx-presets.h).
EAX2_ENVIRONMENTS = (
    "generic", "paddedcell", "room", "bathroom", "livingroom", "stoneroom",
    "auditorium", "concerthall", "cave", "arena", "hangar",
    "carpetedhallway", "hallway", "stonecorridor", "alley", "forest",
    "city", "mountains", "quarry", "plain", "parkinglot", "sewerpipe",
    "underwater", "drugged", "dizzy", "psychotic")

# flEnvironmentSize per environment (EAX2REVERB_PRESETS, al/eax/api.cpp:834;
# default 7.5 = EAX2LISTENER_DEFAULTENVIRONMENTSIZE).
_ENV_SIZES = (7.5, 1.4, 1.9, 1.4, 2.5, 11.6, 21.6, 19.6, 14.6, 36.2, 50.3,
              1.9, 1.8, 13.5, 7.5, 38.0, 7.5, 100.0, 17.5, 42.5, 8.3, 1.7,
              1.8, 1.9, 1.8, 1.0)

# EAX2LISTENERFLAGS_* bits (api.h:151-157)
LF_DECAYTIMESCALE = 0x01
LF_REFLECTIONSSCALE = 0x02
LF_REFLECTIONSDELAYSCALE = 0x04
LF_REVERBSCALE = 0x08
LF_REVERBDELAYSCALE = 0x10
LF_DECAYHFLIMIT = 0x20
LISTENER_DEFAULT_FLAGS = 0x3F      # EAX2LISTENER_DEFAULTFLAGS (api.h:211)
# drugged/dizzy/psychotic drop DECAYHFLIMIT (api.cpp preset table).
_ENV_FLAGS = tuple(0x1F if e in ("drugged", "dizzy", "psychotic") else 0x3F
                   for e in EAX2_ENVIRONMENTS)


def level_mb_to_gain(mb: float) -> float:
    """al/eax/utils.h level_mb_to_gain."""
    if mb <= -10000.0:
        return 0.0
    return float(10.0 ** (mb / 2000.0))


def gain_to_level_mb(gain: float) -> float:
    if gain <= 0.0:
        return -10000.0
    return float(2000.0 * math.log10(gain))


@dataclasses.dataclass
class EaxSourceProps:
    """EAX 2.0 buffer/source properties (EAX20BUFFERPROPERTIES defaults,
    api.h; al/source.cpp:3800-3836)."""
    direct: int = 0
    direct_hf: int = 0
    room: int = 0
    room_hf: int = 0
    room_rolloff: float = 0.0
    obstruction: int = 0
    obstruction_lf_ratio: float = 0.0
    occlusion: int = 0
    occlusion_lf_ratio: float = 0.25
    occlusion_room_ratio: float = 1.5
    occlusion_direct_ratio: float = 1.0
    exclusion: int = 0
    exclusion_lf_ratio: float = 1.0
    outside_volume_hf: int = 0
    air_absorption_factor: float = 0.0
    flags: int = 7
    # EAX3.0+ additions (EAX30SOURCEPROPERTIES, api.h:636-654)
    doppler_factor: float = 1.0
    rolloff_factor: float = 0.0
    # EAX5.0 additions
    macro_fx_factor: float = 1.0
    speaker_levels: tuple = tuple([-10000] * 9)   # EAXSPEAKERLEVELPROPERTIES


def _occlusion_mb(occ: float, path_ratio: float, lf_ratio: float) -> float:
    """eax_calculate_dst_occlusion_mb (al/source.cpp:4027-4033)."""
    return float(occ) * max(path_ratio * lf_ratio, path_ratio + lf_ratio - 1.0)


class EaxContext:
    """Per-AL-context EAX state: 4 fx slots + per-source properties."""

    MAX_FXSLOTS = 4

    def __init__(self, ctx) -> None:
        self.ctx = ctx
        self.slots = [None] * self.MAX_FXSLOTS
        self.slot_effect_type = ["null"] * self.MAX_FXSLOTS
        self.source_props: dict[int, EaxSourceProps] = {}
        self.primary_fx_slot = 0
        self.listener_env = 0
        self.listener_size = 7.5       # EAX2LISTENER_DEFAULTENVIRONMENTSIZE
        self.listener_flags = LISTENER_DEFAULT_FLAGS
        self.deferred: list = []
        # Slot 0 defaults to the generic-environment reverb
        # (fx_slots.cpp: slot 0 loads EAX_REVERB_EFFECT on init); the
        # `default-reverb` config key overrides the initial preset by EFX
        # preset name (alc/alc.cpp LoadReverbPreset).
        self._ensure_slot(0)
        self._load_effect(0, "eaxreverb")
        self._set_environment(0)
        self._apply_default_reverb()

    # --- slots ---

    def _ensure_slot(self, idx: int):
        if self.slots[idx] is None:
            self.slots[idx] = self.ctx.create_aux_slot()
        return self.slots[idx]

    def _load_effect(self, idx: int, effect_type: str) -> None:
        slot = self._ensure_slot(idx)
        eff = self.ctx.create_effect(effect_type)
        slot.set_effect(eff)
        slot._eax_effect = eff
        self.slot_effect_type[idx] = effect_type

    def _apply_default_reverb(self) -> None:
        from . import presets
        from ..alc import config as alconf

        name = alconf.config_value_str("", "default-reverb")
        if not name:
            return
        key = name.strip().upper().replace(" ", "_")
        props = presets.REVERB_PRESETS.get(key)
        if props is None:
            return
        slot = self.slots[0]
        for k, v in props.items():
            slot._eax_effect.set(k, v)
        slot.set_effect(slot._eax_effect)

    def _set_environment(self, env: int) -> None:
        from . import presets
        self.listener_env = int(env)
        self.listener_size = _ENV_SIZES[env]
        self.listener_flags = _ENV_FLAGS[env]
        props = dict(presets.REVERB_PRESETS[EAX2_ENVIRONMENTS[env]])
        slot = self.slots[0]
        for k, v in props.items():
            slot._eax_effect.set(k, v)
        slot.set_effect(slot._eax_effect)

    def _set_environment_size(self, size: float) -> None:
        """EnvironmentSizeDeferrer2 (al/effects/reverb.cpp:829-884): scale
        the committed reverb decay/reflection/reverb values by the size
        ratio per the listener flags, clamped to the EAXREVERB ranges."""
        size = float(size)
        if size == self.listener_size or self.listener_size <= 0.0:
            self.listener_size = size
            return
        scale = size / self.listener_size
        self.listener_size = size
        eff = self._reverb_effect(0)
        fl = self.listener_flags
        clamp = lambda v, lo, hi: min(max(v, lo), hi)
        if fl & LF_DECAYTIMESCALE:
            eff.set("decay_time",
                    clamp(eff.get("decay_time") * scale, 0.1, 20.0))
        if (fl & LF_REFLECTIONSSCALE) and (fl & LF_REFLECTIONSDELAYSCALE):
            # lReflections -= gain_to_level_mb(scale)  <=>  gain /= scale
            eff.set("reflections_gain",
                    clamp(eff.get("reflections_gain") / scale, 0.0, 3.16))
        if fl & LF_REFLECTIONSDELAYSCALE:
            eff.set("reflections_delay",
                    clamp(eff.get("reflections_delay") * scale, 0.0, 0.3))
        if fl & LF_REVERBSCALE:
            # lReverb -= log10(scale) * (2000 | 3000) mB
            exp = 1.0 if fl & LF_DECAYTIMESCALE else 1.5
            eff.set("late_reverb_gain",
                    clamp(eff.get("late_reverb_gain") / (scale ** exp),
                          0.0, 10.0))
        if fl & LF_REVERBDELAYSCALE:
            eff.set("late_reverb_delay",
                    clamp(eff.get("late_reverb_delay") * scale, 0.0, 0.1))
        self.slots[0].set_effect(eff)

    def _set_listener_flags(self, flags: int) -> None:
        self.listener_flags = int(flags) & 0x3F
        eff = self._reverb_effect(0)
        eff.set("decay_hf_limit", bool(self.listener_flags & LF_DECAYHFLIMIT))
        self.slots[0].set_effect(eff)

    def _reverb_effect(self, idx: int = 0):
        slot = self._ensure_slot(idx)
        if self.slot_effect_type[idx] != "eaxreverb":
            self._load_effect(idx, "eaxreverb")
        return slot._eax_effect

    # --- EAX20 listener (reverb) ---

    def set_listener(self, pid: int, value) -> None:
        """EAX20LISTENERPROPERTIES onto the slot-0 reverb
        (EaxReverbCommitter::translate, al/effects/reverb.cpp:991-1009)."""
        eff = self._reverb_effect(0)
        slot = self.slots[0]
        if pid == L20_ENVIRONMENT:
            self._set_environment(int(value))
            return
        if pid == L20_ENVIRONMENTSIZE:
            self._set_environment_size(value)
            return
        if pid == L20_FLAGS:
            self._set_listener_flags(value)
            return
        if pid == L20_ALL:
            # Whole-struct set (AllValidator2 + direct assign): every field
            # is absolute — environment size does NOT rescale here.
            self._set_environment(int(value["environment"]))
            if "environment_size" in value:
                self.listener_size = float(value["environment_size"])
            if "flags" in value:
                self._set_listener_flags(value["flags"])
            for key in ("room", "room_hf", "room_rolloff", "decay_time",
                        "decay_hf_ratio", "reflections", "reflections_delay",
                        "reverb", "reverb_delay",
                        "environment_diffusion", "air_absorption_hf"):
                if key in value:
                    self.set_listener(_L20_BY_NAME[key], value[key])
            return
        name, conv = _L20_PROPS[pid]
        eff.set(name, conv(value) if conv else value)
        slot.set_effect(eff)

    def get_listener(self, pid: int):
        eff = self._reverb_effect(0)
        if pid == L20_ENVIRONMENT:
            return self.listener_env
        if pid == L20_ENVIRONMENTSIZE:
            return self.listener_size
        if pid == L20_FLAGS:
            return self.listener_flags
        name, conv = _L20_PROPS[pid]
        v = eff.get(name)
        return gain_to_level_mb(v) if conv else v

    # --- EAX20 buffer (source) ---

    def set_source(self, source_id: int, pid: int, value) -> None:
        props = self.source_props.setdefault(source_id, EaxSourceProps())
        names = {
            B20_DIRECT: "direct", B20_DIRECTHF: "direct_hf",
            B20_ROOM: "room", B20_ROOMHF: "room_hf",
            B20_ROOMROLLOFF: "room_rolloff",
            B20_OBSTRUCTION: "obstruction",
            B20_OBSTRUCTIONLFRATIO: "obstruction_lf_ratio",
            B20_OCCLUSION: "occlusion",
            B20_OCCLUSIONLFRATIO: "occlusion_lf_ratio",
            B20_OCCLUSIONROOMRATIO: "occlusion_room_ratio",
            B20_OUTSIDEVOLUMEHF: "outside_volume_hf",
            B20_AIRABSORPTIONFACTOR: "air_absorption_factor",
            B20_FLAGS: "flags",
        }
        if pid == B20_ALL:
            for k, v in value.items():
                setattr(props, k, v)
        else:
            setattr(props, names[pid], value)
        self.commit_source(source_id)

    def get_source(self, source_id: int, pid: int):
        props = self.source_props.setdefault(source_id, EaxSourceProps())
        names = {B20_DIRECT: "direct", B20_DIRECTHF: "direct_hf",
                 B20_ROOM: "room", B20_ROOMHF: "room_hf",
                 B20_ROOMROLLOFF: "room_rolloff",
                 B20_OBSTRUCTION: "obstruction",
                 B20_OBSTRUCTIONLFRATIO: "obstruction_lf_ratio",
                 B20_OCCLUSION: "occlusion",
                 B20_OCCLUSIONLFRATIO: "occlusion_lf_ratio",
                 B20_OCCLUSIONROOMRATIO: "occlusion_room_ratio",
                 B20_OUTSIDEVOLUMEHF: "outside_volume_hf",
                 B20_AIRABSORPTIONFACTOR: "air_absorption_factor",
                 B20_FLAGS: "flags"}
        return getattr(props, names[pid])

    def commit_source(self, source_id: int) -> None:
        """Recompute the source's direct + room filter gains
        (eax_create_direct_filter_param / eax_create_room_filter_param,
        al/source.cpp:4035-4133) and apply them to the AL source."""
        src = self.ctx.sources.get(source_id)
        p = self.source_props.get(source_id)
        if src is None or p is None:
            return
        # Direct path: obstruction always; occlusion via the primary slot.
        gain_mb = float(p.obstruction) * p.obstruction_lf_ratio
        gainhf_mb = float(p.obstruction)
        if p.occlusion:
            gain_mb += _occlusion_mb(p.occlusion, p.occlusion_direct_ratio,
                                     p.occlusion_lf_ratio)
            gainhf_mb += float(p.occlusion) * p.occlusion_direct_ratio
        gainhf_mb -= gain_mb
        gain_mb += float(p.direct)
        gainhf_mb += float(p.direct_hf)
        src.set("direct_gain", level_mb_to_gain(gain_mb))
        src.set("direct_gain_hf", level_mb_to_gain(gainhf_mb))
        src.set("direct_gain_lf", 1.0)

        # Room path onto the primary fx slot (send 0); exclusion applies to
        # the send only (eax_create_room_filter_param, al/source.cpp:4100).
        slot = self.slots[self.primary_fx_slot]
        if slot is not None:
            room_mb = (_occlusion_mb(p.occlusion, p.occlusion_room_ratio,
                                     p.occlusion_lf_ratio)
                       + float(p.exclusion) * p.exclusion_lf_ratio)
            roomhf_mb = (float(p.occlusion) * p.occlusion_room_ratio
                         + float(p.exclusion))
            roomhf_mb -= room_mb
            room_mb += float(p.room)
            roomhf_mb += float(p.room_hf)
            sp = src.props.send[0]
            sp.slot = slot
            sp.gain = level_mb_to_gain(room_mb)
            sp.gain_hf = level_mb_to_gain(roomhf_mb)
            sp.gain_lf = 1.0
            src._props_dirty = True
            if src.voice is not None and src.voice.source_id == src.id:
                import dataclasses as _dc
                src.voice.props = _dc.replace(src.props)
                src.voice.props_dirty = True


# Listener property -> (efx eaxreverb prop name, mB conversion or None)
_L20_PROPS = {
    L20_ROOM: ("gain", level_mb_to_gain),
    L20_ROOMHF: ("gain_hf", level_mb_to_gain),
    L20_ROOMROLLOFF: ("room_rolloff_factor", None),
    L20_DECAYTIME: ("decay_time", None),
    L20_DECAYHFRATIO: ("decay_hf_ratio", None),
    L20_REFLECTIONS: ("reflections_gain", level_mb_to_gain),
    L20_REFLECTIONSDELAY: ("reflections_delay", None),
    L20_REVERB: ("late_reverb_gain", level_mb_to_gain),
    L20_REVERBDELAY: ("late_reverb_delay", None),
    L20_ENVIRONMENTDIFFUSION: ("diffusion", None),
    L20_AIRABSORPTIONHF: ("air_absorption_gain_hf", level_mb_to_gain),
}
_L20_BY_NAME = {"room": L20_ROOM, "room_hf": L20_ROOMHF,
                "room_rolloff": L20_ROOMROLLOFF, "decay_time": L20_DECAYTIME,
                "decay_hf_ratio": L20_DECAYHFRATIO,
                "reflections": L20_REFLECTIONS,
                "reflections_delay": L20_REFLECTIONSDELAY,
                "reverb": L20_REVERB, "reverb_delay": L20_REVERBDELAY,
                "environment_diffusion": L20_ENVIRONMENTDIFFUSION,
                "air_absorption_hf": L20_AIRABSORPTIONHF,
                "environment_size": L20_ENVIRONMENTSIZE}


def get_eax(ctx) -> EaxContext:
    from ..alc import config as alconf

    if not alconf.config_value_bool("eax", "enable", True):
        # `[eax] enable = false` (alc/alc.cpp:2132): the property sets
        # dispatch as unknown.
        raise ValueError("EAX disabled by config ([eax] enable)")
    st = getattr(ctx, "_eax_state", None)
    if st is None:
        st = ctx._eax_state = EaxContext(ctx)
    return st


def eax_set(ctx, property_set: str, pid: int, source_id: int, value) -> None:
    """EAXSet (al/eax/call.cpp dispatch by property-set GUID)."""
    st = get_eax(ctx)
    ps = property_set.lower()
    pid &= ~EAX_DEFER
    if ps in (DSPROPSETID_EAX20_ListenerProperties,
              DSPROPSETID_EAX30_ListenerProperties):
        st.set_listener(pid, value)
    elif ps in (DSPROPSETID_EAX20_BufferProperties,
                DSPROPSETID_EAX30_BufferProperties,
                EAXPROPERTYID_EAX40_Source, EAXPROPERTYID_EAX50_Source):
        st.set_source(source_id, pid, value)
    elif ps in _FXSLOT_GUIDS:
        fxslot_set(st, _FXSLOT_GUIDS[ps], pid, value)
    elif ps in (EAXPROPERTYID_EAX40_Context, EAXPROPERTYID_EAX50_Context):
        context_set(st, pid, value)
    else:
        raise ValueError(f"unknown EAX property set {property_set}")


def eax_get(ctx, property_set: str, pid: int, source_id: int):
    st = get_eax(ctx)
    ps = property_set.lower()
    pid &= ~EAX_DEFER
    if ps in (DSPROPSETID_EAX20_ListenerProperties,
              DSPROPSETID_EAX30_ListenerProperties):
        return st.get_listener(pid)
    if ps in (DSPROPSETID_EAX20_BufferProperties,
              DSPROPSETID_EAX30_BufferProperties,
              EAXPROPERTYID_EAX40_Source, EAXPROPERTYID_EAX50_Source):
        return st.get_source(source_id, pid)
    if ps in _FXSLOT_GUIDS:
        return fxslot_get(st, _FXSLOT_GUIDS[ps], pid)
    if ps in (EAXPROPERTYID_EAX40_Context, EAXPROPERTYID_EAX50_Context):
        return context_get(st, pid)
    raise ValueError(f"unknown EAX property set {property_set}")


# --- raw (byte-level) EAXSet/EAXGet marshalling --------------------------------
# The C ABI hands EAXSet/EAXGet opaque value buffers (al/eax/call.h EaxCall
# wraps them); these tables give each EAX 2.0 property its wire type so the
# shim can decode to the structured values eax_set/eax_get exchange.

import struct as _struct

# EAX20LISTENERPROPERTIES field order + codes (al/eax/api.h:164-180)
_L20_STRUCT = "<llffflflfLfffL"
_L20_FIELDS = ("room", "room_hf", "room_rolloff", "decay_time",
               "decay_hf_ratio", "reflections", "reflections_delay",
               "reverb", "reverb_delay", "environment", "environment_size",
               "environment_diffusion", "air_absorption_hf", "flags")
_L20_TYPES = {
    L20_ROOM: "l", L20_ROOMHF: "l", L20_ROOMROLLOFF: "f",
    L20_DECAYTIME: "f", L20_DECAYHFRATIO: "f", L20_REFLECTIONS: "l",
    L20_REFLECTIONSDELAY: "f", L20_REVERB: "l", L20_REVERBDELAY: "f",
    L20_ENVIRONMENT: "L", L20_ENVIRONMENTSIZE: "f",
    L20_ENVIRONMENTDIFFUSION: "f", L20_AIRABSORPTIONHF: "f",
    L20_FLAGS: "L",
}

# EAX20BUFFERPROPERTIES field order + codes (al/eax/api.h:239-254)
_B20_STRUCT = "<llllflflfflfL"
_B20_FIELDS = ("direct", "direct_hf", "room", "room_hf", "room_rolloff",
               "obstruction", "obstruction_lf_ratio", "occlusion",
               "occlusion_lf_ratio", "occlusion_room_ratio",
               "outside_volume_hf", "air_absorption_factor", "flags")
_B20_TYPES = {
    B20_DIRECT: "l", B20_DIRECTHF: "l", B20_ROOM: "l", B20_ROOMHF: "l",
    B20_ROOMROLLOFF: "f", B20_OBSTRUCTION: "l",
    B20_OBSTRUCTIONLFRATIO: "f", B20_OCCLUSION: "l",
    B20_OCCLUSIONLFRATIO: "f", B20_OCCLUSIONROOMRATIO: "f",
    B20_OUTSIDEVOLUMEHF: "l", B20_AIRABSORPTIONFACTOR: "f",
    B20_FLAGS: "L",
}

_SCALAR = {"l": ("<l", int), "L": ("<L", int), "f": ("<f", float)}

# EAXSOURCE_PROPERTY (api.h:448-486): EAX3.0 renumbered the source set and
# EAX4.0/5.0 extend it — NOT the EAX2.0 buffer numbering.
(SRC_NONE, SRC_ALL, SRC_OBSTRUCTIONPARAMS, SRC_OCCLUSIONPARAMS,
 SRC_EXCLUSIONPARAMS, SRC_DIRECT, SRC_DIRECTHF, SRC_ROOM, SRC_ROOMHF,
 SRC_OBSTRUCTION, SRC_OBSTRUCTIONLFRATIO, SRC_OCCLUSION,
 SRC_OCCLUSIONLFRATIO, SRC_OCCLUSIONROOMRATIO, SRC_OCCLUSIONDIRECTRATIO,
 SRC_EXCLUSION, SRC_EXCLUSIONLFRATIO, SRC_OUTSIDEVOLUMEHF,
 SRC_DOPPLERFACTOR, SRC_ROLLOFFFACTOR, SRC_ROOMROLLOFFFACTOR,
 SRC_AIRABSORPTIONFACTOR, SRC_FLAGS, SRC_SENDPARAMS, SRC_ALLSENDPARAMS,
 SRC_OCCLUSIONSENDPARAMS, SRC_EXCLUSIONSENDPARAMS, SRC_ACTIVEFXSLOTID,
 SRC_MACROFXFACTOR, SRC_SPEAKERLEVELS, SRC_ALL2DPARAMS) = range(31)

_SRC_ATTRS = {
    SRC_DIRECT: ("direct", "l"), SRC_DIRECTHF: ("direct_hf", "l"),
    SRC_ROOM: ("room", "l"), SRC_ROOMHF: ("room_hf", "l"),
    SRC_OBSTRUCTION: ("obstruction", "l"),
    SRC_OBSTRUCTIONLFRATIO: ("obstruction_lf_ratio", "f"),
    SRC_OCCLUSION: ("occlusion", "l"),
    SRC_OCCLUSIONLFRATIO: ("occlusion_lf_ratio", "f"),
    SRC_OCCLUSIONROOMRATIO: ("occlusion_room_ratio", "f"),
    SRC_OCCLUSIONDIRECTRATIO: ("occlusion_direct_ratio", "f"),
    SRC_EXCLUSION: ("exclusion", "l"),
    SRC_EXCLUSIONLFRATIO: ("exclusion_lf_ratio", "f"),
    SRC_OUTSIDEVOLUMEHF: ("outside_volume_hf", "l"),
    SRC_DOPPLERFACTOR: ("doppler_factor", "f"),
    SRC_ROLLOFFFACTOR: ("rolloff_factor", "f"),
    SRC_ROOMROLLOFFFACTOR: ("room_rolloff", "f"),
    SRC_AIRABSORPTIONFACTOR: ("air_absorption_factor", "f"),
    SRC_FLAGS: ("flags", "L"),
    SRC_MACROFXFACTOR: ("macro_fx_factor", "f"),
}

# EAX30SOURCEPROPERTIES wire layout (api.h:636-650); EAX50 appends
# flMacroFXFactor.
_SRC_ALL_STRUCT = "<lllllflffflflffffL"
_SRC_ALL_FIELDS = (
    "direct", "direct_hf", "room", "room_hf", "obstruction",
    "obstruction_lf_ratio", "occlusion", "occlusion_lf_ratio",
    "occlusion_room_ratio", "occlusion_direct_ratio", "exclusion",
    "exclusion_lf_ratio", "outside_volume_hf", "doppler_factor",
    "rolloff_factor", "room_rolloff", "air_absorption_factor", "flags")


def _src_set_raw(st: EaxContext, eax5: bool, pid: int, source_id: int,
                 raw: bytes) -> int:
    """EAX3.0+ source property decode + apply (al/source.cpp eax3/4/5_set)."""
    props = st.source_props.setdefault(source_id, EaxSourceProps())
    if pid == SRC_NONE:
        return 0
    if pid == SRC_ALL or pid == SRC_ALL2DPARAMS:
        if pid == SRC_ALL:
            vals = _struct.unpack_from(_SRC_ALL_STRUCT, raw, 0)
            for f, v in zip(_SRC_ALL_FIELDS, vals):
                setattr(props, f, v)
            if eax5 and len(raw) >= _struct.calcsize(_SRC_ALL_STRUCT) + 4:
                props.macro_fx_factor = _struct.unpack_from(
                    "<f", raw, _struct.calcsize(_SRC_ALL_STRUCT))[0]
        else:   # EAXSOURCE2DPROPERTIES: direct/directhf/room/roomhf/flags
            d, dhf, r, rhf, fl = _struct.unpack_from("<llllL", raw, 0)
            props.direct, props.direct_hf = d, dhf
            props.room, props.room_hf, props.flags = r, rhf, fl
    elif pid == SRC_OBSTRUCTIONPARAMS:
        props.obstruction, props.obstruction_lf_ratio = \
            _struct.unpack_from("<lf", raw, 0)
    elif pid == SRC_OCCLUSIONPARAMS:
        (props.occlusion, props.occlusion_lf_ratio,
         props.occlusion_room_ratio, props.occlusion_direct_ratio) = \
            _struct.unpack_from("<lfff", raw, 0)
    elif pid == SRC_EXCLUSIONPARAMS:
        props.exclusion, props.exclusion_lf_ratio = \
            _struct.unpack_from("<lf", raw, 0)
    elif pid == SRC_SPEAKERLEVELS:
        n = min(len(raw) // 8, 9)
        levels = list(props.speaker_levels)
        for i in range(n):
            sid, lvl = _struct.unpack_from("<ll", raw, i * 8)
            if 1 <= sid <= 9:
                levels[sid - 1] = int(lvl)
        props.speaker_levels = tuple(levels)
    elif pid in _SRC_ATTRS:
        name, code = _SRC_ATTRS[pid]
        fmt, conv = _SCALAR[code]
        setattr(props, name, conv(_struct.unpack_from(fmt, raw, 0)[0]))
    elif pid in (SRC_SENDPARAMS, SRC_ALLSENDPARAMS, SRC_OCCLUSIONSENDPARAMS,
                 SRC_EXCLUSIONSENDPARAMS, SRC_ACTIVEFXSLOTID):
        # Per-slot send routing beyond the primary slot: accepted (the
        # renderer routes through the primary slot; al/source.cpp:4433).
        return 0
    else:
        return 0xA002
    st.commit_source(source_id)
    return 0


def _src_get_raw(st: EaxContext, eax5: bool, pid: int, source_id: int,
                 size: int) -> bytes | None:
    props = st.source_props.setdefault(source_id, EaxSourceProps())
    if pid == SRC_ALL:
        vals = [getattr(props, f) for f in _SRC_ALL_FIELDS]
        packed = _struct.pack(_SRC_ALL_STRUCT, *[
            _coerce(_SRC_ALL_STRUCT, i, v) for i, v in enumerate(vals)])
        if eax5:
            packed += _struct.pack("<f", float(props.macro_fx_factor))
        return packed[:size]
    if pid == SRC_ALL2DPARAMS:
        return _struct.pack("<llllL", int(props.direct),
                            int(props.direct_hf), int(props.room),
                            int(props.room_hf), int(props.flags))[:size]
    if pid == SRC_OBSTRUCTIONPARAMS:
        return _struct.pack("<lf", int(props.obstruction),
                            float(props.obstruction_lf_ratio))[:size]
    if pid == SRC_OCCLUSIONPARAMS:
        return _struct.pack("<lfff", int(props.occlusion),
                            float(props.occlusion_lf_ratio),
                            float(props.occlusion_room_ratio),
                            float(props.occlusion_direct_ratio))[:size]
    if pid == SRC_EXCLUSIONPARAMS:
        return _struct.pack("<lf", int(props.exclusion),
                            float(props.exclusion_lf_ratio))[:size]
    if pid == SRC_SPEAKERLEVELS:
        out = b"".join(_struct.pack("<ll", i + 1, lvl)
                       for i, lvl in enumerate(props.speaker_levels))
        return out[:size]
    if pid in _SRC_ATTRS:
        name, code = _SRC_ATTRS[pid]
        fmt, conv = _SCALAR[code]
        return _struct.pack(fmt, conv(getattr(props, name)))[:size]
    return None


def _bytes_to_guid(raw: bytes) -> str:
    d1, d2, d3 = _struct.unpack_from("<IHH", raw, 0)
    d4 = raw[8:16]
    return (f"{d1:08x}-{d2:04x}-{d3:04x}-{d4[0]:02x}{d4[1]:02x}-"
            + "".join(f"{b:02x}" for b in d4[2:]))


def eax_set_raw(ctx, guid: str, pid: int, source_id: int,
                raw: bytes) -> int:
    """EAXSet with an opaque value buffer: decode per property, dispatch.

    Returns an AL error code (0 on success), matching the C ABI contract
    (al/eax/api.cpp EAXSet returns ALenum)."""
    ps = guid.lower()
    p = pid & ~EAX_DEFER
    try:
        if ps in (DSPROPSETID_EAX20_ListenerProperties,
                  DSPROPSETID_EAX30_ListenerProperties):
            if p == L20_ALL:
                vals = _struct.unpack_from(_L20_STRUCT, raw, 0)
                value = dict(zip(_L20_FIELDS, vals))
            elif p == L20_NONE:
                return 0
            else:
                fmt, conv = _SCALAR[_L20_TYPES[p]]
                value = conv(_struct.unpack_from(fmt, raw, 0)[0])
            eax_set(ctx, ps, p, source_id, value)
            return 0
        if ps == DSPROPSETID_EAX20_BufferProperties:
            if p == B20_ALL:
                vals = _struct.unpack_from(_B20_STRUCT, raw, 0)
                value = dict(zip(_B20_FIELDS, vals))
            elif p == B20_NONE:
                return 0
            else:
                fmt, conv = _SCALAR[_B20_TYPES[p]]
                value = conv(_struct.unpack_from(fmt, raw, 0)[0])
            eax_set(ctx, ps, p, source_id, value)
            return 0
        if ps in (DSPROPSETID_EAX30_BufferProperties,
                  EAXPROPERTYID_EAX40_Source, EAXPROPERTYID_EAX50_Source):
            # EAX3.0 renumbered the source property set (api.h:448-486).
            return _src_set_raw(get_eax(ctx),
                                ps == EAXPROPERTYID_EAX50_Source, p,
                                source_id, raw)
        r = eax_set_raw_v45(ctx, ps, p, source_id, raw)
        if r is not None:
            return r
    except (KeyError, ValueError, _struct.error):
        return 0xA002       # AL_INVALID_ENUM
    return 0xA002


def _coerce(fmt: str, index: int, v):
    code = [c for c in fmt if c in "lLf"][index]
    if code == "f":
        return float(v)
    return int(v)


def eax_get_raw(ctx, guid: str, pid: int, source_id: int,
                size: int) -> bytes | None:
    """EAXGet: encode the property value back into its wire format."""
    ps = guid.lower()
    p = pid & ~EAX_DEFER
    try:
        if ps in (DSPROPSETID_EAX20_ListenerProperties,
                  DSPROPSETID_EAX30_ListenerProperties):
            if p == L20_ALL:
                st = get_eax(ctx)
                d = {f: eax_get(ctx, ps, _L20_BY_NAME[f], source_id)
                     for f in _L20_FIELDS if f in _L20_BY_NAME}
                d["environment"] = st.listener_env
                d["environment_size"] = st.listener_size
                d["flags"] = st.listener_flags
                packed = _struct.pack(
                    _L20_STRUCT, *[_coerce(_L20_STRUCT, i, d[f])
                                   for i, f in enumerate(_L20_FIELDS)])
                return packed[:size]
            fmt, conv = _SCALAR[_L20_TYPES[p]]
            v = eax_get(ctx, ps, p, source_id)
            return _struct.pack(fmt, conv(v))[:size]
        if ps == DSPROPSETID_EAX20_BufferProperties:
            if p == B20_ALL:
                vals = [eax_get(ctx, ps, pidk, source_id)
                        for pidk in (B20_DIRECT, B20_DIRECTHF, B20_ROOM,
                                     B20_ROOMHF, B20_ROOMROLLOFF,
                                     B20_OBSTRUCTION, B20_OBSTRUCTIONLFRATIO,
                                     B20_OCCLUSION, B20_OCCLUSIONLFRATIO,
                                     B20_OCCLUSIONROOMRATIO,
                                     B20_OUTSIDEVOLUMEHF,
                                     B20_AIRABSORPTIONFACTOR, B20_FLAGS)]
                return _struct.pack(_B20_STRUCT, *[
                    _coerce(_B20_STRUCT, i, v) for i, v in enumerate(vals)
                ])[:size]
            fmt, conv = _SCALAR[_B20_TYPES[p]]
            v = eax_get(ctx, ps, p, source_id)
            return _struct.pack(fmt, conv(v))[:size]
        if ps in (DSPROPSETID_EAX30_BufferProperties,
                  EAXPROPERTYID_EAX40_Source, EAXPROPERTYID_EAX50_Source):
            return _src_get_raw(get_eax(ctx),
                                ps == EAXPROPERTYID_EAX50_Source, p,
                                source_id, size)
        return eax_get_raw_v45(ctx, ps, p, source_id, size)
    except (KeyError, ValueError, _struct.error):
        return None
    return None


# ==============================================================================
# EAX 4.0/5.0: fx-slot properties, per-slot EAXREVERB parameter sets, and
# EAX50 context properties (al/eax/api.h:326-450, 713-839; fx_slots.cpp).

EAXPROPERTYID_EAX50_Context = "57e13437-b932-4ab2-b8bd-5266c1a887ee"
EAXPROPERTYID_EAX50_FXSlot0 = "91f9590f-c388-407a-84b0-1bae0ef71abc"
EAXPROPERTYID_EAX50_FXSlot1 = "8f5f7aca-9608-4965-8137-8213c7b9d9de"
EAXPROPERTYID_EAX50_FXSlot2 = "3c0f5252-9834-46f0-a1d8-5b95c4a00a30"
EAXPROPERTYID_EAX50_FXSlot3 = "e2eb0eaa-e806-45e7-9f86-06c1571a6fa3"
EAXPROPERTYID_EAX50_Source = "5edf82f0-24a7-4f38-8e64-2f09ca05dee1"

_FXSLOT_GUIDS.update({EAXPROPERTYID_EAX50_FXSlot0: 0,
                      EAXPROPERTYID_EAX50_FXSlot1: 1,
                      EAXPROPERTYID_EAX50_FXSlot2: 2,
                      EAXPROPERTYID_EAX50_FXSlot3: 3})

# EAXFXSLOT_PROPERTY (api.h:383-396): slot props sit at 0x10000+; ids below
# dispatch to the loaded effect's parameter set.
FXSLOT_NONE = 0x10000
FXSLOT_ALLPARAMETERS = 0x10001
FXSLOT_LOADEFFECT = 0x10002
FXSLOT_VOLUME = 0x10003
FXSLOT_LOCK = 0x10004
FXSLOT_FLAGS = 0x10005
FXSLOT_OCCLUSION = 0x10006
FXSLOT_OCCLUSIONLFRATIO = 0x10007

# EAXREVERB_PROPERTY (api.h:713-740)
RV_NONE, RV_ALL, RV_ENVIRONMENT, RV_ENVIRONMENTSIZE, \
    RV_ENVIRONMENTDIFFUSION, RV_ROOM, RV_ROOMHF, RV_ROOMLF, RV_DECAYTIME, \
    RV_DECAYHFRATIO, RV_DECAYLFRATIO, RV_REFLECTIONS, RV_REFLECTIONSDELAY, \
    RV_REFLECTIONSPAN, RV_REVERB, RV_REVERBDELAY, RV_REVERBPAN, \
    RV_ECHOTIME, RV_ECHODEPTH, RV_MODULATIONTIME, RV_MODULATIONDEPTH, \
    RV_AIRABSORPTIONHF, RV_HFREFERENCE, RV_LFREFERENCE, \
    RV_ROOMROLLOFFFACTOR, RV_FLAGS = range(26)

# pid -> (efx eaxreverb prop, mB conversion or None); pans handled apart.
_RV_PROPS = {
    RV_ENVIRONMENTDIFFUSION: ("diffusion", None),
    RV_ROOM: ("gain", level_mb_to_gain),
    RV_ROOMHF: ("gain_hf", level_mb_to_gain),
    RV_ROOMLF: ("gain_lf", level_mb_to_gain),
    RV_DECAYTIME: ("decay_time", None),
    RV_DECAYHFRATIO: ("decay_hf_ratio", None),
    RV_DECAYLFRATIO: ("decay_lf_ratio", None),
    RV_REFLECTIONS: ("reflections_gain", level_mb_to_gain),
    RV_REFLECTIONSDELAY: ("reflections_delay", None),
    RV_REVERB: ("late_reverb_gain", level_mb_to_gain),
    RV_REVERBDELAY: ("late_reverb_delay", None),
    RV_ECHOTIME: ("echo_time", None),
    RV_ECHODEPTH: ("echo_depth", None),
    RV_MODULATIONTIME: ("modulation_time", None),
    RV_MODULATIONDEPTH: ("modulation_depth", None),
    RV_AIRABSORPTIONHF: ("air_absorption_gain_hf", level_mb_to_gain),
    RV_HFREFERENCE: ("hf_reference", None),
    RV_LFREFERENCE: ("lf_reference", None),
    RV_ROOMROLLOFFFACTOR: ("room_rolloff_factor", None),
}
_RV_PANS = {RV_REFLECTIONSPAN: "reflections_pan",
            RV_REVERBPAN: "late_reverb_pan"}

# EAXREVERB env-size scaling flag bits (api.h EAXREVERBFLAGS_*)
RVF_DECAYTIMESCALE = 0x01
RVF_REFLECTIONSSCALE = 0x02
RVF_REFLECTIONSDELAYSCALE = 0x04
RVF_REVERBSCALE = 0x08
RVF_REVERBDELAYSCALE = 0x10
RVF_ECHOTIMESCALE = 0x40
RVF_MODTIMESCALE = 0x80
RVF_DECAYHFLIMIT = 0x20

_EAX_ENV_UNDEFINED = 26   # EAX_ENVIRONMENT_UNDEFINED


class _SlotReverbState:
    """Per-slot committed environment bookkeeping (EnvironmentDeferrer3 /
    EnvironmentSizeDeferrer3 state, al/effects/reverb.cpp:886-990)."""

    def __init__(self) -> None:
        self.environment = 0
        self.size = 7.5
        self.flags = 0x3F


def _slot_rv(st: EaxContext, idx: int) -> _SlotReverbState:
    slot = st._ensure_slot(idx)
    rv = getattr(slot, "_eax_rv", None)
    if rv is None:
        rv = slot._eax_rv = _SlotReverbState()
    return rv


def fxslot_set(st: EaxContext, idx: int, pid: int, value) -> None:
    """EAXSet on an fx-slot property set (fx_slots.cpp EaxFxSlot::set)."""
    slot = st._ensure_slot(idx)
    if pid >= FXSLOT_NONE:
        if pid == FXSLOT_LOADEFFECT:
            st._load_effect(idx, _EFFECT_GUIDS.get(str(value).lower(),
                                                   "null"))
        elif pid == FXSLOT_VOLUME:
            slot.gain = level_mb_to_gain(float(value))
            slot.props_dirty = True
        elif pid in (FXSLOT_LOCK, FXSLOT_FLAGS, FXSLOT_OCCLUSION,
                     FXSLOT_OCCLUSIONLFRATIO):
            setattr(slot, f"_eax_slot_{pid & 0xffff}", value)
        elif pid in (FXSLOT_NONE, FXSLOT_ALLPARAMETERS):
            if isinstance(value, dict):
                for k, v in value.items():
                    fxslot_set(st, idx, k, v)
        else:
            raise ValueError(f"fxslot pid {pid:#x}")
        return
    # Effect parameter: dispatch per the loaded effect type (only the
    # reverb set is parameterized through EAX in this build; other effect
    # loads accept LOADEFFECT + defaults, as the common titles use).
    if st.slot_effect_type[idx] != "eaxreverb":
        raise ValueError(f"effect pid {pid} on {st.slot_effect_type[idx]}")
    eff = st._reverb_effect(idx)
    rv = _slot_rv(st, idx)
    if pid == RV_ENVIRONMENT:
        env = int(value)
        if env == _EAX_ENV_UNDEFINED:
            rv.environment = env
            return
        from . import presets
        for k, v in presets.REVERB_PRESETS[EAX2_ENVIRONMENTS[env]].items():
            eff.set(k, v)
        rv.environment = env
        rv.size = _ENV_SIZES[env]
        rv.flags = _ENV_FLAGS[env]
        slot.set_effect(eff)
        return
    if pid == RV_ENVIRONMENTSIZE:
        _rv_environment_size(eff, rv, float(value))
        slot.set_effect(eff)
        return
    if pid == RV_FLAGS:
        rv.flags = int(value)
        eff.set("decay_hf_limit", bool(rv.flags & RVF_DECAYHFLIMIT))
        slot.set_effect(eff)
        return
    if pid == RV_ALL:
        rv.environment = int(value.get("environment", _EAX_ENV_UNDEFINED))
        rv.size = float(value.get("environment_size", rv.size))
        if "flags" in value:
            rv.flags = int(value["flags"])
            eff.set("decay_hf_limit", bool(rv.flags & RVF_DECAYHFLIMIT))
        for k, v in value.items():
            if k in _RV_BY_NAME:
                name, conv = _RV_PROPS[_RV_BY_NAME[k]]
                eff.set(name, conv(v) if conv else v)
            elif k == "reflections_pan":
                eff.set("reflections_pan", tuple(v))
            elif k == "reverb_pan":
                eff.set("late_reverb_pan", tuple(v))
        slot.set_effect(eff)
        return
    if pid in _RV_PANS:
        eff.set(_RV_PANS[pid], tuple(float(x) for x in value))
        slot.set_effect(eff)
        return
    name, conv = _RV_PROPS[pid]
    eff.set(name, conv(value) if conv else value)
    slot.set_effect(eff)


def fxslot_get(st: EaxContext, idx: int, pid: int):
    slot = st._ensure_slot(idx)
    if pid >= FXSLOT_NONE:
        if pid == FXSLOT_VOLUME:
            return gain_to_level_mb(slot.gain)
        if pid in (FXSLOT_LOCK, FXSLOT_FLAGS, FXSLOT_OCCLUSION,
                   FXSLOT_OCCLUSIONLFRATIO):
            return getattr(slot, f"_eax_slot_{pid & 0xffff}", 0)
        raise ValueError(f"fxslot pid {pid:#x}")
    if st.slot_effect_type[idx] != "eaxreverb":
        raise ValueError(f"effect pid {pid} on {st.slot_effect_type[idx]}")
    eff = st._reverb_effect(idx)
    rv = _slot_rv(st, idx)
    if pid == RV_ENVIRONMENT:
        return rv.environment
    if pid == RV_ENVIRONMENTSIZE:
        return rv.size
    if pid == RV_FLAGS:
        return rv.flags
    if pid in _RV_PANS:
        return tuple(eff.get(_RV_PANS[pid]))
    name, conv = _RV_PROPS[pid]
    v = eff.get(name)
    return gain_to_level_mb(v) if conv else v


def _rv_environment_size(eff, rv: _SlotReverbState, size: float) -> None:
    """EnvironmentSizeDeferrer3 (al/effects/reverb.cpp:899-990)."""
    if size == rv.size or rv.size <= 0.0:
        rv.size = size
        return
    scale = size / rv.size
    rv.size = size
    rv.environment = _EAX_ENV_UNDEFINED
    fl = rv.flags
    clamp = lambda v, lo, hi: min(max(v, lo), hi)
    if fl & RVF_DECAYTIMESCALE:
        eff.set("decay_time", clamp(eff.get("decay_time") * scale, 0.1, 20.0))
    if (fl & RVF_REFLECTIONSSCALE) and (fl & RVF_REFLECTIONSDELAYSCALE):
        eff.set("reflections_gain",
                clamp(eff.get("reflections_gain") / scale, 0.0, 3.16))
    if fl & RVF_REFLECTIONSDELAYSCALE:
        eff.set("reflections_delay",
                clamp(eff.get("reflections_delay") * scale, 0.0, 0.3))
    if fl & RVF_REVERBSCALE:
        exp = 1.0 if fl & RVF_DECAYTIMESCALE else 1.5
        eff.set("late_reverb_gain",
                clamp(eff.get("late_reverb_gain") / (scale ** exp), 0.0, 10.0))
    if fl & RVF_REVERBDELAYSCALE:
        eff.set("late_reverb_delay",
                clamp(eff.get("late_reverb_delay") * scale, 0.0, 0.1))
    if fl & RVF_ECHOTIMESCALE:
        eff.set("echo_time", clamp(eff.get("echo_time") * scale, 0.075, 0.25))
    if fl & RVF_MODTIMESCALE:
        eff.set("modulation_time",
                clamp(eff.get("modulation_time") * scale, 0.04, 4.0))


_RV_BY_NAME = {
    "environment_diffusion": RV_ENVIRONMENTDIFFUSION, "room": RV_ROOM,
    "room_hf": RV_ROOMHF, "room_lf": RV_ROOMLF, "decay_time": RV_DECAYTIME,
    "decay_hf_ratio": RV_DECAYHFRATIO, "decay_lf_ratio": RV_DECAYLFRATIO,
    "reflections": RV_REFLECTIONS,
    "reflections_delay": RV_REFLECTIONSDELAY, "reverb": RV_REVERB,
    "reverb_delay": RV_REVERBDELAY, "echo_time": RV_ECHOTIME,
    "echo_depth": RV_ECHODEPTH, "modulation_time": RV_MODULATIONTIME,
    "modulation_depth": RV_MODULATIONDEPTH,
    "air_absorption_hf": RV_AIRABSORPTIONHF,
    "hf_reference": RV_HFREFERENCE, "lf_reference": RV_LFREFERENCE,
    "room_rolloff_factor": RV_ROOMROLLOFFFACTOR,
}

# EAXCONTEXT_PROPERTY (api.h:326-339)
CTX_NONE, CTX_ALL, CTX_PRIMARYFXSLOTID, CTX_DISTANCEFACTOR, \
    CTX_AIRABSORPTIONHF, CTX_HFREFERENCE, CTX_LASTERROR, \
    CTX_SPEAKERCONFIG, CTX_EAXSESSION, CTX_MACROFXFACTOR = range(10)


def context_set(st: EaxContext, pid: int, value) -> None:
    """EAX 4.0/5.0 context properties (al/eax/context.cpp Eax*Setters)."""
    if pid == CTX_PRIMARYFXSLOTID:
        st.primary_fx_slot = _FXSLOT_GUIDS.get(str(value).lower(), 0)
    elif pid == CTX_DISTANCEFACTOR:
        st.distance_factor = float(value)
    elif pid == CTX_AIRABSORPTIONHF:
        st.air_absorption_hf = float(value)
    elif pid == CTX_HFREFERENCE:
        st.hf_reference = float(value)
    elif pid == CTX_SPEAKERCONFIG:          # EAX50
        st.speaker_config = int(value)
    elif pid == CTX_EAXSESSION:             # EAX50: {version, max_sends}
        st.eax_session = value
    elif pid == CTX_MACROFXFACTOR:          # EAX50
        st.macro_fx_factor = float(value)
    elif pid in (CTX_NONE, CTX_LASTERROR):
        pass
    else:
        raise ValueError(f"context pid {pid:#x}")


def context_get(st: EaxContext, pid: int):
    if pid == CTX_PRIMARYFXSLOTID:
        inv = {0: EAXPROPERTYID_EAX40_FXSlot0,
               1: EAXPROPERTYID_EAX40_FXSlot1,
               2: EAXPROPERTYID_EAX40_FXSlot2,
               3: EAXPROPERTYID_EAX40_FXSlot3}
        return inv[st.primary_fx_slot]
    if pid == CTX_DISTANCEFACTOR:
        return getattr(st, "distance_factor", 1.0)
    if pid == CTX_AIRABSORPTIONHF:
        return getattr(st, "air_absorption_hf", -5.0)
    if pid == CTX_HFREFERENCE:
        return getattr(st, "hf_reference", 5000.0)
    if pid == CTX_SPEAKERCONFIG:
        return getattr(st, "speaker_config", 0)
    if pid == CTX_MACROFXFACTOR:
        return getattr(st, "macro_fx_factor", 0.0)
    if pid == CTX_LASTERROR:
        return 0
    raise ValueError(f"context pid {pid:#x}")


# --- raw marshalling for the EAX4/5 property sets -------------------------------

# EAXREVERBPROPERTIES wire layout (api.h:810-839)
_RVALL_STRUCT = "<LfflllffflffffflfffffffffffL"
_RVALL_FIELDS = (
    "environment", "environment_size", "environment_diffusion", "room",
    "room_hf", "room_lf", "decay_time", "decay_hf_ratio", "decay_lf_ratio",
    "reflections", "reflections_delay", "rp0", "rp1", "rp2", "reverb",
    "reverb_delay", "vp0", "vp1", "vp2", "echo_time", "echo_depth",
    "modulation_time", "modulation_depth", "air_absorption_hf",
    "hf_reference", "lf_reference", "room_rolloff_factor", "flags")

_RV_TYPES = {
    RV_ENVIRONMENT: "L", RV_ENVIRONMENTSIZE: "f",
    RV_ENVIRONMENTDIFFUSION: "f", RV_ROOM: "l", RV_ROOMHF: "l",
    RV_ROOMLF: "l", RV_DECAYTIME: "f", RV_DECAYHFRATIO: "f",
    RV_DECAYLFRATIO: "f", RV_REFLECTIONS: "l", RV_REFLECTIONSDELAY: "f",
    RV_REVERB: "l", RV_REVERBDELAY: "f", RV_ECHOTIME: "f",
    RV_ECHODEPTH: "f", RV_MODULATIONTIME: "f", RV_MODULATIONDEPTH: "f",
    RV_AIRABSORPTIONHF: "f", RV_HFREFERENCE: "f", RV_LFREFERENCE: "f",
    RV_ROOMROLLOFFFACTOR: "f", RV_FLAGS: "L",
}

_FXSLOT_TYPES = {FXSLOT_VOLUME: "l", FXSLOT_LOCK: "l", FXSLOT_FLAGS: "L",
                 FXSLOT_OCCLUSION: "l", FXSLOT_OCCLUSIONLFRATIO: "f"}
_CTX_TYPES = {CTX_DISTANCEFACTOR: "f", CTX_AIRABSORPTIONHF: "f",
              CTX_HFREFERENCE: "f", CTX_SPEAKERCONFIG: "L",
              CTX_MACROFXFACTOR: "f"}


def _rvall_decode(raw: bytes) -> dict:
    vals = dict(zip(_RVALL_FIELDS, _struct.unpack_from(_RVALL_STRUCT, raw)))
    vals["reflections_pan"] = (vals.pop("rp0"), vals.pop("rp1"),
                               vals.pop("rp2"))
    vals["reverb_pan"] = (vals.pop("vp0"), vals.pop("vp1"), vals.pop("vp2"))
    return vals


def eax_set_raw_v45(ctx, ps: str, pid: int, source_id: int,
                    raw: bytes) -> int | None:
    """EAX4/5 half of eax_set_raw; None = property set not ours."""
    st = get_eax(ctx)
    if ps in _FXSLOT_GUIDS:
        idx = _FXSLOT_GUIDS[ps]
        try:
            if pid == FXSLOT_LOADEFFECT and len(raw) >= 16:
                fxslot_set(st, idx, pid, _bytes_to_guid(raw))
            elif pid in _FXSLOT_TYPES:
                fmt, conv = _SCALAR[_FXSLOT_TYPES[pid]]
                fxslot_set(st, idx, pid,
                           conv(_struct.unpack_from(fmt, raw, 0)[0]))
            elif pid == RV_ALL:
                fxslot_set(st, idx, pid, _rvall_decode(raw))
            elif pid in _RV_PANS:
                fxslot_set(st, idx, pid,
                           _struct.unpack_from("<fff", raw, 0))
            elif pid in _RV_TYPES:
                fmt, conv = _SCALAR[_RV_TYPES[pid]]
                fxslot_set(st, idx, pid,
                           conv(_struct.unpack_from(fmt, raw, 0)[0]))
            elif pid in (FXSLOT_NONE, RV_NONE):
                pass
            else:
                return 0xA002
            return 0
        except (KeyError, ValueError, _struct.error):
            return 0xA002
    if ps in (EAXPROPERTYID_EAX40_Context, EAXPROPERTYID_EAX50_Context):
        try:
            if pid == CTX_PRIMARYFXSLOTID and len(raw) >= 16:
                context_set(st, pid, _bytes_to_guid(raw))
            elif pid == CTX_EAXSESSION and len(raw) >= 8:
                ver, sends = _struct.unpack_from("<LL", raw, 0)
                context_set(st, pid, {"version": ver, "max_sends": sends})
            elif pid in _CTX_TYPES:
                fmt, conv = _SCALAR[_CTX_TYPES[pid]]
                context_set(st, pid,
                            conv(_struct.unpack_from(fmt, raw, 0)[0]))
            elif pid in (CTX_NONE, CTX_LASTERROR):
                pass
            else:
                return 0xA002
            return 0
        except (KeyError, ValueError, _struct.error):
            return 0xA002
    return None


def eax_get_raw_v45(ctx, ps: str, pid: int, source_id: int,
                    size: int) -> bytes | None | int:
    st = get_eax(ctx)
    if ps in _FXSLOT_GUIDS:
        idx = _FXSLOT_GUIDS[ps]
        try:
            if pid == RV_ALL:
                d = {f: fxslot_get(st, idx, _RV_BY_NAME[f])
                     for f in _RV_BY_NAME}
                d["environment"] = fxslot_get(st, idx, RV_ENVIRONMENT)
                d["environment_size"] = fxslot_get(st, idx,
                                                   RV_ENVIRONMENTSIZE)
                d["flags"] = fxslot_get(st, idx, RV_FLAGS)
                rp = fxslot_get(st, idx, RV_REFLECTIONSPAN)
                vp = fxslot_get(st, idx, RV_REVERBPAN)
                d.update(rp0=rp[0], rp1=rp[1], rp2=rp[2],
                         vp0=vp[0], vp1=vp[1], vp2=vp[2])
                codes = [c for c in _RVALL_STRUCT if c in "lLf"]
                vals = [float(d[f]) if codes[i] == "f" else int(d[f])
                        for i, f in enumerate(_RVALL_FIELDS)]
                return _struct.pack(_RVALL_STRUCT, *vals)[:size]
            if pid in _RV_PANS:
                v = fxslot_get(st, idx, pid)
                return _struct.pack("<fff", *[float(x) for x in v])[:size]
            if pid in _FXSLOT_TYPES:
                fmt, conv = _SCALAR[_FXSLOT_TYPES[pid]]
                return _struct.pack(fmt,
                                    conv(fxslot_get(st, idx, pid)))[:size]
            if pid in _RV_TYPES:
                fmt, conv = _SCALAR[_RV_TYPES[pid]]
                return _struct.pack(fmt,
                                    conv(fxslot_get(st, idx, pid)))[:size]
        except (KeyError, ValueError, _struct.error):
            return None
        return None
    if ps in (EAXPROPERTYID_EAX40_Context, EAXPROPERTYID_EAX50_Context):
        try:
            if pid == CTX_PRIMARYFXSLOTID:
                g = context_get(st, pid)
                parts = g.split("-")
                d1 = int(parts[0], 16)
                d2 = int(parts[1], 16)
                d3 = int(parts[2], 16)
                d4 = bytes.fromhex(parts[3] + parts[4])
                return (_struct.pack("<IHH", d1, d2, d3) + d4)[:size]
            if pid in _CTX_TYPES:
                fmt, conv = _SCALAR[_CTX_TYPES[pid]]
                return _struct.pack(fmt, conv(context_get(st, pid)))[:size]
            if pid == CTX_LASTERROR:
                return _struct.pack("<l", 0)[:size]
        except (KeyError, ValueError, _struct.error):
            return None
        return None
    return None
