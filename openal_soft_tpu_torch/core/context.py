"""Context (listener) parameters and per-voice mixing parameter calculation.

Host-side port of the reference's parameter update path (alc/alu.cpp):
CalcContextParams (:508), CalcAttn/NonAttnVoiceParams (:1655/:1707),
CalcPanningAndFilters (:1467), CalcNormalPanning (:1311), CalcHrtfPanning
(:1196).  This math runs O(voices) per *parameter update*, not per sample,
so it stays on the host in float32 numpy; only the resulting gains,
coefficients and resampler state are written into the device param table.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..constants import (
    MAX_AMBI_CHANNELS,
    MAX_PITCH,
    MAX_SEND_COUNT,
    MIXER_FRAC_BITS,
    MIXER_FRAC_ONE,
    Resampler,
)
from ..ops import spec, tables
from . import ambidefs, panning
from .devformat import CHAN_POS_MAPS, Channel, FmtChannels, is_ambisonic
from .voice import DistanceModel, DirectMode, PlayState, SpatializeMode, Voice

f32 = np.float32

GAIN_MIX_MAX = f32(1000.0)            # alc/alu.h:18 (+60 dB)
SPEED_OF_SOUND = f32(343.3)           # core/context.h:32 (m/s)
AIR_ABSORB_GAIN_HF = f32(0.99426)     # AL default
CONE_SCALE = f32(1.0)
NFC_SCALE = f32(1.0)


@dataclasses.dataclass
class ContextProps:
    """Listener properties (al/listener.cpp)."""
    position: tuple = (0.0, 0.0, 0.0)
    velocity: tuple = (0.0, 0.0, 0.0)
    orient_at: tuple = (0.0, 0.0, -1.0)
    orient_up: tuple = (0.0, 1.0, 0.0)
    gain: float = 1.0
    meters_per_unit: float = 1.0
    air_absorption_gain_hf: float = float(AIR_ABSORB_GAIN_HF)
    doppler_factor: float = 1.0
    doppler_velocity: float = 1.0
    speed_of_sound: float = float(SPEED_OF_SOUND)
    source_distance_model: bool = False
    distance_model: DistanceModel = DistanceModel.INVERSE_CLAMPED


@dataclasses.dataclass
class ContextParams:
    """Derived listener-space transform (CalcContextParams, alu.cpp:508-555)."""
    position: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(3, f32))
    matrix: np.ndarray = dataclasses.field(default_factory=lambda: np.eye(4, dtype=f32))
    velocity: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(3, f32))
    gain: f32 = f32(1.0)
    meters_per_unit: f32 = f32(1.0)
    air_absorption_gain_hf: f32 = AIR_ABSORB_GAIN_HF
    doppler_factor: f32 = f32(1.0)
    speed_of_sound: f32 = SPEED_OF_SOUND
    source_distance_model: bool = False
    distance_model: DistanceModel = DistanceModel.INVERSE_CLAMPED


def _normalize(v: np.ndarray) -> tuple[np.ndarray, f32]:
    length = f32(np.sqrt(f32(np.dot(v, v))))
    if length > 0.0:
        return (v / length).astype(f32), length
    return v.astype(f32), f32(0.0)


def calc_context_params(props: ContextProps, gain_boost: float = 1.0) -> ContextParams:
    n, _ = _normalize(np.array(props.orient_at, f32))
    v, _ = _normalize(np.array(props.orient_up, f32))
    u, _ = _normalize(np.cross(n, v).astype(f32))
    # Row-major listener rotation (alu.cpp:525-529); rows are U, V, -N.
    rot = np.array([
        [u[0], v[0], -n[0], 0.0],
        [u[1], v[1], -n[1], 0.0],
        [u[2], v[2], -n[2], 0.0],
        [0.0, 0.0, 0.0, 1.0]], f32)
    vel = np.array(props.velocity, f32)
    return ContextParams(
        position=np.array(props.position, f32),
        matrix=rot,
        velocity=(vel @ rot[:3, :3]).astype(f32),
        gain=f32(props.gain * gain_boost),
        meters_per_unit=f32(props.meters_per_unit),
        air_absorption_gain_hf=f32(props.air_absorption_gain_hf),
        doppler_factor=f32(props.doppler_factor),
        speed_of_sound=f32(props.speed_of_sound * props.doppler_velocity),
        source_distance_model=props.source_distance_model,
        distance_model=props.distance_model,
    )


@dataclasses.dataclass
class GainTriplet:
    base: f32 = f32(1.0)
    hf: f32 = f32(1.0)
    lf: f32 = f32(1.0)


@dataclasses.dataclass
class VoiceMixParams:
    """The outputs of CalcPanningAndFilters for one voice, host-resident.

    Per mixing channel: dry-bus target gains, wet target gains per send,
    filter coefficient targets, and (HRTF mode) HRIR selection parameters.
    """
    n_channels: int = 1
    dry_target: np.ndarray | None = None      # [C, n_dry]
    wet_target: np.ndarray | None = None      # [C, sends, n_wet]
    lp_coeffs: np.ndarray | None = None       # [5] shared across channels
    hp_coeffs: np.ndarray | None = None
    filter_active: bool = False
    send_lp_coeffs: np.ndarray | None = None  # [sends, 5]
    send_hp_coeffs: np.ndarray | None = None
    send_filter_active: np.ndarray | None = None
    step: int = 0
    bank_row: int = 0
    sf: f32 = f32(0.0)
    # HRTF mode: per channel evaluation parameters for the device-side
    # getCoeffs gather (or host-blended coeffs for small voice counts).
    hrtf_gain: np.ndarray | None = None       # [C]
    hrtf_coeffs: np.ndarray | None = None     # [C, 128, 2]
    hrtf_delay: np.ndarray | None = None      # [C, 2] int
    # NFC: per-channel w0 (speed_of_sound / (dist * rate)); -1 marks the
    # create-state identity filter; None when the voice has no NFC.
    nfc_w0: np.ndarray | None = None          # [C]


def _lerp(a, b, t):
    return f32(a + (b - a) * f32(t))


def fastf2i(x) -> int:
    """fastf2i (common/alnumeric.h:163): SSE cvt = round-nearest-ties-even."""
    return int(np.rint(f32(x)))


def calc_voice_params(voice: Voice, cparams: ContextParams, device) -> VoiceMixParams:
    """CalcVoiceParams (alu.cpp:2007-2025): attenuated vs non-attenuated."""
    props = voice.props
    ismono3d = voice.fmt_channels == FmtChannels.MONO and not props.panning_enabled
    if ((props.direct_channels != DirectMode.OFF and not ismono3d
         and not is_ambisonic(voice.fmt_channels))
            or props.spatialize_mode == SpatializeMode.OFF
            or (props.spatialize_mode == SpatializeMode.AUTO and not ismono3d)):
        return _calc_non_attn(voice, cparams, device)
    return _calc_attn(voice, cparams, device)


def _calc_step(voice: Voice, device, pitch: f32) -> tuple[int, int, f32]:
    pitch = f32(pitch * f32(voice.frequency) / f32(device.sample_rate))
    if pitch > f32(MAX_PITCH):
        step = MAX_PITCH << MIXER_FRAC_BITS
    else:
        step = max(fastf2i(f32(pitch * MIXER_FRAC_ONE)), 1)
    row, sf = tables.prepare_voice_resampler(voice.props.resampler, step,
                                             voice.position_frac)
    return step, row, sf


def _calc_non_attn(voice: Voice, cp: ContextParams, device) -> VoiceMixParams:
    """CalcNonAttnVoiceParams (alu.cpp:1655-1705)."""
    props = voice.props
    step, row, sf = _calc_step(voice, device, f32(props.pitch))

    mingain = f32(min(props.min_gain, props.max_gain))
    srcgain = f32(np.clip(f32(props.gain), mingain, f32(props.max_gain)))
    dry = GainTriplet(
        base=f32(min(GAIN_MIX_MAX, f32(srcgain * f32(props.direct_gain) * cp.gain))),
        hf=f32(props.direct_gain_hf), lf=f32(props.direct_gain_lf))
    wet = []
    for s in range(device.num_aux_sends):
        sp = props.send[s]
        wet.append(GainTriplet(
            base=f32(min(GAIN_MIX_MAX, f32(srcgain * f32(sp.gain) * cp.gain))),
            hf=f32(sp.gain_hf), lf=f32(sp.gain_lf)))
    out = _calc_panning_and_filters(voice, 0.0, 0.0, -1.0, 0.0, 0.0, dry, wet, device, cp)
    out.step, out.bank_row, out.sf = step, row, sf
    return out


def _calc_attn(voice: Voice, cp: ContextParams, device) -> VoiceMixParams:
    """CalcAttnVoiceParams (alu.cpp:1707-2005)."""
    props = voice.props
    numsends = device.num_aux_sends

    sendslots = [props.send[i].slot for i in range(numsends)]
    roomrolloff = np.zeros(MAX_SEND_COUNT, f32)
    for i in range(numsends):
        slot = sendslots[i]
        if slot is None or getattr(slot, "effect_type", None) in (None, "null"):
            sendslots[i] = None
        else:
            roomrolloff[i] = f32(props.room_rolloff_factor + slot.room_rolloff)

    position = np.array(props.position, f32)
    velocity = np.array(props.velocity, f32)
    direction = np.array(props.direction, f32)
    if not props.head_relative:
        rel = (position - cp.position).astype(f32)
        position = (rel @ cp.matrix[:3, :3]).astype(f32)
        velocity = (velocity @ cp.matrix[:3, :3]).astype(f32)
        direction = (direction @ cp.matrix[:3, :3]).astype(f32)
    else:
        velocity = (velocity + cp.velocity).astype(f32)

    tosource, distance = _normalize(position)
    direction, dirlen = _normalize(direction)
    directional = dirlen > 0.0

    dmodel = props.distance_model if cp.source_distance_model else cp.distance_model

    ref_dist = f32(props.ref_distance)
    max_dist = f32(props.max_distance)
    if dmodel in (DistanceModel.INVERSE_CLAMPED, DistanceModel.LINEAR_CLAMPED,
                  DistanceModel.EXPONENT_CLAMPED):
        atten_distance = (ref_dist if not ref_dist <= max_dist
                          else f32(np.clip(distance, ref_dist, max_dist)))
    else:
        atten_distance = distance

    dry = GainTriplet(base=f32(props.gain))
    wet_base = [f32(props.gain) for _ in range(MAX_SEND_COUNT)]

    dry_attn_base = f32(1.0)
    if dmodel in (DistanceModel.INVERSE, DistanceModel.INVERSE_CLAMPED):
        if ref_dist > 0.0:
            dist = _lerp(ref_dist, atten_distance, f32(props.rolloff_factor))
            if dist > 0.0:
                dry_attn_base = f32(ref_dist / dist)
                dry.base = f32(dry.base * dry_attn_base)
            for i in range(numsends):
                dist = _lerp(ref_dist, atten_distance, roomrolloff[i])
                if dist > 0.0:
                    wet_base[i] = f32(wet_base[i] * f32(ref_dist / dist))
    elif dmodel in (DistanceModel.LINEAR, DistanceModel.LINEAR_CLAMPED):
        if max_dist != ref_dist:
            scale = f32((atten_distance - ref_dist) / (max_dist - ref_dist))
            dry_attn_base = f32(max(1.0 - scale * f32(props.rolloff_factor), 0.0))
            dry.base = f32(dry.base * dry_attn_base)
            for i in range(numsends):
                wet_base[i] = f32(wet_base[i] * f32(max(1.0 - scale * roomrolloff[i], 0.0)))
    elif dmodel in (DistanceModel.EXPONENT, DistanceModel.EXPONENT_CLAMPED):
        if atten_distance > 0.0 and ref_dist > 0.0:
            dist_ratio = f32(atten_distance / ref_dist)
            dry_attn_base = f32(np.power(dist_ratio, f32(-props.rolloff_factor)))
            dry.base = f32(dry.base * dry_attn_base)
            for i in range(numsends):
                wet_base[i] = f32(wet_base[i] * f32(np.power(dist_ratio, -roomrolloff[i])))

    # Directional cones
    wetcone, wetconehf = f32(1.0), f32(1.0)
    if directional and props.inner_angle < 360.0:
        rad2deg = f32(180.0 / np.pi)
        angle = f32(rad2deg * 2.0 * f32(np.arccos(np.clip(
            -f32(np.dot(direction, tosource)), -1.0, 1.0))) * CONE_SCALE)
        conegain, conehf = f32(1.0), f32(1.0)
        if angle >= f32(props.outer_angle):
            conegain = f32(props.outer_gain)
            conehf = f32(props.outer_gain_hf)
        elif angle >= f32(props.inner_angle):
            scale = f32((angle - f32(props.inner_angle))
                        / (f32(props.outer_angle) - f32(props.inner_angle)))
            conegain = _lerp(1.0, f32(props.outer_gain), scale)
            conehf = _lerp(1.0, f32(props.outer_gain_hf), scale)
        dry.base = f32(dry.base * conegain)
        if props.dry_gain_hf_auto:
            dry.hf = f32(dry.hf * conehf)
        if props.wet_gain_auto:
            wetcone = conegain
        if props.wet_gain_hf_auto:
            wetconehf = conehf

    mingain = f32(min(props.min_gain, props.max_gain))
    maxgain = f32(props.max_gain)
    dry.base = f32(np.clip(dry.base, mingain, maxgain) * f32(props.direct_gain))
    dry.base = f32(min(GAIN_MIX_MAX, f32(dry.base * cp.gain)))
    dry.hf = f32(dry.hf * f32(props.direct_gain_hf))
    dry.lf = f32(props.direct_gain_lf)

    wet = []
    for i in range(numsends):
        sp = props.send[i]
        g = f32(np.clip(f32(wet_base[i] * wetcone), mingain, maxgain) * f32(sp.gain))
        wet.append(GainTriplet(
            base=f32(min(GAIN_MIX_MAX, f32(g * cp.gain))),
            hf=f32(sp.gain_hf * wetconehf), lf=f32(sp.gain_lf)))

    # Air absorption + initial reverb decay (alu.cpp:1900-1949)
    if distance > ref_dist:
        distance_units = f32((distance - ref_dist) * f32(props.rolloff_factor))
        distance_meters = f32(distance_units * cp.meters_per_unit)
        absorb = f32(distance_meters * f32(props.air_absorption_factor))
        if absorb > np.finfo(np.float32).eps:
            dry.hf = f32(dry.hf * f32(np.power(cp.air_absorption_gain_hf, absorb)))
        start = 0 if props.wet_gain_auto else numsends
        for i in range(start, numsends):
            slot = sendslots[i]
            if slot is None or not slot.decay_time > 0.0:
                continue
            if slot.air_absorption_gain_hf < 1.0 and absorb > np.finfo(np.float32).eps:
                wet[i].hf = f32(wet[i].hf
                                * f32(np.power(f32(slot.air_absorption_gain_hf), absorb)))
            decay_distance = f32(slot.decay_time * SPEED_OF_SOUND)
            fact = f32(distance_meters / decay_distance)
            gain = f32(f32(np.power(f32(0.001), fact)) * (f32(1.0) - dry_attn_base)
                       + dry_attn_base)
            wet[i].base = f32(wet[i].base * gain)

    # Doppler (alu.cpp:1952-1984)
    pitch = f32(props.pitch)
    doppler_factor = f32(props.doppler_factor * cp.doppler_factor)
    if doppler_factor > 0.0:
        vss = f32(np.dot(velocity, tosource) * -doppler_factor)
        vls = f32(np.dot(cp.velocity, tosource) * -doppler_factor)
        sos = cp.speed_of_sound
        if not vls < sos:
            pitch = f32(0.0)
        elif not vss < sos:
            pitch = f32(np.inf)
        else:
            pitch = f32(pitch * f32((sos - vls) / (sos - vss)))

    step, row, sf = _calc_step(voice, device, pitch)

    spread = f32(0.0)
    if props.radius > distance:
        spread = f32(np.pi * 2.0 - distance / f32(props.radius) * np.pi)
    elif distance > 0.0:
        spread = f32(np.arcsin(f32(props.radius) / distance) * 2.0)

    out = _calc_panning_and_filters(voice, tosource[0], tosource[1], tosource[2],
                                    distance, spread, dry, wet, device, cp)
    out.step, out.bank_row, out.sf = step, row, sf
    return out


def _calc_panning_and_filters(voice: Voice, xpos, ypos, zpos, distance, spread,
                              dry: GainTriplet, wet: list[GainTriplet],
                              device, cp: ContextParams | None = None
                              ) -> VoiceMixParams:
    """CalcPanningAndFilters (alu.cpp:1467-1653), normal/pairwise modes.

    HRTF panning is handled by _calc_hrtf_channel below; ambisonic source
    formats are wired in a later phase.
    """
    props = voice.props
    layout = device.layout
    numsends = device.num_aux_sends
    n_ch = voice.num_mix_channels()

    out = VoiceMixParams(n_channels=n_ch)
    out.dry_target = np.zeros((n_ch, device.n_dry), f32)
    out.wet_target = np.zeros((n_ch, max(numsends, 1), MAX_AMBI_CHANNELS), f32)

    # Channel position maps
    if voice.fmt_channels == FmtChannels.MONO and not props.panning_enabled:
        chans = CHAN_POS_MAPS[FmtChannels.MONO]
    elif voice.fmt_channels in (FmtChannels.MONO, FmtChannels.STEREO):
        chans = list(CHAN_POS_MAPS[FmtChannels.STEREO])
        if props.direct_channels == DirectMode.OFF:
            newchans = []
            for (ch, pos), a in zip(chans, props.stereo_pan):
                newchans.append((ch, (float(-np.sin(f32(a))), pos[1],
                                      float(-np.cos(f32(a))))))
            chans = newchans
    elif is_ambisonic(voice.fmt_channels):
        _calc_ambisonic_panning(voice, out, xpos, ypos, zpos, distance, spread,
                                dry, wet, device, cp)
        voice.has_hrtf = False
        # NFC for B-Format/UHJ3/UHJ4 (alu.cpp:919-940): with a distance only
        # the W channel's filter is adjusted (others keep their prior state,
        # NaN = leave row untouched); with no distance every channel aligns
        # to w0=0 (compensation-only for FOA input).
        if (getattr(device, "avg_speaker_dist", 0.0) > 0.0
                and voice.fmt_channels not in (FmtChannels.UHJ2,
                                               FmtChannels.SUPER_STEREO)):
            if distance > np.finfo(np.float32).eps:
                out.nfc_w0 = np.full(out.n_channels, np.nan, f32)
                out.nfc_w0[0] = _nfc_w0(device, distance)
            else:
                out.nfc_w0 = np.zeros(out.n_channels, f32)
        _set_voice_filters(voice, out, dry, wet, device)
        return out
    else:
        chans = CHAN_POS_MAPS[voice.fmt_channels]

    if layout.mode == panning.RenderMode.HRTF and layout.hrtf_full:
        _calc_hrtf_channels(voice, out, chans, xpos, ypos, zpos, distance, spread,
                            dry, wet, device)
        voice.duplicate_mono = (voice.fmt_channels == FmtChannels.MONO
                                and props.panning_enabled)
        voice.has_hrtf = True
    else:
        voice.has_hrtf = False
        _calc_normal_panning(voice, out, chans, xpos, ypos, zpos, distance, spread,
                             dry, wet, device)
        # NFC filter adjust (alu.cpp:1318-1336, 1405-1424): all channels.
        if getattr(device, "avg_speaker_dist", 0.0) > 0.0:
            out.nfc_w0 = np.full(out.n_channels, _nfc_w0(device, distance), f32)

    _set_voice_filters(voice, out, dry, wet, device)
    return out


def _nfc_w0(device, distance) -> f32:
    """w0 for the NFC adjust (alu.cpp:933-940, 1329-1336, 1419)."""
    rate = f32(device.sample_rate)
    if distance > np.finfo(np.float32).eps:
        mdist = f32(max(f32(distance) * f32(device.nfc_scale),
                        f32(device.avg_speaker_dist) / f32(4.0)))
        return f32(f32(343.3) / (mdist * rate))
    return f32(f32(343.3) / (f32(device.avg_speaker_dist) * rate))


def _set_voice_filters(voice: Voice, out: VoiceMixParams, dry, wet, device):
    """Direct/send filters (alu.cpp:1615-1652)."""
    props = voice.props
    numsends = device.num_aux_sends
    inv_sr = f32(1.0 / device.sample_rate)
    hf_norm = f32(props.direct_hf_reference * inv_sr)
    lf_norm = f32(props.direct_lf_reference * inv_sr)
    out.filter_active = (dry.hf != 1.0) or (dry.lf != 1.0)
    gain_hf = f32(max(dry.hf, 0.001))
    gain_lf = f32(max(dry.lf, 0.001))
    out.lp_coeffs = spec.biquad_set_params(
        "highshelf", hf_norm, gain_hf, _rcpq_from_slope(gain_hf, 1.0))
    out.hp_coeffs = spec.biquad_set_params(
        "lowshelf", lf_norm, gain_lf, _rcpq_from_slope(gain_lf, 1.0))

    out.send_lp_coeffs = np.zeros((max(numsends, 1), 5), f32)
    out.send_hp_coeffs = np.zeros((max(numsends, 1), 5), f32)
    out.send_filter_active = np.zeros(max(numsends, 1), bool)
    for i in range(numsends):
        sp = props.send[i]
        hfn = f32(sp.hf_reference * inv_sr)
        lfn = f32(sp.lf_reference * inv_sr)
        out.send_filter_active[i] = (wet[i].hf != 1.0) or (wet[i].lf != 1.0)
        ghf = f32(max(wet[i].hf, 0.001))
        glf = f32(max(wet[i].lf, 0.001))
        out.send_lp_coeffs[i] = spec.biquad_set_params(
            "highshelf", hfn, ghf, _rcpq_from_slope(ghf, 1.0))
        out.send_hp_coeffs[i] = spec.biquad_set_params(
            "lowshelf", lfn, glf, _rcpq_from_slope(glf, 1.0))


def _calc_ambisonic_panning(voice: Voice, out: VoiceMixParams, xpos, ypos,
                            zpos, distance, spread, dry, wet, device,
                            cp: ContextParams | None = None):
    """CalcAmbisonicPanning (alc/alu.cpp:911-1076) for B-Format/UHJ sources.

    The W channel pans like a mono source blended by "coverage" (spread);
    the full B-Format signal is rotated by the source orientation.  NFC
    w0 selection happens in the caller (alu.cpp:919-940).
    """
    from .devformat import AmbiLayout, AmbiScaling, FmtChannels

    props = voice.props
    layout = device.layout
    numsends = device.num_aux_sends

    coverage = (f32(1.0) if not distance > np.finfo(np.float32).eps
                else f32(0.5 / np.pi * spread))

    scales = {
        AmbiScaling.FUMA: ambidefs.FROM_FUMA,
        AmbiScaling.SN3D: ambidefs.FROM_SN3D,
    }.get(voice.ambi_scaling, np.ones(MAX_AMBI_CHANNELS, f32))

    pos = np.array([xpos, ypos, zpos], f32)
    if layout.mode == panning.RenderMode.PAIRWISE:
        pos = panning.scale_azimuth_front3_2(pos)
    coeffs = ambidefs.calc_direction_coeffs(pos, 0.0).copy()

    def pan(chan_idx, cf, gain_base, wet_gains):
        out.dry_target[chan_idx] = panning.compute_pan_gains(
            layout.dry_acn, layout.dry_scale, cf, gain_base)
        for i in range(numsends):
            slot = props.send[i].slot
            if slot is not None:
                out.wet_target[chan_idx, i, :slot.wet_channels] = \
                    panning.compute_pan_gains(slot.wet_acn, slot.wet_scale,
                                              cf, wet_gains[i])

    if not coverage > 0.0:
        pan(0, coeffs, f32(dry.base * scales[0]),
            [f32(w.base * scales[0]) for w in wet])
        return

    # Rotation from the source orientation (first-order; higher device
    # orders would extend this with the recursive SH rotator, alu.cpp:799).
    n, _ = _normalize(np.array(props.orient_at, f32))
    v, _ = _normalize(np.array(props.orient_up, f32))
    if not props.head_relative:
        # cparams matrix is row-major listener rotation; apply like the
        # reference's Matrix * Vector (alu.cpp:981-985).
        if cp is not None:
            # Same vector-matrix convention as the listener-space transform
            # in _calc_attn (the reference's Matrix * Vector).
            n = (n @ cp.matrix[:3, :3]).astype(f32)
            v = (v @ cp.matrix[:3, :3]).astype(f32)
    u, _ = _normalize(np.cross(n, v).astype(f32))

    shrot = np.zeros((MAX_AMBI_CHANNELS, MAX_AMBI_CHANNELS), f32)
    shrot[0, 0] = 1.0
    shrot[1, 1], shrot[1, 2], shrot[1, 3] = u[0], -u[1], u[2]
    shrot[2, 1], shrot[2, 2], shrot[2, 3] = -v[0], v[1], -v[2]
    shrot[3, 1], shrot[3, 2], shrot[3, 3] = -n[0], n[1], -n[2]
    mixmatrix = shrot

    is2d = voice.fmt_channels == FmtChannels.BFORMAT2D
    index_map = (ambidefs.INDEX_FROM_FUMA_2D if is2d
                 else ambidefs.INDEX_FROM_FUMA)
    if voice.ambi_layout == AmbiLayout.ACN:
        index_map = (ambidefs.INDEX_FROM_ACN_2D if is2d
                     else ambidefs.INDEX_FROM_ACN)

    coeffs *= f32((1.0 - coverage) * scales[0])
    for c in range(out.n_channels):
        acn = int(index_map[c])
        scale = f32(scales[acn] * coverage)
        cf = (mixmatrix[acn, :len(coeffs)] * scale + coeffs).astype(f32)
        pan(c, cf, dry.base, [w.base for w in wet])
        coeffs = np.zeros_like(coeffs)


def _rcpq_from_slope(gain: f32, slope: float) -> f32:
    return f32(np.sqrt(f32((gain + f32(1.0) / gain) * f32(1.0 / slope - 1.0) + f32(2.0))))


def _warp_position(chan_pos, xpos, ypos, zpos, spread):
    """Warp channel position toward the source by (1 - spread/2pi)."""
    a = f32(1.0 - f32(0.5 / np.pi) * spread)
    pos = np.array([_lerp(chan_pos[0], xpos, a), _lerp(chan_pos[1], ypos, a),
                    _lerp(chan_pos[2], zpos, a)], f32)
    length = f32(np.sqrt(f32(np.dot(pos, pos))))
    if length < 1.0:
        pos = (pos / length).astype(f32)
    return pos


def _calc_normal_panning(voice, out, chans, xpos, ypos, zpos, distance, spread,
                         dry, wet, device):
    """CalcNormalPanning (alu.cpp:1311-1465)."""
    props = voice.props
    layout = device.layout
    pairwise = layout.mode == panning.RenderMode.PAIRWISE
    numsends = device.num_aux_sends

    def apply(chan_idx, coeffs, gain_base, wet_gains):
        out.dry_target[chan_idx] = panning.compute_pan_gains(
            layout.dry_acn, layout.dry_scale, coeffs, gain_base)
        for i in range(numsends):
            slot = props.send[i].slot
            if slot is not None and wet_gains is not None:
                out.wet_target[chan_idx, i, :slot.wet_channels] = \
                    panning.compute_pan_gains(slot.wet_acn, slot.wet_scale,
                                              coeffs, wet_gains[i])

    if distance > np.finfo(np.float32).eps:
        if voice.fmt_channels == FmtChannels.MONO and not props.panning_enabled:
            pos = np.array([xpos, ypos, zpos], f32)
            if pairwise:
                pos = panning.scale_azimuth_front3_2(pos)
            coeffs = ambidefs.calc_direction_coeffs(pos, spread)
            out.dry_target[0] = panning.compute_pan_gains(
                layout.dry_acn, layout.dry_scale, coeffs, dry.base)
            for i in range(numsends):
                slot = props.send[i].slot
                if slot is not None:
                    out.wet_target[0, i, :slot.wet_channels] = panning.compute_pan_gains(
                        slot.wet_acn, slot.wet_scale, coeffs, wet[i].base)
            return

        for c, (ch, cpos) in enumerate(chans):
            pangain = panning.pan_gain(ch, props.panning)
            if ch == Channel.LFE:
                continue  # dry==real only when Dry is RealOut (not here)
            pos = _warp_position(cpos, xpos, ypos, zpos, spread)
            if pairwise:
                pos = panning.scale_azimuth_front3(pos)
            coeffs = ambidefs.calc_direction_coeffs(pos, 0.0)
            apply(c, coeffs, f32(dry.base * pangain),
                  [f32(w.base * pangain) for w in wet])
    else:
        spreadmult = f32(float(voice.fmt_channels == FmtChannels.MONO
                               and not props.panning_enabled) * spread)
        for c, (ch, cpos) in enumerate(chans):
            pangain = panning.pan_gain(ch, props.panning)
            if ch == Channel.LFE:
                continue
            pos = panning.scale_azimuth_front3(np.array(cpos, f32)) if pairwise \
                else np.array(cpos, f32)
            coeffs = ambidefs.calc_direction_coeffs(pos, spreadmult)
            apply(c, coeffs, f32(dry.base * pangain),
                  [f32(w.base * pangain) for w in wet])

    if voice.fmt_channels == FmtChannels.MONO and props.panning_enabled:
        # MergePannedMono (alu.cpp:1119-1135)
        out.dry_target[0] += out.dry_target[1]
        out.wet_target[0] += out.wet_target[1]
        out.n_channels = 1  # single buffer channel feeds the merged row


def _calc_hrtf_channels(voice, out, chans, xpos, ypos, zpos, distance, spread,
                        dry, wet, device):
    """CalcHrtfPanning (alu.cpp:1196-1308)."""
    props = voice.props
    numsends = device.num_aux_sends
    hrtf = device.hrtf_store
    n_ch = out.n_channels
    out.hrtf_gain = np.zeros(n_ch, f32)
    out.hrtf_coeffs = np.zeros((n_ch, 128, 2), f32)
    out.hrtf_delay = np.zeros((n_ch, 2), np.int32)

    def wet_pan(chan_idx, coeffs, gains):
        for i in range(numsends):
            slot = props.send[i].slot
            if slot is not None:
                out.wet_target[chan_idx, i, :slot.wet_channels] = \
                    panning.compute_pan_gains(slot.wet_acn, slot.wet_scale,
                                              coeffs, gains[i])

    if distance > np.finfo(np.float32).eps:
        if voice.fmt_channels == FmtChannels.MONO and not props.panning_enabled:
            src_ev = f32(np.arcsin(np.clip(ypos, -1.0, 1.0)))
            src_az = f32(np.arctan2(xpos, -zpos))
            coeffs, delay = hrtf.get_coeffs(src_ev, src_az,
                                            f32(distance * NFC_SCALE), spread)
            out.hrtf_coeffs[0], out.hrtf_delay[0] = coeffs, delay
            out.hrtf_gain[0] = dry.base
            pan = ambidefs.calc_direction_coeffs([xpos, ypos, zpos], spread)
            wet_pan(0, pan, [w.base for w in wet])
            return
        for c, (ch, cpos) in enumerate(chans):
            if ch == Channel.LFE:
                continue
            pangain = panning.pan_gain(ch, props.panning)
            pos = _warp_position(cpos, xpos, ypos, zpos, spread)
            ev = f32(np.arcsin(np.clip(pos[1], -1.0, 1.0)))
            az = f32(np.arctan2(pos[0], -pos[2]))
            coeffs, delay = hrtf.get_coeffs(ev, az, f32(distance * NFC_SCALE), 0.0)
            out.hrtf_coeffs[c], out.hrtf_delay[c] = coeffs, delay
            out.hrtf_gain[c] = f32(dry.base * pangain)
            pan = ambidefs.calc_direction_coeffs(pos, 0.0)
            wet_pan(c, pan, [f32(w.base * pangain) for w in wet])
        return

    spreadmult = f32(float(voice.fmt_channels == FmtChannels.MONO
                           and not props.panning_enabled) * spread)
    for c, (ch, cpos) in enumerate(chans):
        if ch == Channel.LFE:
            continue
        pangain = panning.pan_gain(ch, props.panning)
        ev = f32(np.arcsin(cpos[1]))
        az = f32(np.arctan2(cpos[0], -cpos[2]))
        coeffs, delay = hrtf.get_coeffs(ev, az, f32(np.inf), spreadmult)
        out.hrtf_coeffs[c], out.hrtf_delay[c] = coeffs, delay
        out.hrtf_gain[c] = f32(dry.base * pangain)
        pan = ambidefs.calc_direction_coeffs(cpos, spread)
        wet_pan(c, pan, [f32(w.base * pangain) for w in wet])
