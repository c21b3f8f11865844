"""Scene recipe: looping mono voices over a pool of tones, as
``static_voices`` lays them out, each pitched, behind a direct lowpass, and
sent to two EAX reverb zones through lowpass send filters: OpenAL Soft's
``examples/almultireverb.c`` (two EAXReverb slots, every source sending to
both) at a game's voice count.

Parameters (the traffic file's ``scene_params``):

- ``voices``, ``tones``, ``tone_seconds``, ``tone_base_hz``, ``tone_amp``,
  ``position_sigma``: as ``static_voices`` (positions from stream 0);
- ``pitch_octaves``: each voice's pitch is 2^u, u ~ U(-p/2, p/2);
- ``direct_gain_hf``: [lo, hi] of the direct lowpass's gain_hf (gain 1);
- ``send_gain_hf``: [lo, hi] of each send lowpass's gain_hf; send 0 has
  gain g and send 1 gain 1 - g, g ~ U(0, 1), the zones' balance;
- ``zones``: the reverb zones in send order, each {"name": ..., "eaxreverb":
  the EFX properties of its preset}.

The draws beyond the positions come from stream 4 of the seed, in the order
pitch, direct gain_hf, g, send gain_hf [voices, 2].  ``build`` makes the
scene through the program's AL/ALC/EFX entry points; ``reference`` hands the
same to the plain reference (``reference/speakers.py``).
"""

from __future__ import annotations

import numpy as np

from harness import inputs as make

AL_EFFECT_EAXREVERB = 0x8000                  # include/AL/efx.h
AL_FILTER_LOWPASS = 0x0001
AL_LOWPASS_GAIN = 0x0001
AL_LOWPASS_GAINHF = 0x0002
EAXREVERB = {                                 # AL_EAXREVERB_*, efx.h
    "density": 0x0001, "diffusion": 0x0002, "gain": 0x0003,
    "gain_hf": 0x0004, "gain_lf": 0x0005, "decay_time": 0x0006,
    "decay_hf_ratio": 0x0007, "decay_lf_ratio": 0x0008,
    "reflections_gain": 0x0009, "reflections_delay": 0x000A,
    "reflections_pan": 0x000B, "late_reverb_gain": 0x000C,
    "late_reverb_delay": 0x000D, "late_reverb_pan": 0x000E,
    "echo_time": 0x000F, "echo_depth": 0x0010, "modulation_time": 0x0011,
    "modulation_depth": 0x0012, "air_absorption_gain_hf": 0x0013,
    "hf_reference": 0x0014, "lf_reference": 0x0015,
    "room_rolloff_factor": 0x0016, "decay_hf_limit": 0x0017,
}


def inputs(params: dict, seed: int, rate: int) -> dict:
    tones = make.tone_pool(params["tones"], params["tone_seconds"],
                           params["tone_base_hz"], params["tone_amp"], rate)
    n = int(params["voices"])
    pos = make.rng(seed, 0).standard_normal((n, 3)) * float(
        params["position_sigma"])
    g = make.rng(seed, 4)
    half = 0.5 * float(params["pitch_octaves"])
    pitch = 2.0 ** g.uniform(-half, half, n)
    direct_hf = g.uniform(*params["direct_gain_hf"], n)
    balance = g.uniform(0.0, 1.0, n)
    send_hf = g.uniform(*params["send_gain_hf"], (n, 2))
    return {"rate": rate, "tones": tones,
            "voice_tone": np.arange(n) % len(tones), "positions": pos,
            "pitch": pitch, "direct_gain_hf": direct_hf,
            "send_gain": np.stack([balance, 1.0 - balance], axis=1),
            "send_gain_hf": send_hf,
            "zones": [z["eaxreverb"] for z in params["zones"]]}


def _effect(al, props: dict) -> int:
    eid = al.alGenEffects()
    al.alEffecti(eid, al.AL_EFFECT_TYPE, AL_EFFECT_EAXREVERB)
    for name, value in props.items():
        if isinstance(value, (list, tuple)):
            al.alEffectfv(eid, EAXREVERB[name], value)
        elif isinstance(value, bool):
            al.alEffecti(eid, EAXREVERB[name], int(value))
        else:
            al.alEffectf(eid, EAXREVERB[name], float(value))
    return eid


def _lowpass(al, fid: int, gain: float, gain_hf: float) -> int:
    al.alFilterf(fid, AL_LOWPASS_GAIN, float(gain))
    al.alFilterf(fid, AL_LOWPASS_GAINHF, float(gain_hf))
    return fid


def build(al, config: dict, scene: dict, device: str) -> dict:
    attrs = dict(config["device"])
    rate = attrs.pop("frequency")
    dev = al.alcLoopbackOpenDeviceSOFT(rate, attrs.pop("channels"),
                                       attrs.pop("sample_type"),
                                       device=device, **attrs)
    ctx = al.alcCreateContext(dev)
    al.alcMakeContextCurrent(ctx)
    slots = []
    for props in scene["zones"]:
        sid = al.alGenAuxiliaryEffectSlots()
        al.alAuxiliaryEffectSloti(sid, al.AL_EFFECTSLOT_EFFECT,
                                  _effect(al, props))
        slots.append(sid)
    bufs = []
    for tone in scene["tones"]:
        bid = al.alGenBuffers()
        al.alBufferData(bid, al.AL_FORMAT_MONO_FLOAT32, tone, rate)
        bufs.append(bid)
    # The filter objects are templates: a source copies their properties
    # when it takes them, so one object serves every source.
    direct, send = al.alGenFilters(2)
    for fid in (direct, send):
        al.alFilteri(fid, al.AL_FILTER_TYPE, AL_FILTER_LOWPASS)
    sources = []
    for v, (t, pos) in enumerate(zip(scene["voice_tone"],
                                     scene["positions"])):
        src = al.alGenSources()
        al.alSourcei(src, al.AL_BUFFER, bufs[t])
        al.alSourcei(src, al.AL_LOOPING, al.AL_TRUE)
        al.alSource3f(src, al.AL_POSITION, *(float(p) for p in pos))
        al.alSourcef(src, al.AL_PITCH, float(scene["pitch"][v]))
        al.alSourcei(src, al.AL_DIRECT_FILTER, _lowpass(
            al, direct, 1.0, scene["direct_gain_hf"][v]))
        for s, slot in enumerate(slots):
            al.alSource3i(src, al.AL_AUXILIARY_SEND_FILTER, slot, s, _lowpass(
                al, send, scene["send_gain"][v, s],
                scene["send_gain_hf"][v, s]))
        al.alSourcePlay(src)
        sources.append(src)
    return {"al": al, "dev": dev, "ctx": ctx, "sources": sources,
            "slots": slots, "rate": rate}


def reference(config: dict, scene: dict, hrtf_path, device: str, dtype):
    from reference import speakers

    dev = config["device"]
    if dev["hrtf"] or dev["channels"] != "surround51" \
            or dev["sample_type"] != "float32":
        raise ValueError("the reference renders float32 5.1 output")
    n = len(scene["voice_tone"])
    voices = speakers.Voices(
        buffers=scene["tones"], voice_buffer=scene["voice_tone"],
        positions=scene["positions"], pitch=scene["pitch"],
        gain=np.ones(n), direct_gain_hf=scene["direct_gain_hf"],
        send_gain=scene["send_gain"], send_gain_hf=scene["send_gain_hf"],
        buffer_rate=scene["rate"])
    return speakers.Speakers(voices, scene["zones"],
                             speakers.Layout.surround51(), scene["rate"],
                             device=device, dtype=dtype)


def work(scene: dict, hrtf_path, frames: int) -> dict:
    """What a slice of ``frames`` frames reads: the voices, and the distinct
    source samples of each tone its voices' pitched reads cover (a looping
    voice covers ceil(frames * pitch) + 3 samples, at most the tone)."""
    lengths = np.array([len(t) for t in scene["tones"]])
    reach = np.ceil(frames * np.asarray(scene["pitch"])) + 3
    covered = np.zeros(len(lengths))
    np.maximum.at(covered, scene["voice_tone"], reach)
    return {"voices": int(len(scene["voice_tone"])),
            "source_bytes": 4.0 * float(np.minimum(lengths, covered).sum())}
