"""Scene recipe: static mono voices looping a pool of tones, all started
together, with no filter, send or slot.

Parameters (the traffic file's ``scene_params``):

- ``voices``: sources, one per row of the device's capacity at most;
- ``tones``, ``tone_seconds``, ``tone_base_hz``, ``tone_amp``: the pool;
  voice i plays tone i mod ``tones``, looping at pitch 1;
- ``position_sigma``: positions ~ N(0, sigma^2) on each axis, from the
  seed (stream 0), 3 normals per voice in voice order.

``inputs`` makes what both sides get; ``build`` hands it to the program
through its AL/ALC entry points; ``reference`` hands it to the plain
reference (``reference/binaural.py``).
"""

from __future__ import annotations

import numpy as np

from harness import inputs as make


def inputs(params: dict, seed: int, rate: int) -> dict:
    tones = make.tone_pool(params["tones"], params["tone_seconds"],
                           params["tone_base_hz"], params["tone_amp"], rate)
    n = int(params["voices"])
    pos = make.rng(seed, 0).standard_normal((n, 3)) * float(
        params["position_sigma"])
    return {"rate": rate, "tones": tones,
            "voice_tone": np.arange(n) % len(tones), "positions": pos}


def build(al, config: dict, scene: dict, device: str) -> dict:
    attrs = dict(config["device"])
    rate = attrs.pop("frequency")
    dev = al.alcLoopbackOpenDeviceSOFT(rate, attrs.pop("channels"),
                                       attrs.pop("sample_type"),
                                       device=device, **attrs)
    ctx = al.alcCreateContext(dev)
    al.alcMakeContextCurrent(ctx)
    bufs = []
    for tone in scene["tones"]:
        bid = al.alGenBuffers()
        al.alBufferData(bid, al.AL_FORMAT_MONO_FLOAT32, tone, rate)
        bufs.append(bid)
    sources = []
    for t, pos in zip(scene["voice_tone"], scene["positions"]):
        sid = al.alGenSources()
        al.alSourcei(sid, al.AL_BUFFER, bufs[t])
        al.alSourcei(sid, al.AL_LOOPING, al.AL_TRUE)
        al.alSource3f(sid, al.AL_POSITION, *(float(p) for p in pos))
        al.alSourcePlay(sid)
        sources.append(sid)
    return {"al": al, "dev": dev, "ctx": ctx, "sources": sources,
            "rate": rate}


def reference(config: dict, scene: dict, hrtf_path, device: str, dtype):
    from reference import binaural, mhr

    dev = config["device"]
    if not (dev["hrtf"] and dev["channels"] == "stereo"
            and dev["sample_type"] == "float32"):
        raise ValueError("the reference renders float32 headphone output")
    return binaural.Binaural(mhr.load(hrtf_path), scene["tones"],
                             scene["voice_tone"], scene["positions"],
                             scene["rate"], device=device, dtype=dtype)


def work(scene: dict, hrtf_path, frames: int) -> dict:
    """What a slice of ``frames`` frames reads: the voices, the distinct
    source samples their unit-step reads cover (the voices of a tone all
    sit at one position of it), and the taps the HRIR set stores."""
    from reference import mhr

    lengths = np.array([len(t) for t in scene["tones"]])
    used = np.unique(scene["voice_tone"])
    return {"voices": int(len(scene["voice_tone"])),
            "source_bytes": 4.0 * float(np.minimum(lengths[used],
                                                   frames + 1).sum()),
            "hrir_taps": mhr.load(hrtf_path).ir_size}
