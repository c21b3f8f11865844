"""The speaker reference against OpenAL Soft's own library: each scene of
``reference/witness/`` rebuilt from its test (``tests/test_e2e_*.py``) and
rendered by the reference alone, within that test's tolerance.  The stereo
witnesses' layout (pair-wise panning, the single-band first-order stereo
decode) and the 5.1 witness's distance compensation are written here: the
benchmark's cells render neither."""

import numpy as np
import pytest

from harness import registry
from reference import reverb, speakers

WITNESS = registry.BENCH_DIR / "reference" / "witness"
F32 = np.float32


def witness(name: str) -> np.ndarray:
    return np.load(WITNESS / f"{name}.npz")["out"]


def tone(n, freq, rate, gain):
    t = np.arange(n) / rate
    return (gain * np.sin(2 * np.pi * freq * t)).astype(F32)


def front3_2(u):
    """ScaleAzimuthFront3_2 (alu.cpp): a mono source's frontal azimuth
    scaled by 1.5 for pair-wise stereo panning, float32."""
    x, y, z = (F32(c) for c in u)
    if z >= 0.0:
        return np.array([x, y, z], F32)
    len2d = F32(np.sqrt(F32(x * x + z * z)))
    fz = F32(-z / len2d)
    if fz > F32(0.5):
        fx = F32(np.copysign(np.sqrt(F32((F32(1.0) - fz) * F32(0.5))),
                             x / len2d))
        fz = F32(np.sqrt(F32((F32(1.0) + fz) * F32(0.5))))
        fx = F32(fx * F32(3.0) - fx * fx * fx * F32(4.0))
        fz = F32(fz * fz * fz * F32(4.0) - fz * F32(3.0))
        return np.array([F32(fx * len2d), y, F32(-fz * len2d)], F32)
    return np.array([F32(np.copysign(len2d, x)), y, F32(0.0)], F32)


def stereo() -> speakers.Layout:
    """StereoConfig (panning.cpp): first order 2D, N3D, single band."""
    dec = np.array([[5.00000000e-1, 2.88675135e-1, 5.52305643e-2],
                    [5.00000000e-1, -2.88675135e-1, 5.52305643e-2]], F32)
    return speakers.Layout(dry_acn=np.array([0, 1, 3]),
                           dry_scale=np.ones(3, F32), dec_hf=dec,
                           dec_lf=None, xover_hz=400.0, order=1,
                           two_d=True)


def render(sources, rate, layout, frames, zones=(), pan=None):
    n = len(sources)
    get = lambda k, d: np.array([s.get(k, d) for s in sources], np.float64)
    sends = len(zones)
    voices = speakers.Voices(
        buffers=[s["data"] for s in sources], voice_buffer=np.arange(n),
        positions=np.array([s["position"] for s in sources], np.float64),
        pitch=get("pitch", 1.0), gain=get("gain", 1.0),
        direct_gain_hf=get("direct_gain_hf", 1.0),
        send_gain=np.ones((n, sends)), send_gain_hf=np.ones((n, sends)),
        buffer_rate=rate)
    ref = speakers.Speakers(voices, list(zones), layout, rate, pan=pan)
    return ref.render(0, frames)


def test_filtered_tone():
    rate = 44100
    got = render([{"data": tone(rate // 2, 700.0, rate, 0.5),
                   "position": (0.5, 0.0, -1.0), "direct_gain_hf": 0.3}],
                 rate, stereo(), 4096, pan=front3_2)
    assert np.abs(got - witness("stereo_filtered_tone")).max() <= 1e-4


def test_pitch_shift_multi():
    rate = 44100
    noise = (np.random.default_rng(7).standard_normal(30000) * 0.2
             ).astype(F32)
    got = render([{"data": tone(20000, 220.0, rate, 0.5), "pitch": 1.5,
                   "position": (1.0, 0.0, -2.0)},
                  {"data": noise, "pitch": 0.77, "gain": 0.8,
                   "position": (-3.0, 0.0, -1.0)}],
                 rate, stereo(), 4096, pan=front3_2)
    assert np.abs(got - witness("stereo_pitch_multi")).max() <= 1e-5


CUSTOM = {"density": 0.35, "diffusion": 0.8, "gain": 0.32, "gain_hf": 0.6,
          "gain_lf": 0.9, "decay_time": 0.9, "decay_hf_ratio": 0.6,
          "decay_lf_ratio": 1.2, "reflections_gain": 0.4,
          "reflections_delay": 0.02, "late_reverb_gain": 0.9,
          "late_reverb_delay": 0.03, "modulation_time": 0.4,
          "modulation_depth": 0.5, "hf_reference": 4000.0,
          "lf_reference": 300.0}


@pytest.mark.parametrize("name,props", [("fx_reverb_default", {}),
                                        ("fx_reverb_custom", CUSTOM)])
def test_eaxreverb(name, props):
    rate = 48000
    got = render([{"data": tone(rate // 3, 440.0, rate, 0.4),
                   "position": (0.5, 0.2, -1.0)}],
                 rate, stereo(), 3 * 8192, zones=[props], pan=front3_2)
    assert np.abs(got - witness(name)).max() <= 1e-5


def test_itu51_dual_band_with_distance_compensation():
    """The built-in 5.1 decode's matrices through an .ambdec preset with
    speaker distances (2, 1.5, 1.8, 1.5, 2 m): each output delayed by its
    distance to the farthest speaker in whole samples and scaled by the
    distance ratio (InitDistanceComp, panning.cpp); the library's delay
    lines start uninitialised, so its first 128 frames are not compared."""
    rate = 48000
    t = np.arange(rate // 2) / rate
    got = render([{"data": (0.4 * np.sin(2 * np.pi * 441.0 * t)).astype(F32),
                   "position": (1.0, 0.0, -2.0)},
                  {"data": (0.3 * np.sin(2 * np.pi * 277.0 * t)).astype(F32),
                   "position": (-2.0, 0.0, 1.0)}],
                 rate, speakers.Layout.surround51(), 4096)
    dist = {0: 1.5, 1: 1.5, 2: 1.8, 4: 2.0, 5: 2.0}     # FL FR FC SL SR
    out = np.zeros_like(got)
    scale = F32(F32(rate) / F32(reverb.SPEED_OF_SOUND))
    for ch, d in dist.items():
        delay = int(np.floor(F32(F32(2.0 - d) * scale) + F32(0.5)))
        out[delay:, ch] = got[:len(got) - delay, ch] * F32(d / 2.0)
    want = witness("ambdec_itu51")
    assert np.abs(out[128:] - want[128:]).max() <= 1e-4
