"""The C++ reference's goldens through the port on the CPU: speaker output
(pairwise stereo, a custom dual-band ambdec decoder with distance
compensation, the front stabilizer), a direct-path filter, EAXReverb on
stereo output, Ambi3D output with near-field compensation, UHJ and TSME
stereo output at every encoder tier, UHJ2/UHJ4 and Super Stereo voices at
every decoder tier, B-Format voices, every other EFX engine (the 19
``fx_*`` goldens) and the int16 output stage with its limiter.

The scenes are those of tests/test_e2e_stereo.py, test_e2e_reverb.py,
test_e2e_ambdec.py, test_e2e_nfc.py, test_e2e_uhj_out.py,
test_e2e_codec_tiers.py, test_e2e_ambisonic.py, test_e2e_effects{,2,3,4}.py,
test_e2e_convolution_ambi.py and test_output_stage.py, and the tolerances
theirs, on
devices of 4 voices (the scenes play 1 or 2; inactive rows are masked, so
the capacity does not change the output, only the CPU's work).  The
goldens are read, never written (ROADMAP C3).  The port runs the direct
filter as the sample-sequential TDF2 (the biquad kernel's plain version),
so stereo_filtered_tone sits far below its 1e-4 budget, which the JAX
package's chunk-parallel form needs.

    python -m tests.test_torch_goldens

prints each golden's measured deviation.
"""

import contextlib
import os
import pathlib
import tempfile

import numpy as np
import pytest

from openal_soft_tpu_torch.alc import config as t_conf
from openal_soft_tpu_torch.alc.device import LoopbackDevice
from openal_soft_tpu_torch.ops.kernels import biquad as t_biq
from tests.test_e2e_ambdec import AMBDEC, AMBDEC_NOCENTER
from tests.test_e2e_ambdec import _sources as ambdec_sources
from tests.test_e2e_ambisonic import _bformat_signal as ambi_bformat
from tests.test_e2e_ambisonic import _uhj_signal as ambi_uhj
from tests.test_e2e_codec_tiers import _mono_tone as codec_mono_tone
from tests.test_e2e_codec_tiers import _stereo_prog as codec_stereo_prog
from tests.test_e2e_convolution_ambi import ORIENT as CONV_ORIENT
from tests.test_e2e_convolution_ambi import _ir as conv_ir
from tests.test_e2e_effects import _tone as fx_tone
from tests.test_e2e_effects2 import _signal as fx_signal
from tests.test_e2e_uhj_out import _sources as uhj_out_sources
from tests.test_output_stage import _tone as out_tone

GOLDEN = pathlib.Path(__file__).parent / "golden"


def _golden(name: str) -> np.ndarray:
    return np.load(GOLDEN / f"{name}.npz")["out"]


def _tone(n, freq, rate, gain=0.5):
    t = np.arange(n) / rate
    return (gain * np.sin(2 * np.pi * freq * t)).astype(np.float32)


def _play(ctx, data, rate, **props):
    buf = ctx.create_buffer()
    buf.set_data(data, "mono", "float32", rate)
    src = ctx.create_source()
    src.buffer(buf)
    src.looping = True
    for k, v in props.items():
        src.set(k, v)
    return src


@contextlib.contextmanager
def _conf(text: str, files: dict | None = None):
    """The port reads ``text`` as its alsoft.conf while devices are built;
    ``files`` (name -> text) are written beside it and ``{dir}`` in
    ``text`` names their directory."""
    old = os.environ.get("ALSOFT_CONF")
    with tempfile.TemporaryDirectory() as d:
        for name, content in (files or {}).items():
            pathlib.Path(d, name).write_text(content)
        path = pathlib.Path(d, "alsoft.conf")
        path.write_text(text.format(dir=d))
        os.environ["ALSOFT_CONF"] = str(path)
        t_conf.load_config(reload=True)
        try:
            yield
        finally:
            if old is None:
                del os.environ["ALSOFT_CONF"]
            else:
                os.environ["ALSOFT_CONF"] = old
            t_conf.load_config(reload=True)


_NOISE = (np.random.default_rng(7).standard_normal(30000) * 0.2
          ).astype(np.float32)
# (golden, device rate, [(data, buffer rate, props)]), test_e2e_stereo.py's.
STEREO = {
    "stereo_center_tone": (44100, [(_tone(22050, 441.0, 44100), 44100, {})]),
    "stereo_panned_tone": (44100, [(_tone(22050, 300.0, 44100), 44100,
                                    {"position": (2.0, 0.5, -1.5)})]),
    "stereo_resampled_tone": (48000, [(_tone(22050, 500.0, 44100), 44100,
                                       {"position": (-1.0, 0.0, -1.0)})]),
    "stereo_pitch_multi": (44100, [
        (_tone(20000, 220.0, 44100), 44100,
         {"pitch": 1.5, "position": (1.0, 0.0, -2.0)}),
        (_NOISE, 44100, {"pitch": 0.77, "gain": 0.8,
                         "position": (-3.0, 0.0, -1.0)})]),
    "stereo_filtered_tone": (44100, [(_tone(22050, 700.0, 44100), 44100,
                                      {"position": (0.5, 0.0, -1.0),
                                       "direct_gain_hf": 0.3})]),
}
REVERB = {
    "fx_reverb_default": {},
    "fx_reverb_custom": {
        "density": 0.35, "diffusion": 0.8, "gain": 0.32, "gain_hf": 0.6,
        "gain_lf": 0.9, "decay_time": 0.9, "decay_hf_ratio": 0.6,
        "decay_lf_ratio": 1.2, "reflections_gain": 0.4,
        "reflections_delay": 0.02, "late_reverb_gain": 0.9,
        "late_reverb_delay": 0.03, "modulation_time": 0.4,
        "modulation_depth": 0.5, "hf_reference": 4000.0,
        "lf_reference": 300.0},
}
# The JAX package's budgets.  The golden's first frames not compared: the
# reference's distance-compensation delay lines start uninitialised.
TOL = dict.fromkeys(STEREO, 1e-5) | dict.fromkeys(REVERB, 1e-5) | {
    "stereo_filtered_tone": 1e-4, "ambdec_itu51": 1e-4, "ambdec_stab": 1e-4,
    "nfc_ambi3d": 1e-4, "uhj_out": 1e-4, "tsme_out": 1e-4,
    "uhj2_dec_fir256": 1e-4, "uhj2_dec_fir512": 1e-4, "uhj_out_fir256": 1e-4,
    "uhj_out_fir512": 1e-4, "ss_tsme_dec_iir": 1e-4, "tsme_out_fir256": 1e-4,
    "src_bformat3d": 1e-5, "src_bformat3d_rot": 1e-5, "src_uhj2": 1e-5,
    "src_uhj4": 1e-5}
SKIP = {"ambdec_itu51": 128}

# test_e2e_effects{,2,3,4}.py's and test_e2e_convolution_ambi.py's scenes:
# golden -> (engine, properties or the convolution IR's format, the voice's
# signal, frames).  One voice at (0.7, 0, -1) on a 44.1 kHz stereo device
# sends to the slot.
FX = {
    "fx_echo": ("echo", {"delay": 0.123, "lr_delay": 0.047, "damping": 0.6,
                         "feedback": 0.55, "spread": -0.8}, "tone", 3 * 8192),
    "fx_equalizer": ("equalizer", {"low_gain": 2.0, "low_cutoff": 180.0,
                                   "mid1_gain": 0.4, "mid1_center": 700.0,
                                   "mid1_width": 0.8, "high_gain": 1.8,
                                   "high_cutoff": 5500.0}, "tone", 8192),
    "fx_convolution": ("convolution", "stereo", "tone", 2 * 8192),
    "fx_chorus": ("chorus", {"waveform": 1, "rate": 1.3, "depth": 0.08,
                             "feedback": 0.4, "delay": 0.012, "phase": 90},
                  "signal", 2 * 8192),
    "fx_flanger": ("flanger", {"waveform": 0, "rate": 0.4, "depth": 0.8,
                               "feedback": -0.45, "delay": 0.0022,
                               "phase": 30}, "signal", 2 * 8192),
    "fx_compressor": ("compressor", {"onoff": True}, "signal", 2 * 8192),
    "fx_distortion": ("distortion", {"edge": 0.4, "gain": 0.1,
                                     "lowpass_cutoff": 6000.0,
                                     "eq_center": 2500.0,
                                     "eq_bandwidth": 1500.0}, "signal", 8192),
    "fx_autowah": ("autowah", {"attack_time": 0.03, "release_time": 0.15,
                               "resonance": 500.0, "peak_gain": 20.0},
                   "signal", 8192),
    "fx_pshifter": ("pitch_shifter", {"coarse_tune": 7, "fine_tune": -30},
                    "signal", 2 * 8192),
    "fx_pshifter_down": ("pitch_shifter", {"coarse_tune": -9,
                                           "fine_tune": 15}, "signal", 8192),
    "fx_fshifter": ("frequency_shifter", {"frequency": 250.0,
                                          "left_direction": 0,
                                          "right_direction": 1},
                    "signal", 2 * 8192),
    "fx_fshifter_off": ("frequency_shifter", {"frequency": 120.0,
                                              "left_direction": 2,
                                              "right_direction": 0},
                        "signal", 8192),
    "fx_vmorpher": ("vocal_morpher", {"phoneme_a": 0, "phoneme_b": 4,
                                      "phoneme_a_coarse": 0,
                                      "phoneme_b_coarse": -5, "waveform": 0,
                                      "rate": 3.0}, "signal", 2 * 8192),
    "fx_modulator_sin": ("ring_modulator", {"frequency": 130.0,
                                            "highpass_cutoff": 600.0,
                                            "waveform": 0}, "tone", 2 * 8192),
    "fx_modulator_saw": ("ring_modulator", {"frequency": 130.0,
                                            "highpass_cutoff": 600.0,
                                            "waveform": 1}, "tone", 2 * 8192),
    "fx_modulator_square": ("ring_modulator", {"frequency": 130.0,
                                               "highpass_cutoff": 600.0,
                                               "waveform": 2},
                            "tone", 2 * 8192),
    "fx_dedicated_dialog": ("dedicated_dialog", {"gain": 0.8}, "tone", 8192),
    "fx_conv_bformat3d": ("convolution", "bformat3d", "tone", 8192),
    "fx_conv_uhj2": ("convolution", "uhj2", "tone", 8192),
}
TOL |= dict.fromkeys(FX, 1e-4) | {"fx_pshifter": 1e-3,
                                  "fx_pshifter_down": 1e-3}
FX_RATE = 44100


def _fx_ir(fmt: str) -> np.ndarray:
    """test_e2e_effects.py's 6000-sample stereo IR, or
    test_e2e_convolution_ambi.py's B-Format 3D / UHJ2 IRs."""
    if fmt == "bformat3d":
        return conv_ir(4, seed=21)
    if fmt == "uhj2":
        return conv_ir(2, seed=22)
    rng = np.random.default_rng(11)
    t = np.arange(6000) / FX_RATE
    return (rng.standard_normal((6000, 2)) * np.exp(-t * 12.0)[:, None]
            * 0.4).astype(np.float32)


def render_fx(name: str):
    engine, props, signal, frames = FX[name]
    dev = LoopbackDevice(frequency=FX_RATE, channels="stereo",
                         sample_type="float32", capacity=4, device="cpu")
    ctx = dev.create_context()
    slot = ctx.create_aux_slot()
    eff = ctx.create_effect(engine)
    if engine == "convolution":
        if props == "bformat3d":
            eff.set("orient_at", CONV_ORIENT[:3])
            eff.set("orient_up", CONV_ORIENT[3:])
        slot.set_effect(eff)
        irb = ctx.create_buffer()
        irb.set_data(_fx_ir(props), props, "float32", FX_RATE)
        slot.set_buffer(irb)
    else:
        for k, v in props.items():
            eff.set(k, v)
        slot.set_effect(eff)
    data = (fx_tone(FX_RATE // 2, 440.0) if signal == "tone"
            else fx_signal(FX_RATE // 2))
    src = _play(ctx, data, FX_RATE, position=(0.7, 0.0, -1.0))
    src.send(slot, 0)
    src.play()
    return dev, dev.render_samples(frames)


def render_stereo(name: str):
    rate, sources = STEREO[name]
    dev = LoopbackDevice(frequency=rate, channels="stereo",
                         sample_type="float32", capacity=4, device="cpu")
    ctx = dev.create_context()
    srcs = [_play(ctx, data, brate, **props) for data, brate, props in sources]
    for src in srcs:
        src.play()
    return dev, dev.render_samples(4096)


def render_reverb(name: str):
    """test_e2e_reverb.py's scene: one voice sending to an EAXReverb slot,
    pairwise stereo output, 3 x 8192 frames."""
    dev = LoopbackDevice(frequency=48000, channels="stereo",
                         sample_type="float32", capacity=4, device="cpu")
    ctx = dev.create_context()
    slot = ctx.create_aux_slot()
    eff = ctx.create_effect("eaxreverb")
    for k, v in REVERB[name].items():
        eff.set(k, v)
    slot.set_effect(eff)
    src = _play(ctx, _tone(16000, 440.0, 48000, 0.4), 48000,
                position=(0.5, 0.2, -1.0))
    src.send(slot, 0)
    src.play()
    return dev, dev.render_samples(3 * 8192)


def render_ambdec(name: str):
    """test_e2e_ambdec.py's surround51 scenes: its custom dual-band preset
    with unequal speaker distances (ambdec_itu51), or its single-band
    preset without a center and the front stabilizer on (ambdec_stab)."""
    preset, extra = ((AMBDEC, "") if name == "ambdec_itu51"
                     else (AMBDEC_NOCENTER, "front-stablizer = true\n"))
    with _conf(extra + "[decoder]\nsurround51 = {dir}/test51.ambdec\n",
               {"test51.ambdec": preset}):
        dev = LoopbackDevice(frequency=48000, channels="surround51",
                             sample_type="float32", capacity=4, device="cpu")
    ctx = dev.create_context()
    for s in ambdec_sources():
        _play(ctx, s["data"], 48000, position=s["position"]).play()
    return dev, dev.render_samples(4096)


def render_nfc(name: str):
    """test_e2e_nfc.py's scene: order-2 Ambi3D output with NFC at a 1.5 m
    control distance; a distant tone and a head-relative noise at the
    origin (the w1 alignment filter)."""
    with _conf("[decoder]\nnfc = true\nspeaker-dist = 1.5\n"):
        dev = LoopbackDevice(frequency=48000, channels="ambi3d",
                             sample_type="float32", capacity=4,
                             ambi_order=2, device="cpu")
    ctx = dev.create_context()
    t = np.arange(24000) / 48000
    _play(ctx, (0.5 * np.sin(2 * np.pi * 441.0 * t)).astype(np.float32),
          48000, position=(1.0, 0.5, -2.0)).play()
    noise = (np.random.default_rng(3).standard_normal(20000) * 0.2
             ).astype(np.float32)
    _play(ctx, noise, 48000, position=(0.0, 0.0, 0.0),
          head_relative=True).play()
    return dev, dev.render_samples(4096)


def _one_source(conf: str, fmt: str, data, position, frames: int,
                **props):
    """One looping source of ``data`` (buffer format ``fmt``) at
    ``position`` on a stereo device built under ``conf``."""
    with _conf(conf):
        dev = LoopbackDevice(frequency=48000, channels="stereo",
                             sample_type="float32", capacity=4, device="cpu")
    ctx = dev.create_context()
    buf = ctx.create_buffer()
    buf.set_data(data, fmt, "float32", 48000)
    src = ctx.create_source()
    src.buffer(buf)
    src.looping = True
    src.set("position", position)
    for k, v in props.items():
        src.set(k, v)
    src.play()
    return dev, dev.render_samples(frames)


def render_uhj_out(name: str):
    """test_e2e_uhj_out.py's scenes: two mono tones on UHJ or TSME stereo
    output (the default IIR encoders)."""
    enc = "uhj" if name == "uhj_out" else "tsme"
    with _conf(f"stereo-encoding = {enc}\n"):
        dev = LoopbackDevice(frequency=48000, channels="stereo",
                             sample_type="float32", capacity=4, device="cpu")
    ctx = dev.create_context()
    for s in uhj_out_sources():
        _play(ctx, s["data"], 48000, position=s["position"]).play()
    return dev, dev.render_samples(4096)


# test_e2e_codec_tiers.py's scenes: (alsoft.conf, buffer format, data).
CODEC = {
    "uhj2_dec_fir256": ("[uhj]\ndecode-filter = fir256\n", "uhj2", "prog"),
    "uhj2_dec_fir512": ("[uhj]\ndecode-filter = fir512\n", "uhj2", "prog"),
    "uhj_out_fir256": ("stereo-encoding = uhj\n[uhj]\nencode-filter = "
                       "fir256\n", "mono", "tone"),
    "uhj_out_fir512": ("stereo-encoding = uhj\n[uhj]\nencode-filter = "
                       "fir512\n", "mono", "tone"),
    "ss_tsme_dec_iir": ("stereo-encoding = tsme\n", "superstereo", "prog"),
    "tsme_out_fir256": ("stereo-encoding = tsme\n[tsme]\nencode-filter = "
                        "fir256\n", "mono", "tone"),
}


def render_codec(name: str):
    conf, fmt, data = CODEC[name]
    data = codec_stereo_prog() if data == "prog" else codec_mono_tone()
    return _one_source(conf, fmt, data, (0.4, 0.0, -1.0), 4096)


# test_e2e_ambisonic.py's scenes: (buffer format, data, frames, props).
AMBI = {
    "src_bformat3d": ("bformat3d", ambi_bformat(48000 // 4), 2 * 8192, {}),
    "src_bformat3d_rot": ("bformat3d", ambi_bformat(48000 // 4), 8192,
                          {"orient_at": (0.5, 0.1, -0.8),
                           "orient_up": (0.0, 1.0, 0.1)}),
    "src_uhj2": ("uhj2", ambi_uhj(48000 // 4, 2), 2 * 8192, {}),
    "src_uhj4": ("uhj4", ambi_uhj(48000 // 4, 4), 2 * 8192, {}),
}


def render_ambi(name: str):
    fmt, data, frames, props = AMBI[name]
    return _one_source("", fmt, data, (0.4, 0.1, -1.0), frames, **props)


RENDER = (dict.fromkeys(STEREO, render_stereo)
          | dict.fromkeys(REVERB, render_reverb)
          | {"ambdec_itu51": render_ambdec, "ambdec_stab": render_ambdec,
             "nfc_ambi3d": render_nfc}
          | dict.fromkeys(("uhj_out", "tsme_out"), render_uhj_out)
          | dict.fromkeys(CODEC, render_codec)
          | dict.fromkeys(AMBI, render_ambi)
          | dict.fromkeys(FX, render_fx))


def deviation(name: str):
    """(device, output, max abs deviation from the golden)."""
    dev, got = RENDER[name](name)
    skip = SKIP.get(name, 0)
    return dev, got, float(np.abs(got[skip:] - _golden(name)[skip:]).max())


@pytest.mark.parametrize("name", list(RENDER))
def test_golden_through_the_port(name):
    before = t_biq.biquad_dual.launches
    dev, got, err = deviation(name)
    assert t_biq.biquad_dual.launches == before    # plain on the CPU
    assert err <= TOL[name], f"{name}: max deviation {err:.3e}"
    if name == "ambdec_itu51":
        assert dev._dec_lf is not None and dev._dist_comp is not None
        assert np.abs(got[:128]).max() < 1.0
    if name == "ambdec_stab":
        assert dev._stab is not None
        assert np.abs(got[:, 2]).max() > 1e-4      # FC gets the stabilized mid
    if name == "nfc_ambi3d":
        assert dev.nfc is not None


def test_int16_output_stage_through_the_port():
    """test_output_stage.py's scene: a hot tone on an int16 stereo device,
    so that the limiter engages; the port's limiter, dither and
    quantization within 1 LSB of the golden (C12)."""
    rate = 48000
    dev = LoopbackDevice(frequency=rate, channels="stereo",
                         sample_type="int16", capacity=4, device="cpu")
    assert dev.limiter is not None
    ctx = dev.create_context()
    src = _play(ctx, out_tone(rate // 4, 300.0, 1.4), rate,
                position=(0.3, 0.0, -1.0))
    src.play()
    got = dev.render_samples(3 * 4096)
    want = _golden("int16_limited")
    assert got.dtype == np.int16 and got.shape == want.shape
    assert np.abs(got.astype(np.int32) - want.astype(np.int32)).max() <= 1
    assert np.abs(want).max() >= 32000       # the limiter engaged


if __name__ == "__main__":
    for name in RENDER:
        print(f"{name}: max deviation {deviation(name)[2]:.3e} "
              f"(tolerance {TOL[name]:g})")
