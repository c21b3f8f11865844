"""AL effect objects (al/effect.cpp + al/effects/*.cpp property layer).

An Effect holds validated EFX properties for one effect type; attaching it
to an aux slot snapshots the properties into the slot (al/auxeffectslot.cpp).
Defaults match the EFX specification values used by the reference.
"""

from __future__ import annotations

from ..effects import effect_registry

EFFECT_DEFAULTS: dict[str, dict] = {
    "null": {},
    "echo": {"delay": 0.1, "lr_delay": 0.1, "damping": 0.5,
             "feedback": 0.5, "spread": -1.0},
    "equalizer": {"low_gain": 1.0, "low_cutoff": 200.0,
                  "mid1_gain": 1.0, "mid1_center": 500.0, "mid1_width": 1.0,
                  "mid2_gain": 1.0, "mid2_center": 3000.0, "mid2_width": 1.0,
                  "high_gain": 1.0, "high_cutoff": 6000.0},
    "ring_modulator": {"frequency": 440.0, "highpass_cutoff": 800.0,
                       "waveform": 0},
    "dedicated_dialog": {"gain": 1.0},
    "convolution": {"buffer": None, "orient_at": (0.0, 0.0, -1.0),
                    "orient_up": (0.0, 1.0, 0.0)},
    "dedicated_lfe": {"gain": 1.0},
    "chorus": {"waveform": 1, "rate": 1.1, "depth": 0.1, "feedback": 0.25,
               "delay": 0.016, "phase": 90},
    "flanger": {"waveform": 1, "rate": 0.27, "depth": 1.0, "feedback": -0.5,
                "delay": 0.002, "phase": 0},
    "compressor": {"onoff": True},
    "distortion": {"edge": 0.2, "gain": 0.05, "lowpass_cutoff": 8000.0,
                   "eq_center": 3600.0, "eq_bandwidth": 3600.0},
    "autowah": {"attack_time": 0.06, "release_time": 0.06,
                "resonance": 1000.0, "peak_gain": 11.22},
    "pitch_shifter": {"coarse_tune": 12, "fine_tune": 0},
    "frequency_shifter": {"frequency": 0.0, "left_direction": 0,
                          "right_direction": 0},
    "vocal_morpher": {"phoneme_a": 0, "phoneme_b": 10,
                      "phoneme_a_coarse": 0, "phoneme_b_coarse": 0,
                      "waveform": 0, "rate": 1.41},
    # Standard reverb property set (AL_EFFECT_REVERB); eaxreverb extends it.
    "reverb": {
        "density": 1.0, "diffusion": 1.0, "gain": 0.32, "gain_hf": 0.89,
        "gain_lf": 1.0, "decay_time": 1.49, "decay_hf_ratio": 0.83,
        "decay_lf_ratio": 1.0, "reflections_gain": 0.05,
        "reflections_delay": 0.007, "reflections_pan": (0.0, 0.0, 0.0),
        "late_reverb_gain": 1.26, "late_reverb_delay": 0.011,
        "late_reverb_pan": (0.0, 0.0, 0.0), "echo_time": 0.25,
        "echo_depth": 0.0, "modulation_time": 0.25, "modulation_depth": 0.0,
        "air_absorption_gain_hf": 0.994, "hf_reference": 5000.0,
        "lf_reference": 250.0, "room_rolloff_factor": 0.0,
        "decay_hf_limit": True,
    },
}
EFFECT_DEFAULTS["eaxreverb"] = EFFECT_DEFAULTS["reverb"]

# `excludefx` reference spellings -> our registry names (alsoftrc.sample).
_EXCLUDEFX_NAMES = {
    "eaxreverb": "eaxreverb", "reverb": "reverb", "chorus": "chorus",
    "compressor": "compressor", "distortion": "distortion", "echo": "echo",
    "equalizer": "equalizer", "flanger": "flanger",
    "modulator": "ring_modulator", "dedicated": "dedicated_dialog",
    "pshifter": "pitch_shifter", "fshifter": "frequency_shifter",
    "vmorpher": "vocal_morpher", "autowah": "autowah",
    "convolution": "convolution",
}


def _excluded_effects() -> set:
    """Effect names disabled by the `excludefx` config key (recomputed per
    call: tests reload the config between scenarios)."""
    from ..alc import config as alconf

    names = (alconf.config_value_str("", "excludefx") or "")
    out = set()
    for n in names.split(","):
        n = n.strip().lower()
        if n in _EXCLUDEFX_NAMES:
            out.add(_EXCLUDEFX_NAMES[n])
            if n == "dedicated":
                out.add("dedicated_lfe")
    return out


class Effect:
    def __init__(self, eid: int, effect_type: str = "null") -> None:
        self.id = eid
        self.set_type(effect_type)

    def set_type(self, effect_type: str) -> None:
        if effect_type not in EFFECT_DEFAULTS:
            raise ValueError(f"unknown effect type: {effect_type}")
        if effect_type != "null" and effect_type in _excluded_effects():
            # `excludefx` config key (alc/alc.cpp:1101-1123): excluded
            # effects report as unsupported.
            raise ValueError(f"effect type excluded by config: {effect_type}")
        self.type = effect_type
        self.props = dict(EFFECT_DEFAULTS[effect_type])

    def set(self, name: str, value) -> None:
        if name not in self.props:
            raise ValueError(f"{self.type} has no property {name}")
        self.props[name] = value

    def get(self, name: str):
        return self.props[name]

    def load_preset(self, preset: dict) -> None:
        """Apply an EFX reverb preset dict (see al/presets.py)."""
        for k, v in preset.items():
            if k in self.props:
                self.props[k] = v
