"""EAXReverb / Reverb effect engine (port of effects/reverb.py).

The reference (alc/effects/reverb.cpp) is a 4-line feedback delay network:
a main input delay feeds early reflections (decorrelating taps -> band
filters -> 4-line all-pass -> geometric reflection into an echo delay),
whose scattered output feeds the late reverb (modulated feedback delays ->
T60 damping -> input taps -> Gerzon vector all-pass -> FDN scatter
re-feed).  Two complete pipelines exist; "full" parameter updates switch
to the spare pipeline and cross-fade the old one out (reverb.cpp:1266-1271).

The host half (``__init__``, ``update``, ``_pan_gains``, ``advance``) is the
JAX package's, in numpy.  The device half runs each pipeline through
``ops/kernels/reverb.py``: the plain torch version on the CPU, kernel K6
(``csrc/reverb.cu``) on the card — the current pipeline "A", the old
pipeline "B" while a crossfade is in flight, at any window the device
dispatches (a 1024-sample block or a whole super-block).  The first-order
upmix of higher-order devices (its HF scale through the chunk-parallel
band splitter) runs in torch after the pipeline.  Carried
state is a dict of tensors updated in place.

Property names follow EFX in snake_case; defaults are the AL_EAXREVERB
defaults (include/AL/efx.h:317-401).
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import ambidefs, panning
from ..ops import filters as f_ops
from ..ops import spec
from ..ops.kernels import reverb as rev_k
from .base import EffectState, effect_mix, register

f32 = np.float32

MAX_UPDATE_SAMPLES = 256
NUM_LINES = 4
MOD_FRACBITS = 24
MOD_FRACONE = 1 << MOD_FRACBITS
MODULATION_DEPTH_COEFF = 0.05
DEFAULT_MOD_TIME = 0.25
MAX_MOD_TIME = 4.0
DENSITY_SCALE = 1000.0
INV_SQRT2 = float(1.0 / np.sqrt(2.0))
SQRT3 = float(np.sqrt(3.0))
REVERB_DECAY_GAIN = 0.001            # core/effects/base.h:21 (-60 dB)
MAX_REFLECTIONS_DELAY = 0.3
MAX_LATE_DELAY = 0.1

B2A = np.array([                     # reverb.cpp:88 (W Y Z X -> A0..A3)
    [0.5,  0.5,  0.5,  0.5],
    [0.5, -0.5, -0.5,  0.5],
    [0.5,  0.5, -0.5, -0.5],
    [0.5, -0.5,  0.5, -0.5]], f32)
EARLY_A2B = np.array([               # reverb.cpp:99
    [0.5,  0.5,  0.5,  0.5],
    [0.5, -0.5,  0.5, -0.5],
    [0.5, -0.5, -0.5,  0.5],
    [0.5,  0.5, -0.5, -0.5]], f32)
LATE_A2B = np.array([                # reverb.cpp:113
    [0.5, 0.5, 0.5, 0.5],
    [INV_SQRT2, -INV_SQRT2, 0.0, 0.0],
    [0.0, 0.0, -INV_SQRT2, INV_SQRT2],
    [0.5, 0.5, -0.5, -0.5]], f32)
# Geometric reflection (DelayLineU::writeReflected, reverb.cpp:323-343).
REFLECT = (np.full((4, 4), -0.5, f32) + np.eye(4, dtype=f32))

EARLY_TAP_LENGTHS = np.array([0.0, 1.010676e-3, 2.126553e-3, 3.358580e-3])
EARLY_ALLPASS_LENGTHS = np.array([4.854840e-4, 5.360178e-4, 5.918117e-4,
                                  6.534130e-4])
EARLY_LINE_LENGTHS = np.array([2.992520e-3, 5.456575e-3, 7.688329e-3,
                               9.709681e-3])
LATE_ALLPASS_LENGTHS = np.array([8.091400e-4, 1.019453e-3, 1.407968e-3,
                                 1.618280e-3])
LATE_LINE_LENGTHS = np.array([9.709681e-3, 1.223343e-2, 1.689561e-2,
                              1.941936e-2])

DEFAULTS = {
    "density": 1.0, "diffusion": 1.0, "gain": 0.32, "gain_hf": 0.89,
    "gain_lf": 1.0, "decay_time": 1.49, "decay_hf_ratio": 0.83,
    "decay_lf_ratio": 1.0, "reflections_gain": 0.05,
    "reflections_delay": 0.007, "reflections_pan": (0.0, 0.0, 0.0),
    "late_reverb_gain": 1.26, "late_reverb_delay": 0.011,
    "late_reverb_pan": (0.0, 0.0, 0.0), "echo_time": 0.25, "echo_depth": 0.0,
    "modulation_time": 0.25, "modulation_depth": 0.0,
    "air_absorption_gain_hf": 0.994, "hf_reference": 5000.0,
    "lf_reference": 250.0, "room_rolloff_factor": 0.0,
    "decay_hf_limit": True,
}


def _reverb_boost() -> float:
    """`[reverb] boost` config key: reverb output gain adjust in dB
    (alc/alc.cpp:615-624; ReverbBoost)."""
    from ..alc import config as alconf

    db = alconf.config_value_float("reverb", "boost", 0.0) or 0.0
    return float(10.0 ** (db / 20.0)) if db else 1.0


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p <<= 1
    return p


def _cubic_filter_table() -> np.ndarray:
    """gCubicTable (core/cubic_tables.cpp:109-128): [256, 4] f32 coeffs."""
    steps = 256

    def get_coeff(idx):
        k = 0.5 + idx
        if k > 512.0:
            return 0.0
        s = np.sin(np.pi * 1.280 / 1024.0 * k)
        t = (np.cos(np.pi * 2.000 / 1023.0 * k) - 1.0) * 0.50
        u = (np.cos(np.pi * 4.000 / 1023.0 * k) - 1.0) * 0.08
        return s * (t + u + 1.0) / k

    filt = np.zeros(steps * 2 + 1)
    scale_idx = 512.0 / (steps * 2)
    for i in range(steps // 2 + 1):
        c0 = get_coeff((steps + i) * scale_idx)
        c1 = get_coeff(i * scale_idx)
        c2 = get_coeff((steps - i) * scale_idx)
        c3 = get_coeff((steps * 2 - i) * scale_idx)
        s = 1.0 / (c0 + c1 + c2 + c3)
        filt[steps + i] = np.float32(c0 * s)
        filt[i] = np.float32(c1 * s)
        filt[steps - i] = np.float32(c2 * s)
        filt[steps * 2 - i] = np.float32(c3 * s)
    filt = filt.astype(f32)
    i = np.arange(steps)
    return np.stack([filt[steps + i], filt[i], filt[steps - i],
                     filt[steps * 2 - i]], axis=1)


_CUBIC_TAB = _cubic_filter_table()


def _calc_delay_mult(density: float) -> f32:
    return f32(max(1.0, np.cbrt(f32(density * DENSITY_SCALE))))


def _decay_coeff(length, decay_time) -> f32:
    return f32(np.power(f32(REVERB_DECAY_GAIN), f32(length / decay_time)))


def _shelf(kind: str, f0norm, gain) -> np.ndarray:
    """setParamsFromSlope with slope 1 (biquad.h:92-97)."""
    gain = f32(max(gain, 0.001))
    rcpq = f32(np.sqrt(f32((gain + 1.0 / gain) * (1.0 / 1.0 - 1.0) + 2.0)))
    return spec.biquad_set_params(kind, f32(f0norm), gain, rcpq)


def _transform_from_vector(vec) -> np.ndarray:
    """GetTransformFromVector (reverb.cpp:1099-1136), transposed layout."""
    norm = np.array(vec, f32)
    mag = f32(np.sqrt(f32(np.dot(norm, norm))))
    if mag > 1.0:
        scale = f32(SQRT3 / mag)
        norm = norm * np.array([-scale, scale, scale], f32)
        mag = f32(1.0)
    else:
        norm = norm * np.array([-SQRT3, SQRT3, SQRT3], f32)
    return np.array([
        [1.0, norm[0], norm[1], norm[2]],
        [0.0, 1.0 - mag, 0.0, 0.0],
        [0.0, 0.0, 1.0 - mag, 0.0],
        [0.0, 0.0, 0.0, 1.0 - mag]], f32)


@register("eaxreverb")
class ReverbEffect(EffectState):
    defaults = DEFAULTS
    # The keys of update()'s result that the device half reads.
    device_params = ("pi", "pf", "g_early", "g_late",
                     "old_pi", "old_pf", "old_g_early", "old_g_late")

    def __init__(self, device) -> None:
        super().__init__(device)
        freq = device.sample_rate
        self.freq = f32(freq)
        # Static chunk size: must not exceed the shortest possible late
        # feedback lag (LATE_LINE_LENGTHS[0] at density_mult=1).
        ch = 64
        while ch * 2 <= min(MAX_UPDATE_SAMPLES,
                            int(LATE_LINE_LENGTHS[0] * freq + 0.5) - 1):
            ch *= 2
        self.chunk = ch
        self.granularity = ch   # dispatch block sizes must chunk evenly
        # Static fixed-point pass counts from the density_mult=1 lower
        # bounds of the all-pass lags.
        self.early_ap_passes = -(-ch // max(int(EARLY_ALLPASS_LENGTHS[0] * freq), 1))
        self.late_ap_passes = -(-ch // max(int(LATE_ALLPASS_LENGTHS[0] * freq), 1))
        self.mod_win = int(freq / 160.0) + 8   # max (idelay>>8) + cubic taps

        mult = _calc_delay_mult(1.0)
        late_diff_avg = (LATE_LINE_LENGTHS[-1] - LATE_LINE_LENGTHS[0]) / NUM_LINES
        max_mod_delay = MAX_MOD_TIME * MODULATION_DEPTH_COEFF / 2.0
        vecap_extra = int(np.ceil(LATE_ALLPASS_LENGTHS[0] * mult * freq))
        self.len_main = _next_pow2(int(np.ceil(
            (MAX_REFLECTIONS_DELAY + EARLY_TAP_LENGTHS[-1] * mult) * freq)) + 1024)
        self.len_late_in = _next_pow2(int(np.ceil(
            (MAX_LATE_DELAY + late_diff_avg * mult) * freq)) + 1024)
        self.len_early_ap = _next_pow2(int(np.ceil(
            EARLY_ALLPASS_LENGTHS[-1] * mult * freq)))
        self.len_early = _next_pow2(int(np.ceil(
            EARLY_LINE_LENGTHS[-1] * mult * freq)) + MAX_UPDATE_SAMPLES)
        self.len_vecap = _next_pow2(int(np.ceil(
            LATE_ALLPASS_LENGTHS[-1] * mult * freq)) + vecap_extra)
        self.len_late = _next_pow2(int(np.ceil(
            LATE_LINE_LENGTHS[-1] * mult * freq + max_mod_delay * freq)) + 4)
        # Ring lengths are chunk multiples so chunk writes never wrap; the
        # 1024 floor keeps the JAX package's ring shapes (its snapshots
        # restore here).  Reads index modulo the power-of-two length.
        for name in ("len_main", "len_late_in", "len_early_ap", "len_early",
                     "len_vecap", "len_late"):
            setattr(self, name, max(getattr(self, name), 2 * self.chunk,
                                    1024))

        # ReverbState::deviceUpdate: the upmix's HF scales follow the
        # device's 2D mixing (GetHFOrderScales(1, order, m2DMixing)).
        self.upmix = device.layout.ambi_order > 1
        if self.upmix:
            self.order_scales = ambidefs.hf_order_scales(
                1, device.layout.ambi_order, device.layout.m2d_mixing)
            self.first_order_up = ambidefs.first_order_up()
        self._splitter_coeff = None

        # Host-side previous values for tap crossfades + pipeline swap.
        self._serial = 0
        self._params = None       # previous full-update key
        self._prev = None         # previous pipeline params (dict)
        self._old_params = None   # fading old-pipeline params
        self._fade_blocks = 0     # blocks left of old-pipeline fade
        self._old_active = False
        self._late_tap_max = {}   # per pipeline prefix, from update()

    # -- host half -----------------------------------------------------------

    def state_signature(self):
        return ("eaxreverb", self.chunk, self._old_active, self.upmix)

    def horizon_blocks(self) -> int:
        if self._old_active:
            return max(self._fade_blocks, 1)
        return 1 << 30

    def advance(self, frames: int) -> None:
        """Host mirror of the old-pipeline fade countdown."""
        if not self._old_active:
            return
        blocks = frames // 1024 if frames >= 1024 else 1
        was = self._fade_blocks
        self._fade_blocks -= blocks
        if was > 0 >= self._fade_blocks:
            self.device.mark_config_dirty()
        if self._fade_blocks <= -1:
            # Old pipeline fully faded and its last silent block rendered:
            # zero its delay state and drop it from the graph.
            dev = self.device
            slot_state = dev._state.get(f"slot{self._slot_index}")
            if slot_state is not None:
                for v in slot_state["B"].values():
                    v.zero_()
            self._old_active = False
            self._old_params = None
            dev.mark_config_dirty()

    def _pipeline_state(self) -> dict:
        # The modulation index (uint32 in the JAX package) and the serial
        # are int64 scalars here; the index is kept below 2**32.
        dev = self.device.torch_device
        z = lambda *shape: torch.zeros(shape, dtype=torch.float32, device=dev)
        st = {
            "late_in": z(NUM_LINES, self.len_late_in),
            "early_ap": z(NUM_LINES, self.len_early_ap),
            "early_dl": z(NUM_LINES, self.len_early),
            "vecap": z(NUM_LINES, self.len_vecap),
            "late_dl": z(NUM_LINES, self.len_late),
            "lp_z": z(NUM_LINES, 2), "hp_z": z(NUM_LINES, 2),
            "t60_hf_z": z(NUM_LINES, 2), "t60_lf_z": z(NUM_LINES, 2),
            "mod_index": torch.zeros((), dtype=torch.int64, device=dev),
            "serial_done": torch.full((), -1, dtype=torch.int64, device=dev),
            "g_early_cur": z(NUM_LINES, self.device.n_dry),
            "g_late_cur": z(NUM_LINES, self.device.n_dry),
        }
        if self.upmix:
            st["split_early"] = z(NUM_LINES, 3)
            st["split_late"] = z(NUM_LINES, 3)
        return st

    def max_window(self) -> int:
        # The only full-window ring write is the main input line, made
        # before any chunk reads its taps, so a window must not overwrite
        # the slots its own longest tap still reads: W + max tap <=
        # len_main.  (The JAX package allows len_main itself, which at
        # 44.1 kHz lets a 16384-sample window read its own future input;
        # ROADMAP C5.)  All other rings write chunk by chunk.
        max_tap = int(np.ceil((MAX_REFLECTIONS_DELAY + EARLY_TAP_LENGTHS[-1]
                               * _calc_delay_mult(1.0)) * self.freq))
        w = self.chunk
        while 2 * w + max_tap <= self.len_main:
            w *= 2
        return w

    def device_update(self, buffer=None) -> dict:
        self._splitter_coeff = float(f_ops.band_splitter_coeff(
            getattr(self.device.layout, "xover_f0norm", 400.0 / self.freq)))
        self._upmix_split = f_ops.BandSplitterKernels(self._splitter_coeff)
        self._serial = 0
        self._params = None
        self._prev = None
        self._old_params = None
        self._old_active = False
        self._fade_blocks = 0
        self._late_tap_max = {}
        dev = self.device.torch_device
        return {
            "offset": torch.zeros((), dtype=torch.int64, device=dev),
            "main": torch.zeros((NUM_LINES, self.len_main),
                                dtype=torch.float32, device=dev),
            "A": self._pipeline_state(),
            "B": self._pipeline_state(),
        }

    def update(self, slot, props) -> dict:
        self._slot_index = slot.index
        p = dict(DEFAULTS)
        p.update({k: v for k, v in props.items() if v is not None})
        freq = self.freq

        hf_ratio = f32(p["decay_hf_ratio"])
        if p["decay_hf_limit"] and p["air_absorption_gain_hf"] < 1.0:
            # CalcLimitedHfRatio (reverb.cpp:893-906)
            decay_len = f32(np.log10(f32(p["air_absorption_gain_hf"]))
                            * p["decay_time"] / -3.0)
            limit = f32(1.0 / 343.3 / decay_len)
            hf_ratio = f32(min(limit, hf_ratio))
        lf_decay = f32(np.clip(p["decay_time"] * p["decay_lf_ratio"], 0.1, 20.0))
        hf_decay = f32(np.clip(p["decay_time"] * hf_ratio, 0.1, 20.0))

        full_key = (p["density"], p["diffusion"], p["decay_time"],
                    float(hf_decay), float(lf_decay), p["modulation_time"],
                    p["modulation_depth"], p["hf_reference"],
                    p["lf_reference"])
        full_update = self._params != full_key
        if full_update and self._params is not None:
            # Pipeline switch: the spare becomes current.  Swap the state
            # subtrees host-side (pure relabeling between dispatches) so the
            # graph always processes pipeline "A" as current.
            dev = self.device
            st = dev._state.get(f"slot{slot.index}")
            if st is not None:
                st["A"], st["B"] = st["B"], st["A"]
            self._old_params = self._prev
            if self._old_params is not None:
                self._old_params = dict(self._old_params)
                self._old_params["early_coeff0"] = \
                    self._old_params["early_coeff1"]
                self._old_params["early_coeff1"] = np.float32(0.0)
            self._old_active = self._old_params is not None
            self._prev = None
        self._params = full_key
        self._serial += 1

        mult = _calc_delay_mult(p["density"])
        prev = self._prev

        # Delay taps (updateDelayLine, reverb.cpp:1063-1096)
        early_taps = np.array([int(f32((l * mult + p["reflections_delay"]) * freq))
                               for l in EARLY_TAP_LENGTHS], np.int32)
        late_taps = np.array([int(f32(((l - LATE_LINE_LENGTHS[0]) / NUM_LINES * mult
                                       + p["late_reverb_delay"]) * freq))
                              for l in LATE_LINE_LENGTHS], np.int32)
        early_coeff = f32(p["gain"])

        # Early lines (EarlyReflections::updateLines, reverb.cpp:927-950)
        e_ap_coeff = f32(p["diffusion"] ** 2 * INV_SQRT2)
        e_ap_off = np.array([int(f32(l * mult * freq))
                             for l in EARLY_ALLPASS_LENGTHS], np.int32)
        e_off = np.array([int(f32(l * mult * freq))
                          for l in EARLY_LINE_LENGTHS], np.int32)
        e_avg = float(np.sum(EARLY_LINE_LENGTHS) / NUM_LINES * mult)
        e_coeff = _decay_coeff(e_avg, p["decay_time"])

        # Modulation (reverb.cpp:956-988)
        mod_step = max(int(np.rint(f32(MOD_FRACONE / (freq * p["modulation_time"])))), 1)
        mt = (DEFAULT_MOD_TIME if p["modulation_time"] >= DEFAULT_MOD_TIME
              else p["modulation_time"])
        mod_depth = f32(MODULATION_DEPTH_COEFF / 4.0 * mt
                        * p["modulation_depth"] * freq)

        # Late lines (LateReverb::updateLines, reverb.cpp:992-1060)
        hf0 = f32(min(p["hf_reference"] / freq, 0.49))
        lf0 = f32(min(p["lf_reference"] / freq, 0.49))
        nwf = f32(freq / 20000.0)
        ap_avg = float(np.sum(LATE_ALLPASS_LENGTHS) / NUM_LINES)
        delay_avg = float(np.sum(LATE_LINE_LENGTHS) / NUM_LINES + ap_avg)
        decay_w = f32(lf0 * nwf * lf_decay + (hf0 - lf0) * nwf * p["decay_time"]
                      + (1.0 - hf0 * nwf) * hf_decay)
        a = _decay_coeff(delay_avg * mult, decay_w)
        density_gain = f32(np.sqrt(f32(1.0 - a * a)))
        l_ap_coeff = f32(p["diffusion"] ** 2 * INV_SQRT2)
        l_ap_off = np.array([int(f32(l * mult * freq))
                             for l in LATE_ALLPASS_LENGTHS], np.int32)
        l_off = np.array([max(int(f32(l * mult * freq + 0.5)), 1) - 1
                          for l in LATE_LINE_LENGTHS], np.int32)
        # T60 per line (lengths include diffusion-lerped all-pass + mod depth)
        mod_delay = float(mod_depth / freq)
        t60_mid = np.zeros(NUM_LINES, f32)
        t60_hf = np.zeros((NUM_LINES, 5), f32)
        t60_lf = np.zeros((NUM_LINES, 5), f32)
        for i in range(NUM_LINES):
            ln = f32((LATE_ALLPASS_LENGTHS[i] + (ap_avg - LATE_ALLPASS_LENGTHS[i])
                      * p["diffusion"]) * mult + mod_delay
                     + LATE_LINE_LENGTHS[i] * mult)
            mf = _decay_coeff(ln, p["decay_time"])
            lfg = f32(_decay_coeff(ln, lf_decay) / mf)
            hfg = f32(_decay_coeff(ln, hf_decay) / mf)
            t60_mid[i] = mf
            t60_lf[i] = _shelf("lowshelf", lf0, lfg)
            t60_hf[i] = _shelf("highshelf", hf0, hfg)

        # Scattering coefficients (CalcMatrixCoeffs, reverb.cpp:879-890)
        t = f32(p["diffusion"] * np.arctan(SQRT3))
        mix_x, mix_y = f32(np.cos(t)), f32(np.sin(t) / SQRT3)

        # Master filters
        lp = _shelf("highshelf", hf0, p["gain_hf"])
        hp = _shelf("lowshelf", lf0, p["gain_lf"])

        # 3D panning (update3DPanning, reverb.cpp:1139-1207)
        gain = f32(slot.gain * _reverb_boost())  # [reverb] boost config key
        g_early, g_late = self._pan_gains(
            p["reflections_pan"], p["late_reverb_pan"],
            f32(p["reflections_gain"] * gain), f32(p["late_reverb_gain"] * gain))

        # Old-pipeline fade span (reverb.cpp:1288-1310)
        decay_base = f32(slot.gain * p["gain"] * p["late_reverb_gain"])
        decay_diff = f32(REVERB_DECAY_GAIN / max(decay_base, REVERB_DECAY_GAIN))
        diff_time = (0.0 if not decay_diff < 1.0
                     else float(np.log10(decay_diff) * (20.0 / -60.0)
                                * p["decay_time"]))
        decay_samples = (p["reflections_delay"] + p["late_reverb_delay"]
                         + diff_time) * freq
        fade_samples = int(min(decay_samples, 100000.0))
        if full_update:
            self._fade_blocks = -(-fade_samples // 1024)

        # First update after a device reset: the reference's tap/coeff
        # "previous" values are zero (fresh pipeline), so the first block
        # fades the early feed and late input in from silence.
        cur = {
            "serial": np.int32(self._serial),
            "early_taps0": (prev or {}).get(
                "early_taps1", np.zeros(NUM_LINES, np.int32)),
            "early_taps1": early_taps,
            "early_coeff0": (prev or {}).get("early_coeff1", np.float32(0.0)),
            "early_coeff1": early_coeff,
            "late_taps0": (prev or {}).get(
                "late_taps1", np.zeros(NUM_LINES, np.int32)),
            "late_taps1": late_taps,
            "density_gain": density_gain,
            "e_ap_coeff": e_ap_coeff, "e_ap_off": e_ap_off,
            "e_off": e_off, "e_coeff": e_coeff,
            "l_ap_coeff": l_ap_coeff, "l_ap_off": l_ap_off, "l_off": l_off,
            "t60_mid": t60_mid, "t60_hf": t60_hf, "t60_lf": t60_lf,
            "mod_step": np.uint32(mod_step), "mod_depth": mod_depth,
            "mix_x": mix_x, "mix_y": mix_y,
            "lp": lp, "hp": hp,
            "g_early": g_early, "g_late": g_late,
        }
        self._prev = cur
        # The host's bound on each pipeline's late taps, for the kernel's
        # early-ahead schedule (ops/kernels/reverb.py early_ahead_ok).
        self._late_tap_max = {"": int(max(np.max(cur["late_taps0"]),
                                          np.max(cur["late_taps1"])))}
        if self._old_active:
            self._late_tap_max["old_"] = int(max(
                np.max(self._old_params["late_taps0"]),
                np.max(self._old_params["late_taps1"])))

        out = {k: np.asarray(v) for k, v in cur.items()}
        if self._old_active:
            for k, v in self._old_params.items():
                if k != "serial":
                    out[f"old_{k}"] = np.asarray(v)
            if self._fade_blocks <= 0:
                out["old_g_early"] = np.zeros_like(g_early)
                out["old_g_late"] = np.zeros_like(g_late)
            out["old_pi"], out["old_pf"] = rev_k.pack_params(out, "old_")
        # The kernel's packed layout of each pipeline's parameters.
        out["pi"], out["pf"] = rev_k.pack_params(out)
        return out

    def _pan_gains(self, refl_pan, late_pan, early_gain, late_gain):
        earlymat = _transform_from_vector(refl_pan)
        latemat = _transform_from_vector(late_pan)
        layout = self.device.layout

        def coeffs_for(a2b, mat):
            # Rows in the reference's coefficient space: 16 ACN columns, or
            # the upsampler's 25 above first order (the JAX package sizes
            # them 16 there and raises, ROADMAP C9); compute_pan_gains
            # picks the device's ACNs.
            if self.upmix:
                up = self.first_order_up            # [4, n_up]
                res = np.zeros((NUM_LINES, max(16, up.shape[1])), f32)
                for i in range(4):
                    for j in range(4):
                        res[i, :up.shape[1]] += mat[i][j] * up[j]
            else:
                res = np.zeros((NUM_LINES, 16), f32)
                for i in range(4):
                    for j in range(4):
                        res[i, :4] += a2b[j][i] * mat[j]
            return res

        def pan(rows, gain):
            out = np.zeros((NUM_LINES, self.device.n_dry), f32)
            for i in range(NUM_LINES):
                out[i] = panning.compute_pan_gains(
                    layout.dry_acn, layout.dry_scale, rows[i], gain)
            return out

        return (pan(coeffs_for(EARLY_A2B, earlymat), early_gain),
                pan(coeffs_for(LATE_A2B, latemat), late_gain))

    # -- device half ----------------------------------------------------------

    def _tables(self, device: torch.device) -> dict:
        tabs = getattr(self, "_tabs", None)
        if tabs is None or tabs["b2a"].device != device:
            t = lambda a: torch.tensor(a, dtype=torch.float32, device=device)
            tabs = {"b2a": t(B2A), "ctab": t(_CUBIC_TAB),
                    "a2b_e": t(EARLY_A2B), "a2b_l": t(LATE_A2B),
                    "hfs": t(np.array([self.order_scales[0]]
                                      + [self.order_scales[1]] * 3, f32))
                    if self.upmix else None}
            self._tabs = tabs
        return tabs

    def process(self, state: dict, params: dict, wet: torch.Tensor, T: int):
        """wet [B, T] -> (dry-bus contribution [n_dry, T], None, state);
        the state tensors update in place."""
        tabs = self._tables(wet.device)
        ain = torch.matmul(tabs["b2a"], wet[:NUM_LINES])
        pipes = [("A", "")] + ([("B", "old_")] if self._old_active else [])
        taps, tgt, cur = [], [], []
        for n, (name, prefix) in enumerate(pipes):
            pst = state[name]
            early, late = rev_k.reverb_pipeline(
                ain, state["main"], pst, params[prefix + "pi"],
                params[prefix + "pf"], state["offset"], tabs["ctab"],
                write_main=n == 0, chunk=self.chunk,
                e_passes=self.early_ap_passes, l_passes=self.late_ap_passes,
                mod_win=self.mod_win,
                max_late_tap=self._late_tap_max.get(prefix))
            if self.upmix:
                # One band-split launch each on the card; the CPU takes
                # the chunk-parallel form for speed.
                early, pst["split_early"] = self._upmix_split.hf_scale(
                    torch.matmul(tabs["a2b_e"], early), pst["split_early"],
                    tabs["hfs"])
                late, pst["split_late"] = self._upmix_split.hf_scale(
                    torch.matmul(tabs["a2b_l"], late), pst["split_late"],
                    tabs["hfs"])
            taps += [early, late]
            tgt += [params[prefix + "g_early"], params[prefix + "g_late"]]
            cur += [pst["g_early_cur"], pst["g_late_cur"]]
        state["offset"].copy_((state["offset"] + T) % (1 << 30))

        # mixOut: full-block gain ramps into the dry bus.
        contrib, new_cur = effect_mix(torch.cat(taps), torch.cat(cur),
                                      torch.cat(tgt), T)
        n = NUM_LINES
        for k, (name, _) in enumerate(pipes):
            state[name]["g_early_cur"].copy_(new_cur[2 * k * n:(2 * k + 1) * n])
            state[name]["g_late_cur"].copy_(
                new_cur[(2 * k + 1) * n:(2 * k + 2) * n])
        return contrib, None, state


@register("reverb")
class StdReverbEffect(ReverbEffect):
    """AL_EFFECT_REVERB: the standard-reverb subset of EAXReverb."""
    defaults = dict(DEFAULTS)
