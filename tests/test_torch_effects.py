"""The port's effect engines (openal_soft_tpu_torch/effects) against the JAX
package's, their shared pieces, and the effect_scan kernel's plain version.

Each engine's ``process`` runs on the same numpy state, parameters and wet
input (seeded) as the JAX engine's, one window of 512 samples (two
frequency-shifter hops, four pitch-shifter hops, four convolution
partitions), twice in a row so that the carried state is checked.  The
JAX side runs under jit on XLA:CPU; the port runs its plain versions on
CPU tensors (the biquad kernel's sequential TDF2, effect_scan's
per-sample loops).  The tolerance of each engine is its measured gap
rounded up, within its golden budget (1e-4; 1e-3 for the pitch shifter).
The ring modulator and the chorus are held to the reference's goldens
instead (tests/test_torch_goldens.py): the JAX package fails both
(ROADMAP C11).

    python -m tests.test_torch_effects

prints each engine's measured gap.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import openal_soft_tpu.effects as j_fx
import openal_soft_tpu_torch.effects as t_fx
from openal_soft_tpu.alc.device import LoopbackDevice as JaxLoopback
from openal_soft_tpu.effects.base import DelayRing as JaxRing
from openal_soft_tpu_torch.alc.device import LoopbackDevice as TorchLoopback
from openal_soft_tpu_torch.core import ambidefs
from openal_soft_tpu_torch.effects import base as t_base
from openal_soft_tpu_torch.ops import spec
from openal_soft_tpu_torch.ops.kernels import biquad as t_biq
from openal_soft_tpu_torch.ops.kernels import effect_scan as t_es

T = 512
RATE = 44100
# engine -> (props, output channels, tolerance).
ENGINES = {
    "equalizer": ({"low_gain": 2.0, "low_cutoff": 180.0, "mid1_gain": 0.4,
                   "mid1_center": 700.0, "mid1_width": 0.8,
                   "high_gain": 1.8, "high_cutoff": 5500.0}, "stereo", 1e-5),
    "compressor": ({"onoff": True}, "stereo", 1e-6),
    "compressor_off": ({"onoff": False}, "stereo", 1e-6),
    "distortion": ({"edge": 0.4, "gain": 0.1, "lowpass_cutoff": 6000.0,
                    "eq_center": 2500.0, "eq_bandwidth": 1500.0}, "stereo",
                   1e-5),
    "autowah": ({"attack_time": 0.003, "release_time": 0.015,
                 "resonance": 500.0, "peak_gain": 20.0}, "stereo", 1e-5),
    "vocal_morpher": ({"phoneme_a": 0, "phoneme_b": 4, "phoneme_b_coarse": -5,
                       "waveform": 0, "rate": 3.0}, "stereo", 1e-6),
    "dedicated_dialog": ({"gain": 0.8}, "stereo", 1e-6),
    "dedicated_dialog_51": ({"gain": 0.8}, "surround51", 1e-6),
    "dedicated_lfe_51": ({"gain": 0.7}, "surround51", 1e-6),
    "frequency_shifter": ({"frequency": 250.0, "left_direction": 0,
                           "right_direction": 1}, "stereo", 1e-6),
    "pitch_shifter": ({"coarse_tune": 7, "fine_tune": -30}, "stereo", 1e-5),
    "pitch_shifter_51": ({"coarse_tune": -9, "fine_tune": 15}, "surround51",
                         1e-5),
    "convolution": ({}, "stereo", 1e-5),
}
# Held elsewhere: the echo against its sequential recurrence in float64
# (the JAX engine's process, jitted alone, did not finish compiling on
# XLA:CPU), the chorus and flanger engine and the ring modulator against
# the goldens (ROADMAP C11).
ECHO = {"one pass": {"delay": 0.012, "lr_delay": 0.012, "damping": 0.6,
                     "feedback": 0.55, "spread": -0.8},
        "four passes": {"delay": 0.005, "lr_delay": 0.002, "damping": 0.3,
                        "feedback": 0.7, "spread": 0.4}}


def _engine(case: str) -> str:
    return case.rsplit("_", 1)[0] if case.endswith(("_51", "_off")) else case


def _ir() -> np.ndarray:
    rng = np.random.default_rng(5)
    t = np.arange(700) / RATE
    return (rng.standard_normal((700, 2)) * np.exp(-t * 30.0)[:, None]
            * 0.4).astype(np.float32)


def _slot(cls, engine: str, props: dict, channels: str, **kw):
    dev = cls(frequency=RATE, channels=channels, hrtf=False, capacity=4,
              **kw)
    ctx = dev.create_context()
    slot = ctx.create_aux_slot()
    eff = ctx.create_effect(engine)
    for k, v in props.items():
        eff.set(k, v)
    slot.set_effect(eff)
    if engine == "convolution":
        buf = ctx.create_buffer()
        buf.set_data(_ir(), "stereo", "float32", RATE)
        slot.set_buffer(buf)
    return dev, slot


def _wet(n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    t = np.arange(T) / RATE
    env = 0.5 + 0.5 * np.sin(2 * np.pi * 40.0 * t + seed)
    return (0.3 * rng.standard_normal((n, T)) * env).astype(np.float32)


def run_jax(case: str):
    dev, slot = _slot(JaxLoopback, _engine(case), *ENGINES[case][:2])
    eff = slot.state
    prm = {k: jnp.asarray(v) for k, v in slot.compute_update().items()}
    step = jax.jit(lambda st, p, w: eff.process(st, p, w, T))
    st = dev._state["slot0"]
    outs = []
    for seed in (1, 2):
        out, real, st = step(st, prm, jnp.asarray(_wet(dev.wet_channels,
                                                       seed)))
        outs.append((np.asarray(out),
                     None if real is None else np.asarray(real)))
    return outs


def run_torch(case: str):
    dev, slot = _slot(TorchLoopback, _engine(case), *ENGINES[case][:2],
                      device="cpu")
    prm = {k: torch.tensor(np.asarray(v))
           for k, v in slot.compute_update().items()}
    st = dev._state["slot0"]
    outs = []
    for seed in (1, 2):
        out, real, st2 = slot.state.process(
            st, prm, torch.tensor(_wet(dev.wet_channels, seed)), T)
        assert st2 is st                          # state in place
        outs.append((out.numpy().copy(),
                     None if real is None else real.numpy().copy()))
    return outs


def gap(case: str) -> float:
    """Max abs difference of the two calls' dry (and real) outputs."""
    err = 0.0
    for (go, gr), (wo, wr) in zip(run_torch(case), run_jax(case)):
        assert go.shape == wo.shape
        err = max(err, float(np.abs(go - wo).max()))
        if gr is None:       # JAX writes zeros where the port writes None
            assert wr is None or not np.any(wr)
        else:
            err = max(err, float(np.abs(gr - wr).max()))
    return err


@pytest.mark.parametrize("case", list(ENGINES))
def test_engine_process_matches_jax(case):
    before = (t_biq.biquad_dual.launches, t_es.launches())
    err = gap(case)
    assert (t_biq.biquad_dual.launches, t_es.launches()) == before
    assert err <= ENGINES[case][2], f"{case}: {err:.3e}"


def _mix_f64(taps, cur, tgt):
    """effect_mix in float64: each gain ramps from cur to tgt over the
    block (the ramp's own rounding aside)."""
    ramp = np.arange(taps.shape[1]) / taps.shape[1]
    g = cur[:, :, None] + (tgt - cur)[:, :, None] * ramp
    return np.einsum("kt,kct->ct", taps, g)


@pytest.mark.parametrize("name", list(ECHO))
def test_echo_matches_its_sequential_recurrence(name):
    """The echo's fixed-point passes against echo.cpp's per-sample form
    in float64: D[n] = x[n] + fb * highshelf(D[n - d2]); the taps read
    D[n - d1] and D[n - d2]; over two calls of 512 samples."""
    dev, slot = _slot(TorchLoopback, "echo", ECHO[name], "stereo",
                      device="cpu")
    params = slot.compute_update()
    eff = slot.state
    d1, d2 = eff._d1, eff._d2
    assert eff._n_passes == (4 if name == "four passes" else 1)
    prm = {k: torch.tensor(np.asarray(v)) for k, v in params.items()}
    b0, b1, b2, a1, a2 = params["filter"].astype(np.float64)
    fb = float(params["feed_gain"])
    D = np.zeros(2 * T + d2)
    x = np.concatenate([_wet(dev.wet_channels, s)[0] for s in (1, 2)])
    z1 = z2 = 0.0
    for n in range(2 * T):
        v = D[d2 + n - d2]
        y = v * b0 + z1
        z1, z2 = v * b1 - y * a1 + z2, v * b2 - y * a2
        D[d2 + n] = x[n] + fb * y
    tgt = params["gain_tgt"].astype(np.float64)
    cur = np.zeros_like(tgt)
    for k, seed in enumerate((1, 2)):
        got, real, _ = eff.process(dev._state["slot0"], prm,
                                   torch.tensor(_wet(dev.wet_channels,
                                                     seed)), T)
        n = d2 + k * T + np.arange(T)
        want = _mix_f64(np.stack([D[n - d1], D[n - d2]]), cur, tgt)
        cur = tgt
        assert real is None
        assert np.abs(got.numpy() - want).max() <= 1e-5, k


def test_effect_registry_matches_the_jax_package():
    assert sorted(t_fx.effect_registry) == sorted(j_fx.effect_registry)
    assert not hasattr(t_fx, "UNPORTED")
    for name in t_fx.effect_registry:
        assert t_fx.get_effect_factory(name).name == name


def test_dedicated_engines_write_the_real_output():
    """On surround51 the dialog engine writes FC and the LFE engine the
    LFE channel, and nothing else differs from a null slot; the device
    adds the contribution after the decode, in the multi-block and the
    per-block branch."""
    def render(name):
        dev = TorchLoopback(frequency=48000, channels="surround51",
                            hrtf=False, capacity=4, device="cpu")
        ctx = dev.create_context()
        slot = ctx.create_aux_slot()
        eff = ctx.create_effect(name)
        if name != "null":
            eff.set("gain", 0.8)
        slot.set_effect(eff)
        buf = ctx.create_buffer()
        buf.set_data(_wet(1, 3)[0], "mono", "float32", 48000)
        src = ctx.create_source()
        src.buffer(buf)
        src.looping = True
        src.set("position", (0.5, 0.0, -1.0))
        src.send(slot, 0)
        src.play()
        return dev, np.concatenate([dev.render_samples(2048),
                                    dev.render_samples(1024)])

    dev, base = render("null")
    fc = dev.layout.channel_index[t_fx.dedicated.Channel.FRONT_CENTER]
    lfe = dev.layout.channel_index[t_fx.dedicated.Channel.LFE]
    for name, ch in (("dedicated_dialog", fc), ("dedicated_lfe", lfe)):
        _, got = render(name)
        diff = np.abs(got - base).max(0)
        assert diff[ch] > 1e-3
        assert np.all(np.delete(diff, ch) == 0.0), name


def test_hrtf_fused_branch_with_a_dedicated_slot():
    """HRTF stereo has no FC or LFE: the dialog engine plays on the dry
    bus and the fused super-block branch gets no real-output part."""
    dev = TorchLoopback(frequency=48000, hrtf=True, capacity=4,
                        device="cpu")
    ctx = dev.create_context()
    slot = ctx.create_aux_slot()
    slot.set_effect(ctx.create_effect("dedicated_dialog"))
    buf = ctx.create_buffer()
    buf.set_data(_wet(1, 4)[0], "mono", "float32", 48000)
    src = ctx.create_source()
    src.buffer(buf)
    src.looping = True
    src.send(slot, 0)
    src.play()
    assert dev._fused(dev._graph_gates())
    out = dev.render_samples(2048)
    assert np.isfinite(out).all() and np.abs(out).max() > 1e-3


def test_identity_section_is_exact():
    """biquad_fixed (the section beside an identity section, through the
    biquad kernel's wrapper) equals the one-section sequential TDF2 of
    ops/spec.py bit for bit, up to the sign of zero, over two calls."""
    rng = np.random.default_rng(8)
    x = (rng.standard_normal((3, 2 * 256)) * 0.5).astype(np.float32)
    x[:, 100:140] = 0.0                             # zeros of either sign
    x[1, 101] = -0.0
    for kind, gain in (("lowpass", 1.0), ("highshelf", 0.4),
                       ("peaking", 2.0)):
        cf = spec.biquad_set_params(kind, np.float32(0.07),
                                    np.float32(gain), np.float32(0.8))
        z = torch.zeros((3, 2))
        ys = []
        for half in (x[:, :256], x[:, 256:]):
            y, z = t_base.biquad_fixed(torch.tensor(half), z,
                                       torch.tensor(cf))
            ys.append(y.numpy())
        for line in range(3):
            zs = np.zeros(2, np.float32)
            want = spec.biquad_process(cf, zs, x[line])
            assert np.array_equal(np.concatenate(ys, 1)[line], want), kind
            assert np.array_equal(z[line].numpy(), zs), kind


def test_four_sections_equal_two_calls_of_one():
    """The equalizer's four-section call equals its sections run one
    after another through the sequential TDF2."""
    rng = np.random.default_rng(9)
    x = (rng.standard_normal((4, 256)) * 0.3).astype(np.float32)
    cfs = np.stack([spec.biquad_set_params(k, np.float32(f), np.float32(g),
                                           np.float32(0.9))
                    for k, f, g in (("lowshelf", 0.01, 1.4),
                                    ("peaking", 0.03, 0.6),
                                    ("peaking", 0.1, 1.3),
                                    ("highshelf", 0.2, 0.7))])
    y, z = t_base.biquad_fixed4(torch.tensor(x), torch.zeros((4, 4, 2)),
                                torch.tensor(cfs))
    for line in range(4):
        v = x[line]
        for s in range(4):
            zs = np.zeros(2, np.float32)
            v = spec.biquad_process(cfs[s], zs, v)
            assert np.array_equal(z[line, s].numpy(), zs)
        assert np.array_equal(y[line].numpy(), v)


def _f64_envelopes(amp, x, att, rel, pk, am, rm):
    """The JAX package's recurrences (compressor.py:49-52, autowah.py:
    55-59) in float64."""
    env_c, env_a = 1.0, 0.0
    gains, envs = [], []
    for a, xn in zip(amp.astype(np.float64), x.astype(np.float64)):
        env_c = (min(env_c * am, a) if a > env_c
                 else max(env_c * rm, a) if a < env_c else env_c)
        gains.append(1.0 / env_c)
        s = pk * abs(xn)
        env_a = s + (env_a - s) * (att if s > env_a else rel)
        envs.append(env_a)
    return np.array(gains), np.array(envs)


def test_effect_scan_plain_versions_against_float64():
    rng = np.random.default_rng(10)
    n = 1024
    x = (rng.standard_normal(n) * np.linspace(0.05, 1.5, n)).astype(
        np.float32)
    amp = np.clip(np.abs(x), 0.5, 2.0).astype(np.float32)
    am, rm = np.float32(1.000315), np.float32(0.99984)
    pk, att, rel = np.float32(1.2), np.float32(0.9992), np.float32(0.99985)
    g64, e64 = _f64_envelopes(amp, x, float(att), float(rel), float(pk),
                              float(am), float(rm))
    gains, env = t_es.compressor_env(torch.tensor(amp[None]),
                                     torch.ones(1),
                                     torch.tensor(np.array([am, rm])))
    assert np.abs(gains[0].numpy() - g64).max() <= 1e-5 * np.abs(g64).max()
    envs, env = t_es.autowah_env(torch.tensor(x[None]), torch.zeros(1),
                                 torch.tensor(np.array([pk, att, rel])))
    assert np.abs(envs[0].numpy() - e64).max() <= 1e-5 * np.abs(e64).max()
    assert float(env[0]) == float(envs[0, -1])

    # The swept peaking filter: per-sample coefficients from the
    # envelopes, two lines, state carried across a split.
    w0 = np.minimum(0.05 * envs[0].numpy() + 0.0005, 0.46) * 2 * np.pi
    alpha, c = np.sin(w0) * 0.1, np.cos(w0)
    rg = 1.7
    a0r = 1.0 / (1.0 + alpha / rg)
    cf = np.stack([(1 + alpha * rg) * a0r, -2 * c * a0r,
                   (1 - alpha * rg) * a0r, -2 * c * a0r,
                   (1 - alpha / rg) * a0r]).astype(np.float32)
    xs = np.stack([x, x[::-1]]).astype(np.float32) * 0.2
    y1, z = t_es.swept_tdf2(torch.tensor(xs[:, :300].copy()),
                            torch.tensor(cf[:, :300].copy()),
                            torch.zeros((2, 2)))
    y2, z = t_es.swept_tdf2(torch.tensor(xs[:, 300:].copy()),
                            torch.tensor(cf[:, 300:].copy()), z)
    y = torch.cat([y1, y2], 1).numpy()
    cf64 = cf.astype(np.float64)
    for line in range(2):
        z0 = z1 = 0.0
        want = []
        for t in range(n):
            b0, b1, b2, a1, a2 = cf64[:, t]
            xn = float(xs[line, t])
            yn = xn * b0 + z0
            z0 = xn * b1 - yn * a1 + z1
            z1 = xn * b2 - yn * a2
            want.append(yn)
        # A resonant recurrence: float32 lies ~4e-5 from float64 here,
        # within the autowah's golden budget.
        assert np.abs(y[line] - np.array(want)).max() <= 1e-4
        assert np.allclose(z[line].numpy(), [z0, z1], atol=1e-5)


def test_effect_scan_wrappers_take_the_cpu_to_the_plain_versions():
    amp = torch.rand(3, 64) + 0.5
    prm = torch.tensor([1.0003, 0.9998])
    before = t_es.launches()
    got = t_es.compressor_env(amp, torch.ones(3), prm)
    want = t_es.compressor_env_ref(amp, torch.ones(3), prm)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert t_es.launches() == before
    with pytest.raises(ValueError):
        t_es.swept_tdf2(amp, torch.zeros(5, 63), torch.zeros(3, 2))


@pytest.mark.parametrize("lines,length,T_ring", [(1, 2048, 512),
                                                 (4, 4096, 1024)])
def test_delay_ring_matches_the_jax_package(lines, length, T_ring):
    rng = np.random.default_rng(length)
    t_st = t_base.DelayRing.init(length, lines, "cpu")
    j_st = JaxRing.init(length, lines)
    for step in range(6):
        v = rng.standard_normal((lines, T_ring)).astype(np.float32)
        lag = int(rng.integers(1, length - T_ring))
        np.testing.assert_array_equal(
            t_base.DelayRing.read(t_st, lag, T_ring).numpy(),
            np.asarray(JaxRing.read(j_st, lag, T_ring)))
        t_base.DelayRing.write(t_st, torch.tensor(v), T_ring)
        j_st = JaxRing.write(j_st, jnp.asarray(v), T_ring)
        np.testing.assert_array_equal(
            t_base.DelayRing.read_window(t_st, 300, T_ring).numpy(),
            np.asarray(JaxRing.read_window(j_st, 300, T_ring)))
    assert int(t_st["offset"]) == int(j_st["offset"])


def _pan_rows_f64(eff, refl_pan):
    """C9's reference: the upsampled rows sum_j mat[i][j] * up[j] in
    float64, mapped through the device's dry_acn and dry_scale."""
    from openal_soft_tpu_torch.effects.reverb import _transform_from_vector
    mat = np.asarray(_transform_from_vector(refl_pan), np.float64)
    up = np.asarray(ambidefs.first_order_up(), np.float64)
    lay = eff.device.layout
    rows = mat @ up                                   # [4, 25]
    return lay.dry_scale[None, :] * rows[:, lay.dry_acn]


@pytest.mark.parametrize("channels", ["surround51", "ambi3d"])
def test_reverb_pans_above_first_order(channels):
    """C9: an EAXReverb slot on an order-2 device (surround51's decoder,
    order-2 Ambi3D) builds its pan gains in the upsampler's 25-column
    space and renders; on first-order devices the gains are the
    16-column rows' as before.  The upmix's high band takes the 2D order
    scales on surround51's horizontal decoder and the 3D ones on Ambi3D
    (ReverbState::deviceUpdate passes the device's 2D mixing); the JAX
    package has no reverb above first order to compare with."""
    kw = {"ambi_order": 2} if channels == "ambi3d" else {}
    dev = TorchLoopback(frequency=48000, channels=channels, hrtf=False,
                        capacity=4, device="cpu", **kw)
    assert dev.layout.ambi_order == 2
    assert dev.layout.m2d_mixing == (channels == "surround51")
    ctx = dev.create_context()
    slot = ctx.create_aux_slot()
    eff = ctx.create_effect("eaxreverb")
    eff.set("reflections_pan", (0.3, 0.1, -0.4))
    slot.set_effect(eff)
    # HF2DScales / HFScales, orders 1 and 2 (core/ambidefs.cpp:37-55).
    w_up = 2.236067977 / 1.825741858 if channels == "surround51" \
        else 4.0 / 2.981423970
    np.testing.assert_allclose(slot.state.order_scales[:3], [w_up, 1, 1],
                               rtol=1e-6)
    early, late = slot.state._pan_gains(np.array([0.3, 0.1, -0.4]),
                                        np.zeros(3), 1.0, 1.0)
    want = _pan_rows_f64(slot.state, np.array([0.3, 0.1, -0.4]))
    assert np.abs(early - want).max() <= 1e-6
    assert np.abs(late - _pan_rows_f64(slot.state, np.zeros(3))).max() \
        <= 1e-6
    buf = ctx.create_buffer()
    buf.set_data(_wet(1, 6)[0], "mono", "float32", 48000)
    src = ctx.create_source()
    src.buffer(buf)
    src.looping = True
    src.send(slot, 0)
    src.play()
    out = dev.render_samples(2048)
    assert np.isfinite(out).all() and np.abs(out).max() > 1e-4

    st = TorchLoopback(frequency=48000, channels="stereo", hrtf=False,
                       capacity=4, device="cpu").create_context()
    s2 = st.create_aux_slot()
    s2.set_effect(st.create_effect("eaxreverb"))
    from openal_soft_tpu_torch.core import panning
    from openal_soft_tpu_torch.effects import reverb as t_reverb
    mat = t_reverb._transform_from_vector(np.array([0.3, 0.1, -0.4]))
    rows = np.zeros((4, 16), np.float32)
    for i in range(4):
        for j in range(4):
            rows[i, :4] += t_reverb.EARLY_A2B[j][i] * mat[j]
    lay = s2.state.device.layout
    old = np.stack([panning.compute_pan_gains(lay.dry_acn, lay.dry_scale,
                                              rows[i], 1.0)
                    for i in range(4)])
    got, _ = s2.state._pan_gains(np.array([0.3, 0.1, -0.4]), np.zeros(3),
                                 1.0, 1.0)
    assert np.array_equal(got, old)


if __name__ == "__main__":
    for case in ENGINES:
        print(f"{case}: max gap {gap(case):.3e} "
              f"(tolerance {ENGINES[case][2]:g})")
