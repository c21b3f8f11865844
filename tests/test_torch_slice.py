"""The ported render path end to end, against the JAX package on the CPU.

The scene is bench.py's best_case at small scale (looping one-second tones,
HRTF output, seed 42, positions x3.0), rendered through the public
LoopbackDevice of both packages.  Tolerance 1e-5 max abs, the README's
budget for stereo/HRTF output: the two sides differ only in float32
summation order (matmul blocking) and in XLA:CPU's FMA contraction
(tests/test_torch_resample.py).
"""

import functools
import pathlib

import numpy as np
import pytest
import torch

from openal_soft_tpu.alc.device import LoopbackDevice as JaxLoopback
from openal_soft_tpu_torch.alc.device import LoopbackDevice as _TorchLoopback
from openal_soft_tpu_torch.ops.kernels import resample_unit as t_unit

GOLDEN = pathlib.Path(__file__).parent / "golden"
RATE = 48000
TOL = 1e-5
# The port renders on the card unless asked for the CPU.
TorchLoopback = functools.partial(_TorchLoopback, device="cpu")


def _scene(cls, n_voices: int = 24, n_tones: int = 8, pitched: bool = False):
    dev = cls(frequency=RATE, channels="stereo", sample_type="float32",
              capacity=32, hrtf=True)
    ctx = dev.create_context()
    rng = np.random.default_rng(42)
    t = np.arange(RATE) / RATE
    bufs = []
    for fi in range(n_tones):
        tone = (0.1 * np.sin(2 * np.pi * 110.0 * 2.0 ** (fi / 12.0) * t)
                ).astype(np.float32)
        buf = ctx.create_buffer()
        buf.set_data(tone, "mono", "float32", RATE)
        bufs.append(buf)
    for i in range(n_voices):
        src = ctx.create_source()
        src.buffer(bufs[i % n_tones])
        src.looping = True
        src.set("position", tuple(rng.standard_normal(3) * 3.0))
        if pitched:
            src.set("pitch", float(2.0 ** rng.uniform(-1, 1)))
        src.play()
    return dev


@pytest.mark.parametrize("pitched", [False, True], ids=["unit", "pitched"])
def test_best_case_scene_matches_jax(pitched):
    """8192 frames: one 8-block dispatch (fused super-block path); 4096:
    four single-block dispatches (per-block path); 100/924/1: odd sizes
    through the carry."""
    j = _scene(JaxLoopback, pitched=pitched)
    p = _scene(TorchLoopback, pitched=pitched)
    for n in (8192, 4096, 100, 924, 1):
        want, got = j.render_samples(n), p.render_samples(n)
        assert got.shape == want.shape == (n, 2)
        assert np.isfinite(got).all()
        err = float(np.abs(got - want).max())
        assert err <= TOL, f"{n} frames: max |diff| {err:.3e}"
    assert np.abs(want).max() > 0.0


def test_jax_snapshot_continues_in_the_port():
    """A JAX device's snapshot restored into the port continues the stream:
    the port device first reaches the same host state (same scene, same
    frames rendered), then takes over the JAX carried state."""
    j = _scene(JaxLoopback)
    p = _scene(TorchLoopback)
    j.render_samples(8192)
    p.render_samples(8192)
    snap = j.snapshot()
    p.restore(snap)
    np.testing.assert_array_equal(
        p._state["hrtf_history"].numpy(), snap["state"]["hrtf_history"])
    want, got = j.render_samples(8192), p.render_samples(8192)
    assert np.abs(got - want).max() <= TOL
    # And the port's own snapshot round-trips into the JAX device's layout.
    mine = p.snapshot()
    assert set(mine["state"]) <= set(snap["state"])
    assert set(mine["ev"]) == set(snap["ev"])


def _tone(n, freq, gain=0.4):
    t = np.arange(n) / RATE
    return (gain * np.sin(2 * np.pi * freq * t)).astype(np.float32)


GOLDEN_SCENES = {
    # tests/test_e2e_hrtf.py's scenarios, read-only against their goldens.
    "hrtf_single": [{"data": _tone(24000, 440.0),
                     "props": {"position": (1.0, 0.3, -2.0)}}],
    "hrtf_two_sources": [
        {"data": _tone(24000, 300.0),
         "props": {"position": (-0.5, 1.5, 2.0)}},
        {"data": _tone(20000, 650.0, 0.3),
         "props": {"position": (2.0, -0.5, 0.5), "pitch": 1.21}}],
    "hrtf_resampled": [{"data": _tone(24000, 500.0), "buf_rate": 44100,
                        "props": {"position": (0.0, 0.0, -1.0)}}],
}


@pytest.mark.parametrize("name", sorted(GOLDEN_SCENES))
def test_hrtf_golden_through_the_port(name):
    want = np.load(GOLDEN / f"{name}.npz")["out"]
    dev = TorchLoopback(frequency=RATE, channels="stereo",
                        sample_type="float32", capacity=64, hrtf=True)
    ctx = dev.create_context()
    for s in GOLDEN_SCENES[name]:
        buf = ctx.create_buffer()
        buf.set_data(s["data"], "mono", "float32", s.get("buf_rate", RATE))
        src = ctx.create_source()
        src.buffer(buf)
        src.looping = True
        for k, v in s["props"].items():
            src.set(k, v)
        src.play()
    got = dev.render_samples(4096)
    assert np.abs(got - want).max() <= TOL


def test_cuda_device_without_a_card_raises():
    """The default device is the card: without one, the default raises
    like an explicit "cuda" (and nothing falls back to the CPU)."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: nothing to refuse")
    with pytest.raises(RuntimeError, match="cuda"):
        _TorchLoopback(hrtf=True, capacity=4)
    with pytest.raises(RuntimeError, match="cuda"):
        _TorchLoopback(hrtf=True, capacity=4, device="cuda")


def _one_voice(hrtf: bool):
    dev = TorchLoopback(frequency=RATE, channels="stereo",
                        sample_type="float32", capacity=4, hrtf=hrtf)
    ctx = dev.create_context()
    buf = ctx.create_buffer()
    buf.set_data(_tone(4800, 440.0), "mono", "float32", RATE)
    src = ctx.create_source()
    src.buffer(buf)
    return dev, ctx, src


def test_unported_branches_raise(tmp_path, monkeypatch):
    """Branches that earlier slices left unported now render: UHJ voices
    and UHJ output (A11b, tests/test_torch_uhj.py), a chorus slot (A12,
    tests/test_torch_effects.py), filters and speaker output
    (tests/test_torch_speakers.py)."""
    from openal_soft_tpu_torch.alc import config as t_conf

    dev, ctx, src = _one_voice(hrtf=False)
    buf = ctx.create_buffer()
    buf.set_data(np.stack([_tone(4800, 440.0)] * 2, axis=1), "uhj2",
                 "float32", RATE)
    src.buffer(buf)
    src.play()
    out = dev.render_samples(1024)
    assert np.isfinite(out).all() and np.abs(out).max() > 1e-3

    conf = tmp_path / "alsoft.conf"
    conf.write_text("stereo-encoding = uhj\n")
    monkeypatch.setenv("ALSOFT_CONF", str(conf))
    t_conf.load_config(reload=True)
    try:
        dev, ctx, src = _one_voice(hrtf=False)
    finally:
        monkeypatch.delenv("ALSOFT_CONF")
        t_conf.load_config(reload=True)
    assert dev.layout.uhj_output
    src.play()
    out = dev.render_samples(1024)
    assert np.isfinite(out).all() and np.abs(out).max() > 1e-3

    dev, ctx, src = _one_voice(hrtf=True)
    slot = ctx.create_aux_slot()
    slot.set_effect(ctx.create_effect("chorus"))
    src.looping = True
    src.send(slot, 0)
    src.play()
    out = dev.render_samples(1024)
    assert np.isfinite(out).all() and np.abs(out).max() > 1e-3

    dev, ctx, src = _one_voice(hrtf=False)       # pairwise stereo renders
    flt = ctx.create_filter("lowpass")
    flt.set("gain_hf", 0.3)
    src.direct_filter(flt)
    src.play()
    assert np.isfinite(dev.render_samples(1024)).all()


def test_unit_plan_runs_through_the_wrapper():
    """The native-rate scene takes the unit plan; on the CPU the wrapper
    serves it with the plain version and counts no kernel launch."""
    p = _scene(TorchLoopback)
    assert p._rs_plan(1024, 8) == ("unit", 8)
    assert p._rs_plan(1024, 512) == ("unit", 16)
    before = t_unit.resample_unit.launches
    p.render_samples(2048)
    assert t_unit.resample_unit.launches == before
