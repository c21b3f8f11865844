"""bench.py's loaded scene through the port, against the JAX package.

The scene at small scale: 16 looping HRTF voices on 8 one-second tones at
pitch 2**U(-1,1) (seed 42, positions x3.0), each sending to one EAXReverb
slot.  Tolerance 1e-4 max abs (ROADMAP A8): the reverb's feedback carries
float32 rounding differences forward.

The JAX package is compared through its per-block path only.  Its fused
super-block path runs the jnp reverb's early chunks of a whole window
before any late chunk, so at windows of 8192 and more the late-input taps
read slots that the same window has already overwritten (ROADMAP C5).  The
port's fused path runs each chunk's early and late halves in order, so it
agrees with the JAX per-block path once the first block has settled the
effect's output gains (the fused path ramps them across its whole window,
the per-block path across one block, in both packages).

Also here: a JAX snapshot of the scene, slot state included, continued in
the port, and the hrtf_ambi2/hrtf_ambi3 goldens (the dry ambisonic bus),
read only (ROADMAP C3).
"""

import pathlib

import numpy as np
import pytest

from openal_soft_tpu.alc.device import LoopbackDevice as JaxLoopback
from openal_soft_tpu_torch.alc import config as t_conf
from openal_soft_tpu_torch.alc.device import LoopbackDevice as TorchLoopback
from openal_soft_tpu_torch.ops.kernels import resample_gen as t_gen
from openal_soft_tpu_torch.ops.kernels import reverb as t_rev
# The JAX device renders from private copies of its host table (ROADMAP
# C10: its render could read the table while finish_chunk advanced it).
from tests.test_torch_api import jax_renders_from_private_copies  # noqa: F401

GOLDEN = pathlib.Path(__file__).parent / "golden"
RATE = 48000
TOL = 1e-4
GOLDEN_TOL = 1e-5
BLOCK = 1024
# (name, frames): the port renders each in one call; JAX in 1024-frame
# calls (the odd sizes in one call each, through its per-block path).
SEGMENTS = (("warm", 1024), ("fused", 8192), ("per-block", 4096),
            ("odd", 100), ("odd", 924))


def _scene(cls, n_voices: int = 16, n_tones: int = 8, **kw):
    dev = cls(frequency=RATE, channels="stereo", sample_type="float32",
              capacity=n_voices, hrtf=True, **kw)
    ctx = dev.create_context()
    slot = ctx.create_aux_slot()
    slot.set_effect(ctx.create_effect("eaxreverb"))
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
        src.set("pitch", float(2.0 ** rng.uniform(-1, 1)))
        src.send(slot, 0)
        src.play()
    return dev


def _jax_render(dev, n: int) -> np.ndarray:
    if n % BLOCK:
        return dev.render_samples(n)
    return np.concatenate([dev.render_samples(BLOCK)
                           for _ in range(n // BLOCK)])


@pytest.fixture(scope="module")
def renders():
    j = _scene(JaxLoopback)
    p = _scene(TorchLoopback, device="cpu")
    before = (t_gen.resample_gen.launches, t_rev.reverb_pipeline.launches)
    out = [(name, _jax_render(j, n), p.render_samples(n))
           for name, n in SEGMENTS]
    assert (t_gen.resample_gen.launches,
            t_rev.reverb_pipeline.launches) == before   # plain on the CPU
    assert p._rs_plan(BLOCK, 8) == ("gen", 8)
    return out


@pytest.mark.parametrize("seg", range(len(SEGMENTS)),
                         ids=[f"{n}-{f}" for n, f in SEGMENTS])
def test_loaded_scene_matches_jax(renders, seg):
    name, want, got = renders[seg]
    assert got.shape == want.shape == (SEGMENTS[seg][1], 2)
    assert np.isfinite(got).all()
    err = float(np.abs(got - want).max())
    assert err <= TOL, f"{name}: max |diff| {err:.3e}"
    assert np.abs(want).max() > 1e-3


def test_jax_snapshot_of_the_loaded_scene_continues_in_the_port():
    j = _scene(JaxLoopback, n_voices=8)
    p = _scene(TorchLoopback, n_voices=8, device="cpu")
    _jax_render(j, 2048)
    _jax_render(p, 2048)
    snap = j.snapshot()
    p.restore(snap)
    np.testing.assert_array_equal(
        p._state["slot0"]["A"]["late_dl"].numpy(),
        snap["state"]["slot0"]["A"]["late_dl"])
    assert int(p._state["slot0"]["offset"]) == int(
        snap["state"]["slot0"]["offset"])
    want, got = _jax_render(j, 4096), p.render_samples(4096)
    assert np.abs(got - want).max() <= TOL
    mine = p.snapshot()
    assert set(mine["state"]) == set(snap["state"])
    assert set(mine["state"]["slot0"]["A"]) == set(snap["state"]["slot0"]["A"])
    assert mine["state"]["slot0"]["A"]["mod_index"].dtype == np.uint32


@pytest.mark.parametrize("mode", ["ambi2", "ambi3"])
def test_hrtf_ambi_golden_through_the_port(mode, tmp_path, monkeypatch):
    """tests/test_e2e_hrtf_modes.py's scene (hrtf-mode = ambiN: voices pan
    onto the dry ambisonic bus, decoded through baked HRIRs)."""
    want = np.load(GOLDEN / f"hrtf_{mode}.npz")["out"]
    conf = tmp_path / "alsoft.conf"
    conf.write_text(f"hrtf-mode = {mode}\n")
    monkeypatch.setenv("ALSOFT_CONF", str(conf))
    t_conf.load_config(reload=True)
    try:
        dev = TorchLoopback(frequency=RATE, channels="stereo",
                            sample_type="float32", capacity=16, hrtf=True,
                            device="cpu")
        assert not dev.layout.hrtf_full
        assert dev.layout.ambi_order == int(mode[-1])
        ctx = dev.create_context()
        t = np.arange(RATE // 2) / RATE
        for freq, gain, pos in ((441.0, 0.4, (1.0, 0.5, -2.0)),
                                (333.0, 0.3, (-2.0, -0.3, -0.5))):
            buf = ctx.create_buffer()
            buf.set_data((gain * np.sin(2 * np.pi * freq * t)
                          ).astype(np.float32), "mono", "float32", RATE)
            src = ctx.create_source()
            src.buffer(buf)
            src.looping = True
            src.set("position", pos)
            src.play()
        got = dev.render_samples(4096)
    finally:
        monkeypatch.delenv("ALSOFT_CONF")
        t_conf.load_config(reload=True)
    assert np.abs(got - want).max() <= GOLDEN_TOL
