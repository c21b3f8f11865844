"""Filtered voices on speaker and Ambi3D output through the port, against
the JAX package on the same scenes.

The scenes at small scale: 8 looping voices on 4 one-second tones (seed
42, positions x3.0), each with a lowpass AL_DIRECT_FILTER (gain_hf ~
U(0.1, 0.9)), as chip_smoke.SPEAKER_SCENES renders them:

* stereo: pairwise panning through the built-in decoder, the voices at
  pitch 2**U(-1,1) and sending to one EAXReverb slot through a lowpass
  send filter (gain_hf 0.5);
* surround51: chip_smoke's dual-band decoder that leaves the center silent,
  with the front stabilizer on;
* ambi3d: order-2 Ambi3D output with near-field compensation.

The second-order outputs carry no slot: the reverb's upmix to buses above
first order fails in both packages (ROADMAP C9).  Tolerance 1e-4: the
reverb carries float32 rounding forward, and XLA:CPU contracts FMA in the
filters.  (Speaker output without filters is held to the C++ goldens at
1e-5 in tests/test_torch_goldens.py.)

The JAX package renders in 128-frame calls, through its per-block path:
slots are present, so its fused path is no reference (ROADMAP C5), and
XLA:CPU takes minutes and gigabytes to compile its 1024-frame filtered
graphs.  The port renders its first 1024 frames in 128-frame calls too
(the effect's output gains ramp across the first block, whose length
must therefore agree), then each segment in one call: 8192 frames take
the multi-block branch (one resample per super-block, 1024-frame blocks),
4096 frames the per-block branch.  After the first block nothing depends
on the block length: the filters step every 32 samples and the gain fades
end within 64.

Each scene ends with a JAX snapshot, taken after every direct filter
changed, continued in the port.  Without a slot the 128-frame call that
precedes it leaves every schedule half way (counter 128 of 256); with the
reverb's 256-frame granularity the schedules complete within the block.
"""

import os

import numpy as np
import pytest

import chip_smoke
from openal_soft_tpu.alc import config as j_conf
from openal_soft_tpu.alc.device import LoopbackDevice as JaxLoopback
from openal_soft_tpu_torch.alc import config as t_conf
from openal_soft_tpu_torch.alc.device import LoopbackDevice as TorchLoopback
from openal_soft_tpu_torch.ops.kernels import biquad as t_biq
# The JAX device renders from private copies of its host table (ROADMAP
# C10: its render could read the table while finish_chunk advanced it).
from tests.test_torch_api import jax_renders_from_private_copies  # noqa: F401

RATE = 48000
SMALL = 128
TOL = 1e-4
SEGMENTS = (("multi-block", 8192), ("per-block", 4096), ("odd", 100),
            ("odd", 924))
SCENES = ("stereo", "surround51", "ambi3d")


def _scene(cls, channels: str, loaded: bool = False, n_voices: int = 8,
           n_tones: int = 4, **dev_kw):
    dev = cls(frequency=RATE, channels=channels, sample_type="float32",
              capacity=n_voices, **dev_kw)
    ctx = dev.create_context()
    if loaded:
        slot = ctx.create_aux_slot()
        slot.set_effect(ctx.create_effect("eaxreverb"))
        send_flt = ctx.create_filter("lowpass")
        send_flt.set("gain_hf", 0.5)
    rng = np.random.default_rng(42)
    t = np.arange(RATE) / RATE
    bufs = []
    for fi in range(n_tones):
        buf = ctx.create_buffer()
        buf.set_data((0.1 * np.sin(2 * np.pi * 110.0 * 2.0 ** (fi / 12.0) * t)
                      ).astype(np.float32), "mono", "float32", RATE)
        bufs.append(buf)
    for i in range(n_voices):
        src = ctx.create_source()
        src.buffer(bufs[i % n_tones])
        src.looping = True
        src.set("position", tuple(rng.standard_normal(3) * 3.0))
        if loaded:
            src.set("pitch", float(2.0 ** rng.uniform(-1, 1)))
            src.send(slot, 0, send_flt)
        chip_smoke.set_direct_lowpass(ctx, src, float(rng.uniform(0.1, 0.9)))
        src.play()
    return dev


def _both(name: str, tmp_path):
    """The scene on both packages, built under its alsoft.conf."""
    kw, conf = chip_smoke.SPEAKER_SCENES[name]
    kw = {k: v for k, v in kw.items() if k != "hrtf"}
    (tmp_path / "nocenter51.ambdec").write_text(chip_smoke.NOCENTER51)
    path = tmp_path / "alsoft.conf"
    path.write_text(conf.format(dir=tmp_path))
    old = os.environ.get("ALSOFT_CONF")
    os.environ["ALSOFT_CONF"] = str(path)
    try:
        j_conf.load_config(reload=True)
        t_conf.load_config(reload=True)
        return _scene(JaxLoopback, **kw), _scene(TorchLoopback, device="cpu",
                                                 **kw)
    finally:
        if old is None:
            del os.environ["ALSOFT_CONF"]
        else:
            os.environ["ALSOFT_CONF"] = old
        j_conf.load_config(reload=True)
        t_conf.load_config(reload=True)


def _small_calls(dev, n: int) -> np.ndarray:
    return np.concatenate([dev.render_samples(min(SMALL, n - i))
                           for i in range(0, n, SMALL)])


@pytest.fixture(scope="module", params=SCENES)
def renders(request, tmp_path_factory):
    """(scene, port device, [(segment, JAX out, port out)], snapshots):
    the first 1024 frames in 128-frame calls on both, then each segment.
    Then every voice's direct filter changes and one 128-frame call leaves
    each schedule half way (counter 128 of 256); the JAX snapshot, filter
    memories and coefficients included, replaces the port's state (whose
    host objects stand at the same point) and continues for 2048 frames
    (the last segment).  ``snapshots`` is (JAX's, the port's after)."""
    name = request.param
    j, p = _both(name, tmp_path_factory.mktemp(name))
    before = t_biq.biquad_dual.launches
    out = [("warm", _small_calls(j, 1024), _small_calls(p, 1024))]
    out += [(seg, _small_calls(j, n), p.render_samples(n))
            for seg, n in SEGMENTS]
    for dev in (j, p):
        chip_smoke.refilter(dev, np.random.default_rng(5))
        dev.render_samples(SMALL)
    snap = j.snapshot()
    # Spoil the port's own filter state: the continuation must come from
    # the snapshot.
    p._state["filter_z"].fill_(1.0)
    p._ev_dev["filter_coeffs"].zero_()
    p._ev_dev["filter_counter"].zero_()
    p.restore(snap)
    out.append(("restored", _small_calls(j, 2048), p.render_samples(2048)))
    assert t_biq.biquad_dual.launches == before    # plain on the CPU
    return name, p, out, (snap, p.snapshot())


@pytest.mark.parametrize("seg", range(len(SEGMENTS) + 2),
                         ids=(["warm"] + [f"{n}-{s}" for s, n in SEGMENTS]
                              + ["restored"]))
def test_filtered_scene_matches_jax(renders, seg):
    name, p, out, _ = renders
    seg_name, want, got = out[seg]
    assert got.shape == want.shape == (want.shape[0], p.n_real)
    assert np.isfinite(got).all()
    err = float(np.abs(got - want).max())
    assert err <= TOL, f"{name} {seg_name}: max |diff| {err:.3e}"
    assert np.abs(want).max() > 1e-3


def test_scene_takes_the_filtered_paths(renders):
    name, p, _, _ = renders
    gates = p._graph_gates()
    assert "gate:nofilt" not in gates
    assert ("gate:nosendfilt" in gates) == (not p.slots)
    assert bool(p.slots) == (name == "stereo")
    assert not p._fused(gates)
    assert p._rs_plan(1024, 8) == ("gen" if p.slots else "unit", 8)
    assert (p._stab is not None) == (name == "surround51")
    assert (p._dec_lf is not None) == (name == "surround51")
    assert (p.nfc is not None) == (name == "ambi3d")
    assert p.n_real == {"stereo": 2, "surround51": 6, "ambi3d": 9}[name]


def test_jax_snapshot_mid_interpolation_restores_in_the_port(renders):
    name, p, _, (snap, mine) = renders
    assert (snap["ev"]["filter_counter"] == (0 if p.slots else 128)).all()
    assert np.abs(snap["state"]["filter_z"]).max() > 0.0
    assert (np.abs(snap["state"]["send_filter_z"]).max() > 0.0) \
        == bool(p.slots)
    assert set(mine["state"]) == set(snap["state"])
    assert {"split_state", "stab_mid", "stab_ap"} <= set(mine["state"]) \
        or name != "surround51"
    assert "nfc_z" in mine["state"] or name != "ambi3d"
    assert (mine["ev"]["filter_counter"] == 0).all()
    np.testing.assert_array_equal(mine["ev"]["filter_coeffs"],
                                  mine["table"]["filter_target"])
