"""The port's EAXReverb (effects/reverb.py) against the JAX package's.

Both devices get one slot with an EAXReverb effect and the same wet input
(numpy, seeded): 8 blocks of 1024, then a parameter change that starts the
A/B crossfade and 4 more blocks, the last two silent (the decaying tail).
The JAX side runs its jnp pipeline under jit (XLA:CPU); the port runs its
plain pipeline (ops/kernels/reverb.py on CPU tensors).  Tolerance 1e-5 max
abs: the two differ in XLA's FMA contraction and dot order, which the
feedback lines carry forward.  The JAX renders are shared through a
module-scoped fixture: the jnp reverb compiles slowly on XLA:CPU."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from openal_soft_tpu.alc.device import LoopbackDevice as JaxLoopback
from openal_soft_tpu_torch.alc.device import LoopbackDevice as TorchLoopback
from openal_soft_tpu_torch.ops.kernels import reverb as t_rev

TOL = 1e-5
T = 1024
N_STEADY, N_FADE = 8, 4
CHANGE = {"decay_time": 2.2, "density": 0.5, "diffusion": 0.8,
          "late_reverb_delay": 0.02}


def _wet(seed: int) -> list[np.ndarray]:
    rng = np.random.default_rng(seed)
    blocks = [(0.1 * rng.standard_normal((4, T))).astype(np.float32)
              for _ in range(N_STEADY + N_FADE)]
    blocks[-2:] = [np.zeros((4, T), np.float32)] * 2
    return blocks


def _slot(cls, **kw):
    dev = cls(frequency=48000, hrtf=True, capacity=4, **kw)
    ctx = dev.create_context()
    slot = ctx.create_aux_slot()
    slot.set_effect(ctx.create_effect("eaxreverb"))
    return dev, slot


def _run(dev, slot, step):
    """Process every wet block, changing the parameters before block
    N_STEADY; returns the contributions and the slot state at the end."""
    outs = []
    params = slot.compute_update()
    for n, wet in enumerate(_wet(0)):
        if n == N_STEADY:
            slot.set_props(**CHANGE)
            params = slot.compute_update()
        outs.append(step(dev, slot, params, wet))
    return outs


_JITTED: dict = {}


def _jax_step(dev, slot, params, wet):
    eff = slot.state
    key = (id(eff), eff._old_active)       # the traced graph depends on it
    if key not in _JITTED:
        _JITTED[key] = jax.jit(
            lambda st, prm, w: eff.process(st, prm, w, T)[::2])
    contrib, st = _JITTED[key](dev._state["slot0"],
                     {k: jnp.asarray(v) for k, v in params.items()},
                     jnp.asarray(wet))
    dev._state["slot0"] = st
    return np.asarray(contrib)


def _torch_step(dev, slot, params, wet):
    prm = {k: torch.tensor(params[k]) for k in slot.state.device_params
           if k in params}
    contrib, extra, st = slot.state.process(dev._state["slot0"], prm,
                                            torch.tensor(wet), T)
    assert extra is None and st is dev._state["slot0"]
    return contrib.numpy().copy()


@pytest.fixture(scope="module")
def jax_run():
    dev, slot = _slot(JaxLoopback)
    outs = _run(dev, slot, _jax_step)
    return outs, jax.tree.map(np.asarray, dev._state["slot0"])


@pytest.fixture(scope="module")
def torch_run():
    dev, slot = _slot(TorchLoopback, device="cpu")
    before = t_rev.reverb_pipeline.launches
    outs = _run(dev, slot, _torch_step)
    assert t_rev.reverb_pipeline.launches == before    # plain on the CPU
    assert slot.state._old_active
    return outs, dev._state["slot0"]


def test_reverb_process_matches_jax_steady(jax_run, torch_run):
    for n in range(N_STEADY):
        got, want = torch_run[0][n], jax_run[0][n]
        assert got.shape == want.shape == (4, T)
        assert np.abs(got - want).max() <= TOL, n
    assert np.abs(jax_run[0][N_STEADY - 1]).max() > 1e-3


def test_reverb_process_matches_jax_through_the_crossfade(jax_run,
                                                           torch_run):
    for n in range(N_STEADY, N_STEADY + N_FADE):
        assert np.abs(torch_run[0][n] - jax_run[0][n]).max() <= TOL, n
    assert np.abs(jax_run[0][-1]).max() > 0.0          # the tail rings on


def test_reverb_state_matches_jax(jax_run, torch_run):
    want, got = jax_run[1], torch_run[1]
    assert int(got["offset"]) == int(want["offset"])
    for name in ("A", "B"):
        for k, v in want[name].items():
            g = got[name][k].numpy()
            if np.issubdtype(v.dtype, np.floating):
                assert np.abs(g - v).max() <= TOL, (name, k)
            else:
                assert int(g) == int(v), (name, k)


# --- the kernel's host half: filter constants and the early-ahead schedule ---


def _effect(rate: int, **props):
    dev = TorchLoopback(frequency=rate, hrtf=True, capacity=4, device="cpu")
    ctx = dev.create_context()
    slot = ctx.create_aux_slot()
    slot.set_effect(ctx.create_effect("eaxreverb"))
    if props:
        slot.set_props(**props)
    return slot.state, slot.compute_update()


@pytest.mark.parametrize("rate", [44100, 48000, 96000])
def test_packed_filter_constants_are_the_plain_versions(rate):
    """pf carries the four filters' balanced-companion constants, computed
    on the host once per update in numpy; they equal, bit for bit, what the
    plain version computes from the same coefficients in torch."""
    from openal_soft_tpu_torch.ops import filters as t_f

    eff, params = _effect(rate, density=0.3, gain_hf=0.5, gain_lf=0.7)
    pf = torch.tensor(params["pf"])
    assert pf.shape == (t_rev.N_PF,)
    kc = pf[t_rev.N_PARAMS:].reshape(4, t_rev.NL, t_rev.N_KC)
    n = eff.chunk // 32
    coeffs = [pf[13:18].expand(n, 4, 5), pf[18:23].expand(n, 4, 5),
              pf[23:43].reshape(4, 5).expand(n, 4, 5),
              pf[43:63].reshape(4, 5).expand(n, 4, 5)]
    for q, cf in enumerate(coeffs):
        k = t_f.biquad_consts(cf)
        want = [k["b0"][0], *(a[0] for a in k["A"]), *(b[0] for b in k["B"]),
                k["delta"][0], *(m[0] for m in k["M"])]
        for i, w in enumerate(want):
            assert torch.equal(kc[q, :, i], w), (q, i)
        assert torch.equal(kc[q, :, 12:44], k["ws"][0][:, 0].T)
        assert torch.equal(kc[q, :, 44:], k["ws"][1][:, 0].T)


@pytest.mark.parametrize("density", [0.0, 1.0])
@pytest.mark.parametrize("delay", [0.0, 0.1])
@pytest.mark.parametrize("rate", [44100, 48000, 96000])
def test_early_ahead_schedule_is_legal_for_the_effects_taps(rate, delay,
                                                            density):
    """The kernel may run chunk k+1's early half beside chunk k's late half
    when late_in holds the largest late tap plus two chunks; the effect's
    late-input line is sized for late_reverb_delay's maximum at density 1,
    so its taps allow it at every rate, also through a crossfade."""
    eff, _ = _effect(rate, density=density, late_reverb_delay=delay)
    taps = eff._late_tap_max[""]
    assert t_rev.early_ahead_ok(eff.len_late_in, taps, eff.chunk)
    assert eff.len_late_in - taps >= 2 * eff.chunk
    # a late tap one sample longer than the bound forces the in-order
    # schedule
    worst = eff.len_late_in - 2 * eff.chunk
    assert t_rev.early_ahead_ok(eff.len_late_in, worst, eff.chunk)
    assert not t_rev.early_ahead_ok(eff.len_late_in, worst + 1, eff.chunk)
    slot_props = {"density": 1.0 - density, "late_reverb_delay": 0.1 - delay}
    eff.device.slots[0].set_props(**slot_props)
    eff.device.slots[0].compute_update()
    assert eff._old_active
    assert t_rev.early_ahead_ok(eff.len_late_in, eff._late_tap_max["old_"],
                                eff.chunk)
    assert t_rev.early_ahead_ok(eff.len_late_in, eff._late_tap_max[""],
                                eff.chunk)
