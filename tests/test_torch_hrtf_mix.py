"""The port's HRTF contractions against the JAX package's (V=32).

Tolerance 1e-6 max abs: both sides sum the same float32 products over the
voices and taps, in a different order (XLA:CPU's dot vs torch's matmul),
on outputs of order 0.1-1.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from openal_soft_tpu.ops import hrtf_mix as j_mix
from openal_soft_tpu_torch.ops import hrtf_mix as t_mix

TOL = 1e-6
V, T = 32, 256
HIST = j_mix.HIST


def _inputs(seed: int, fading: bool):
    rng = np.random.default_rng(seed)
    f32 = np.float32
    delay = rng.integers(0, HIST, (V, 2)).astype(np.int32)
    old_delay = rng.integers(0, HIST, (V, 2)).astype(np.int32)
    coeffs = np.zeros((V, 192, 2), f32)
    old_coeffs = np.zeros((V, 192, 2), f32)
    for v in range(V):
        for e in range(2):
            coeffs[v, delay[v, e]:delay[v, e] + 128, e] = \
                rng.standard_normal(128) * 0.1
            old_coeffs[v, old_delay[v, e]:old_delay[v, e] + 128, e] = \
                rng.standard_normal(128) * 0.1
    gain = rng.uniform(0.0, 1.0, V).astype(f32)
    gain[:2] = 0.0                                  # silent voices
    old_gain = rng.uniform(0.0, 1.0, V).astype(f32)
    fade = np.where(rng.random(V) < 0.5, 64, 0).astype(np.int32) if fading \
        else np.zeros(V, np.int32)
    active = rng.random(V) < 0.9
    hist = (rng.standard_normal((V, HIST)) * 0.3).astype(f32)
    x = (rng.standard_normal((V, T)) * 0.3).astype(f32)
    return dict(hist=hist, x=x, coeffs=coeffs, delay=delay, gain=gain,
                old_coeffs=old_coeffs, old_delay=old_delay,
                old_gain=old_gain, fade=fade, active=active)


def _order(d):
    return (d["coeffs"], d["delay"], d["gain"], d["old_coeffs"],
            d["old_delay"], d["old_gain"], d["fade"], d["active"])


def test_skew_sum_matches_jax():
    P = (np.random.default_rng(0).standard_normal((2, 192, 300)) * 0.05
         ).astype(np.float32)
    want = np.asarray(j_mix.skew_sum(jnp.asarray(P)))
    got = t_mix.skew_sum(torch.tensor(P)).numpy()
    assert got.shape == want.shape == (2, 300 + 191)
    assert np.abs(got - want).max() <= TOL


@pytest.mark.parametrize("fading", [False, True], ids=["steady", "fade"])
def test_hrtf_voices_accum_matches_jax(fading):
    d = _inputs(1, fading)
    x_cat = np.concatenate([d["hist"], d["x"]], axis=1)
    want = np.asarray(j_mix.hrtf_voices_accum(
        jnp.asarray(x_cat), *[jnp.asarray(a) for a in _order(d)], T, 64))
    got = t_mix.hrtf_voices_accum(
        torch.tensor(x_cat), *[torch.tensor(a) for a in _order(d)], T, 64,
        any_fade=fading).numpy()
    assert got.shape == want.shape == (2, HIST + T + 191)
    assert np.abs(got - want).max() <= TOL


@pytest.mark.parametrize("fading", [False, True], ids=["steady", "fade"])
def test_hrtf_voices_accum_split_matches_jax(fading):
    d = _inputs(2, fading)
    want = np.asarray(j_mix.hrtf_voices_accum_split(
        jnp.asarray(d["hist"]), jnp.asarray(d["x"]),
        *[jnp.asarray(a) for a in _order(d)], T, 64))
    got = t_mix.hrtf_voices_accum_split(
        torch.tensor(d["hist"]), torch.tensor(d["x"]),
        *[torch.tensor(a) for a in _order(d)], T, 64,
        any_fade=fading).numpy()
    assert np.abs(got - want).max() <= TOL


def test_direct_hrtf_accum_matches_jax():
    rng = np.random.default_rng(3)
    chans = (rng.standard_normal((4, T)) * 0.3).astype(np.float32)
    c_dir = (rng.standard_normal((4, 192, 2)) * 0.1).astype(np.float32)
    want = np.asarray(j_mix.direct_hrtf_accum(jnp.asarray(chans),
                                              jnp.asarray(c_dir), T))
    got = t_mix.direct_hrtf_accum(torch.tensor(chans), torch.tensor(c_dir),
                                  T).numpy()
    assert np.abs(got - want).max() <= TOL


def test_fold_accum_matches_jax():
    rng = np.random.default_rng(4)
    y_ext = rng.standard_normal((2, HIST + T + 191)).astype(np.float32)
    tail = rng.standard_normal((128, 2)).astype(np.float32)
    jo, jt = j_mix.fold_accum(jnp.asarray(y_ext), jnp.asarray(tail), T)
    to, tt = t_mix.fold_accum(torch.tensor(y_ext), torch.tensor(tail), T)
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
