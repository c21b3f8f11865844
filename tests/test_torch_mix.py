"""ops/mix.py of the port against the JAX package on the same inputs.

Both sides compute the same per-sample gains; the contractions sum over
voices in another order (torch.matmul/einsum vs XLA's dot), so the outputs
agree to float32 rounding: 1e-6 max abs on audio-scale inputs (|x| ~ 0.1,
bus outputs below ~1)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from openal_soft_tpu.ops import mix as j_mix
from openal_soft_tpu_torch.ops import mix as t_mix

TOL = 1e-6
V, C, T, FADE = 48, 4, 256, 64


def _inputs(seed: int):
    rng = np.random.default_rng(seed)
    x = (0.1 * rng.standard_normal((V, T))).astype(np.float32)
    cur = rng.uniform(-1, 1, (V, C)).astype(np.float32)
    tgt = rng.uniform(-1, 1, (V, C)).astype(np.float32)
    tgt[::5] = 0.0                         # silent targets
    tgt[1::7] = cur[1::7]                  # no ramp
    counter = np.where(np.arange(V) % 3 == 0, 0, FADE).astype(np.int32)
    counter[2::9] = 17                     # a fade shorter than F
    group = rng.integers(0, 3, V).astype(np.int32)
    return x, cur, tgt, counter, group


def test_ramp_gains_match_jax():
    x, cur, tgt, counter, _ = _inputs(0)
    want = j_mix.ramp_gains(jnp.asarray(cur), jnp.asarray(tgt),
                            jnp.asarray(counter), FADE)
    got = t_mix.ramp_gains(torch.tensor(cur), torch.tensor(tgt),
                           torch.tensor(counter), FADE)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_mix_voices_matches_jax():
    x, cur, tgt, counter, _ = _inputs(1)
    want, wcur = j_mix.mix_voices(jnp.asarray(x), jnp.asarray(cur),
                                  jnp.asarray(tgt), jnp.asarray(counter),
                                  FADE)
    got, gcur = t_mix.mix_voices(torch.tensor(x), torch.tensor(cur),
                                 torch.tensor(tgt), torch.tensor(counter),
                                 FADE)
    assert got.shape == (C, T)
    assert np.abs(got.numpy() - np.asarray(want)).max() <= TOL
    np.testing.assert_array_equal(gcur.numpy(), np.asarray(wcur))


@pytest.mark.parametrize("n_groups", [2, 4])
def test_mix_voices_grouped_matches_jax(n_groups):
    x, cur, tgt, counter, group = _inputs(2)
    group = group % n_groups
    want, wcur = j_mix.mix_voices_grouped(
        jnp.asarray(x), jnp.asarray(cur), jnp.asarray(tgt),
        jnp.asarray(counter), jnp.asarray(group), n_groups, FADE)
    got, gcur = t_mix.mix_voices_grouped(
        torch.tensor(x), torch.tensor(cur), torch.tensor(tgt),
        torch.tensor(counter), torch.tensor(group), n_groups, FADE)
    assert got.shape == (n_groups, C, T)
    assert np.abs(got.numpy() - np.asarray(want)).max() <= TOL
    np.testing.assert_array_equal(gcur.numpy(), np.asarray(wcur))
