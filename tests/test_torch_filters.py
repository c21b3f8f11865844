"""ops/filters.py of the port against the JAX package on the same inputs:
the reverb's chunked biquad, the sequential band splitter with HF scale,
and the chunk-parallel splitter of the HRTF dry bus.  The port keeps the
JAX operand order; XLA:CPU may contract a + b*c into FMA, so the two agree
to 1e-6 max abs, not bit for bit."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from openal_soft_tpu.effects import reverb as j_rev
from openal_soft_tpu.ops import filters as j_f
from openal_soft_tpu_torch.ops import filters as t_f

TOL = 1e-6


NEAR_DC_TOL = 2e-5


def _shelf_coeffs(L: int, seed: int, kind: str = "mixed") -> np.ndarray:
    """[L, 5] shelves as the reverb sets them at 48 kHz, with gains around
    its defaults: high shelves at its 5 kHz HF reference, low shelves at
    its 250 Hz LF reference (poles near DC), or the two alternating."""
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(L):
        low = kind == "lowshelf" or (kind == "mixed" and i % 2)
        kind_i, f0 = (("lowshelf", 250.0 / 48000.0) if low
                      else ("highshelf", 5000.0 / 48000.0))
        rows.append(j_rev._shelf(kind_i, f0, rng.uniform(0.6, 1.1)))
    return np.stack(rows).astype(np.float32)


def _tdf2_f64(x: np.ndarray, z: np.ndarray, rows: np.ndarray):
    """The sample-by-sample TDF2 biquad in float64: (y [L, T], z' [L, 2])."""
    b0, b1, b2, a1, a2 = (rows[:, i].astype(np.float64) for i in range(5))
    z1, z2 = z[:, 0].astype(np.float64), z[:, 1].astype(np.float64)
    y = np.empty(x.shape)
    for t in range(x.shape[1]):
        xt = x[:, t].astype(np.float64)
        y[:, t] = yt = b0 * xt + z1
        z1, z2 = b1 * xt - a1 * yt + z2, b2 * xt - a2 * yt
    return y, np.stack([z1, z2], -1)


def _biquad_both(x, z, rows):
    T = x.shape[1]
    cf = np.broadcast_to(rows, (T // 32,) + rows.shape).copy()
    fn = jax.jit(lambda a, b, c: j_f._biquad_chunked_single(a, b, c, 32))
    wy, wz = fn(jnp.asarray(x), jnp.asarray(z), jnp.asarray(cf))
    gy, gz = t_f._biquad_chunked_single(torch.tensor(x), torch.tensor(z),
                                        torch.tensor(cf), 32)
    return (np.asarray(wy), np.asarray(wz)), (gy.numpy(), gz.numpy())


@pytest.mark.parametrize("T", [128, 256])
def test_biquad_chunked_single_matches_jax(T):
    """The reverb's 5 kHz high shelves at its chunk lengths (it calls the
    biquad per 64..256-sample chunk), from an arbitrary state."""
    rng = np.random.default_rng(T)
    L = 4
    x = (0.25 * rng.standard_normal((L, T))).astype(np.float32)
    z = (rng.standard_normal((L, 2)) * 0.1).astype(np.float32)
    (wy, wz), (gy, gz) = _biquad_both(x, z,
                                      _shelf_coeffs(L, T, "highshelf"))
    assert np.abs(gy - wy).max() <= TOL
    assert np.abs(gz - wz).max() <= TOL


@pytest.mark.parametrize("T", [128, 256])
def test_biquad_chunked_single_near_dc_shelf(T):
    """The reverb's 250 Hz low shelves, from the state a float64 filter
    leaves after 2048 samples.  Their poles sit near z = 1, so A^32 in
    float32 carries ~5e-6 of error in both packages (measured against
    float64 here); a rounding difference, such as XLA:CPU's FMA, then
    shows at that size.  Each package is held to the float64 filter, and
    the two to each other, at NEAR_DC_TOL."""
    rng = np.random.default_rng(T + 1)
    L = 4
    rows = _shelf_coeffs(L, T, "lowshelf")
    pre = (0.25 * rng.standard_normal((L, 2048))).astype(np.float32)
    _, z = _tdf2_f64(pre, np.zeros((L, 2)), rows)
    z = z.astype(np.float32)
    x = (0.25 * rng.standard_normal((L, T))).astype(np.float32)
    (wy, wz), (gy, gz) = _biquad_both(x, z, rows)
    y64, z64 = _tdf2_f64(x, z, rows)
    for y, zz in ((wy, wz), (gy, gz)):
        assert np.abs(y - y64).max() <= NEAR_DC_TOL
        assert np.abs(zz - z64).max() <= NEAR_DC_TOL
    assert np.abs(gy - wy).max() <= NEAR_DC_TOL
    assert np.abs(gz - wz).max() <= NEAR_DC_TOL


def test_biquad_consts_are_reused_exactly():
    """Constants computed once give the values a per-call computation
    gives (the reverb's plain version relies on it)."""
    rng = np.random.default_rng(0)
    x = torch.tensor(rng.standard_normal((4, 256)).astype(np.float32))
    z = torch.zeros(4, 2)
    cf = torch.tensor(_shelf_coeffs(4, 1)).expand(8, 4, 5)
    k = t_f.biquad_consts(cf)
    y1, z1 = t_f.biquad_apply(x, z, k)
    y2, z2 = t_f._biquad_chunked_single(x, z, cf, 32)
    assert torch.equal(y1, y2) and torch.equal(z1, z2)


@pytest.mark.parametrize("variant_3arg", [False, True])
def test_band_split_hf_scale_matches_jax(variant_3arg):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((4, 512)).astype(np.float32)
    st = (rng.standard_normal((4, 3)) * 0.1).astype(np.float32)
    coeff = j_f.band_splitter_coeff(400.0 / 48000.0)
    hfs = np.array([1.0, 0.75, 0.75, 0.75], np.float32)
    fn = jax.jit(lambda a, b: j_f.band_split_hf_scale(
        a, b, jnp.float32(coeff), jnp.asarray(hfs), variant_3arg))
    wy, ws = fn(jnp.asarray(x), jnp.asarray(st))
    gy, gs = t_f.band_split_hf_scale(torch.tensor(x), torch.tensor(st),
                                     coeff, hfs, variant_3arg)
    assert np.abs(gy.numpy() - np.asarray(wy)).max() <= TOL
    assert np.abs(gs.numpy() - np.asarray(ws)).max() <= TOL


def test_band_splitter_kernels_hf_scale_matches_jax():
    rng = np.random.default_rng(4)
    D, T = 9, 1024
    x = rng.standard_normal((D, T)).astype(np.float32)
    st = (rng.standard_normal((D, 3)) * 0.1).astype(np.float32)
    hfs = rng.uniform(0.5, 1.5, D).astype(np.float32)
    coeff = float(j_f.band_splitter_coeff(700.0 / 48000.0))
    j = j_f.BandSplitterKernels(coeff, variant_3arg=True)
    t = t_f.BandSplitterKernels(coeff, variant_3arg=True)
    wy, ws = jax.jit(j.hf_scale)(jnp.asarray(x), jnp.asarray(st),
                                 jnp.asarray(hfs))
    gy, gs = t.hf_scale(torch.tensor(x), torch.tensor(st), torch.tensor(hfs))
    assert np.abs(gy.numpy() - np.asarray(wy)).max() <= TOL
    assert np.abs(gs.numpy() - np.asarray(ws)).max() <= TOL
