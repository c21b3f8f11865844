"""ops/filters.py of the port against the JAX package on the same inputs:
the reverb's chunked biquad, the sequential band splitter with HF scale,
and the chunk-parallel splitter of the HRTF dry bus.  The port keeps the
JAX operand order; XLA:CPU may contract a + b*c into FMA, so the two agree
to 1e-6 max abs, not bit for bit."""

import hashlib

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


# --- the band splitter's routes (ops/kernels/band_split.py) ------------------

# (mode, variant_3arg), as BandSplitterKernels' callers use them.
SPLIT_MODES = [("split", False), ("hf_scale", False), ("hf_scale", True),
               ("scale", False)]


def _split_case(seed: int, D: int, T: int, v3: bool):
    """x [D, T], a nonzero state, per-row gains and the crossover of the
    HRTF dry bus (the out-of-place variant) or of the speakers."""
    rng = np.random.default_rng(seed)
    x = torch.tensor(rng.standard_normal((D, T)).astype(np.float32))
    st = torch.tensor((rng.standard_normal((D, 3)) * 0.1).astype(np.float32))
    hf = torch.tensor(rng.uniform(0.5, 1.5, D).astype(np.float32))
    lf = torch.tensor(rng.uniform(0.5, 1.5, D).astype(np.float32))
    coeff = float(t_f.band_splitter_coeff((700.0 if v3 else 400.0) / 48000.0))
    return x, st, hf, lf, coeff


def _gains(mode, hf, lf):
    return {"split": (), "hf_scale": (hf,), "scale": (hf, lf)}[mode]


# sha256 (first 16 hex digits) of the CPU route's outputs over two calls
# of _split_case(5, 5, 1024, v3), the second on the time-reversed block
# from the first call's state, as the chunk-parallel BandSplitterKernels
# gave them before CUDA tensors went to the kernel (any thread count).
CPU_ROUTE_SHA256 = {("split", False): "e3a39be7264adaf4",
                    ("hf_scale", False): "d45b2e63afdd4581",
                    ("hf_scale", True): "bc11d535db8b805e",
                    ("scale", False): "6e961c2ce5105125"}


@pytest.mark.parametrize("mode,v3", SPLIT_MODES)
def test_band_splitter_kernels_cpu_route_is_unchanged(mode, v3):
    """On the CPU, BandSplitterKernels keeps the chunk-parallel chain and
    its epilogue: its outputs are bit for bit the pinned ones."""
    x, st, hf, lf, coeff = _split_case(5, 5, 1024, v3)
    k = t_f.BandSplitterKernels(coeff, variant_3arg=v3)
    h = hashlib.sha256()
    for xin in (x, x.flip(1).contiguous()):
        out = getattr(k, mode)(xin, st, *_gains(mode, hf, lf))
        assert len(out) == (3 if mode == "split" else 2)
        for o in out:
            h.update(o.numpy().tobytes())
        st = out[-1]
    assert h.hexdigest()[:16] == CPU_ROUTE_SHA256[(mode, v3)]


@pytest.mark.parametrize("mode", ["split", "scale"])
def test_band_splitter_kernels_split_and_scale_match_jax(mode):
    """The CPU route against the JAX package's BandSplitterKernels, as
    test_band_splitter_kernels_hf_scale_matches_jax for hf_scale."""
    rng = np.random.default_rng(10)
    D, T = 5, 1024
    x = rng.standard_normal((D, T)).astype(np.float32)
    st = (rng.standard_normal((D, 3)) * 0.1).astype(np.float32)
    g = [rng.uniform(0.5, 1.5, D).astype(np.float32)
         for _ in range(mode == "scale" and 2)]
    coeff = float(j_f.band_splitter_coeff(400.0 / 48000.0))
    j = j_f.BandSplitterKernels(coeff)
    t = t_f.BandSplitterKernels(coeff)
    want = jax.jit(getattr(j, mode))(jnp.asarray(x), jnp.asarray(st),
                                     *map(jnp.asarray, g))
    got = getattr(t, mode)(torch.tensor(x), torch.tensor(st),
                           *map(torch.tensor, g))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert np.abs(a.numpy() - np.asarray(b)).max() <= TOL


@pytest.mark.parametrize("mode,v3", SPLIT_MODES)
def test_band_splitter_kernels_cpu_route_near_the_sequential_form(mode, v3):
    """The chunk-parallel form on the CPU lies within 1e-6 of the peak of
    the sample-sequential form the card's kernel equals, outputs and
    state, over two calls carrying the state."""
    from openal_soft_tpu_torch.ops.kernels import band_split as bs_k

    x, st, hf, lf, coeff = _split_case(6, 4, 1024, v3)
    k = t_f.BandSplitterKernels(coeff, variant_3arg=v3)
    g = _gains(mode, hf, lf)
    got_st = want_st = st
    for xin in (x, x.flip(1).contiguous()):
        got = getattr(k, mode)(xin, got_st, *g)
        want = bs_k.band_split_ref(xin, want_st, coeff, mode, *g,
                                   variant_3arg=v3)
        peak = float(want[0].abs().max())
        for a, b in zip(got, want):
            assert float((a - b).abs().max()) <= TOL * peak
        got_st, want_st = got[-1], want[-1]


def test_band_split_scale_matches_jax():
    """The sequential processScale against the JAX package's scan, per-row
    HF and LF gains (the UHJ2 shelf's and the convolution upmix's)."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal((3, 512)).astype(np.float32)
    st = (rng.standard_normal((3, 3)) * 0.1).astype(np.float32)
    coeff = j_f.band_splitter_coeff(400.0 / 48000.0)
    hfs = np.array([1.0, 1.0, 1.0], np.float32)
    lfs = np.array([0.661, 1.293, 1.293], np.float32)
    fn = jax.jit(lambda a, b: j_f.band_split_scale(
        a, b, jnp.float32(coeff), jnp.asarray(hfs), jnp.asarray(lfs)))
    wy, ws = fn(jnp.asarray(x), jnp.asarray(st))
    gy, gs = t_f.band_split_scale(torch.tensor(x), torch.tensor(st), coeff,
                                  hfs, lfs)
    assert np.abs(gy.numpy() - np.asarray(wy)).max() <= TOL
    assert np.abs(gs.numpy() - np.asarray(ws)).max() <= TOL


@pytest.mark.parametrize("mode,v3", SPLIT_MODES)
def test_band_split_wrapper_takes_cpu_tensors_to_the_plain_version(mode, v3):
    from openal_soft_tpu_torch.ops.kernels import band_split as bs_k

    x, st, hf, lf, coeff = _split_case(8, 5, 64, v3)
    g = _gains(mode, hf, lf)
    before = bs_k.band_split.launches
    got = bs_k.band_split(x, st, coeff, mode, *g, variant_3arg=v3)
    want = bs_k.band_split_ref(x, st, coeff, mode, *g, variant_3arg=v3)
    assert bs_k.band_split.launches == before
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def _bad_split_args(case: str):
    x, st, hf, lf, coeff = _split_case(9, 4, 64, False)
    args = {"x": x, "state": st, "coeff": coeff, "mode": "scale", "hf": hf,
            "lf": lf}
    if case == "t_not_multiple_of_32":
        args["x"] = x[:, :48].contiguous()
    elif case == "float64_x":
        args["x"] = x.double()
    elif case == "state_shape":
        args["state"] = st[:, :2].contiguous()
    elif case == "state_device":
        args["state"] = st.to("meta")
    elif case == "gain_rows":
        args["hf"] = hf[:3]
    elif case == "gain_not_tensor":
        args["lf"] = 1.0
    elif case == "mode":
        args["mode"] = "lowpass"
    elif case == "x_not_contiguous":
        args["x"] = torch.cat([x, x], 1)[:, ::2]
    return args


@pytest.mark.parametrize("case", ["t_not_multiple_of_32", "float64_x",
                                  "state_shape", "state_device", "gain_rows",
                                  "gain_not_tensor", "mode",
                                  "x_not_contiguous"])
def test_band_split_wrapper_checks_its_inputs_on_the_cpu(case):
    from openal_soft_tpu_torch.ops.kernels import band_split as bs_k

    with pytest.raises((ValueError, TypeError)):
        bs_k.band_split(**_bad_split_args(case))
