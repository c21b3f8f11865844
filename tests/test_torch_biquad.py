"""The dual biquad's plain version (the biquad kernel's CPU path) against
the JAX package on the same inputs.

The inputs are chip_smoke.biquad_case's: lowpass, highpass and bandpass
filters from the port's host code (near-DC low shelves among them) and
unfiltered rows, counters of 0, 256 and a mixture, carried state, unit-scale
input.  The JAX sequential scan (``biquad_dual_interp``) and the port are
the same TDF2 but not bit for bit: XLA:CPU contracts its products and sums
into FMA, torch rounds each.  Every lowpass row carries a low shelf at unit
gain, whose zeros cancel its poles near DC (radius 0.977 at 48 kHz), and
that pair amplifies float32 rounding: on these inputs each of the two lies
up to ~3e-5 from the same TDF2 in float64, so they are held to 1e-4 of each
other and of float64, not to 1e-5.  Against the JAX package's chunk-parallel
form (``biquad_dual_interp_chunked``, its CPU stand-in for the TPU kernel)
the budget is also 1e-4, that of its own test_filtered_tone, at that test's
signal level (input peaks near 0.5): the chunked form reassociates the
recurrence and drifts further from float64 on the near-DC shelves.  The
coefficient schedule matches to 1e-7 (XLA:CPU may contract the lerp too),
and the host mirror of it exactly.

    python -m tests.test_torch_biquad

prints the largest differences on these inputs.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import chip_smoke
from openal_soft_tpu.ops import filters as j_f
from openal_soft_tpu_torch.ops import filters as t_f
from openal_soft_tpu_torch.ops.kernels import biquad as t_biq

SEQ_TOL = 1e-4
CHUNKED_TOL = 1e-4
V = 24


def _case(T: int, counters: str, seed: int):
    return chip_smoke.biquad_case(np.random.default_rng(seed), V, T,
                                  counters, "cpu")


def _jax(fn, args):
    out = fn(*(jnp.asarray(a.numpy()) for a in args))
    return [np.asarray(o) for o in out]


def _dual_f64(x, z, cf, tgt, cnt) -> np.ndarray:
    """The same dual TDF2 and schedule in float64: y [V, T]."""
    x, z, cf, tgt = (np.asarray(a, np.float64) for a in (x, z, cf, tgt))
    z, cnt = z.copy(), np.asarray(cnt).copy()
    y = np.empty_like(x)
    for s in range(0, x.shape[1], 32):
        for t in range(s, s + 32):
            v = x[:, t]
            for f in (0, 1):
                b0, b1, b2, a1, a2 = cf[:, f].T
                out = v * b0 + z[:, f, 0]
                z[:, f, 0] = v * b1 - out * a1 + z[:, f, 1]
                z[:, f, 1] = v * b2 - out * a2
                v = out
            y[:, t] = v
        cnt2 = np.maximum(cnt - 32, 0)
        lerped = cf + (tgt - cf) / (cnt2 // 32 + 1.0)[:, None, None]
        cf = np.where((cnt > 0)[:, None, None],
                      np.where((cnt2 == 0)[:, None, None], tgt, lerped), cf)
        cnt = cnt2
    return y


def _seq_errors(T: int, counters: str) -> tuple[float, float, float]:
    """(port - JAX scan, port - float64, JAX scan - float64), max abs."""
    args = _case(T, counters, T + len(counters))
    got = t_f.biquad_interp(*args)[0].numpy()
    want = _jax(j_f.biquad_dual_interp, args)[0]
    ref = _dual_f64(*(a.numpy() for a in args))
    return (float(np.abs(got - want).max()), float(np.abs(got - ref).max()),
            float(np.abs(want - ref).max()))


@pytest.mark.parametrize("counters", ["0", "256", "mixed"])
@pytest.mark.parametrize("T", [128, 1024])
def test_plain_biquad_matches_jax_scan(T, counters):
    args = _case(T, counters, T + len(counters))
    got = [o.numpy() for o in t_f.biquad_interp(*args)]
    want = _jax(j_f.biquad_dual_interp, args)
    assert float(np.abs(got[0] - want[0]).max()) <= SEQ_TOL
    assert float(np.abs(got[1] - want[1]).max()) <= SEQ_TOL
    assert float(np.abs(got[0] - _dual_f64(*(a.numpy() for a in args))
                        ).max()) <= SEQ_TOL
    np.testing.assert_allclose(got[2], want[2], rtol=0, atol=1e-7)
    np.testing.assert_array_equal(got[3], want[3])
    if counters != "0":
        # T=128 leaves the 256-sample schedules half way.
        assert (got[3] > 0).any() == (T < 256)
    assert np.abs(got[0]).max() > 0.1


def test_plain_biquad_matches_jax_chunked_form_over_two_calls():
    x, z, cf, tgt, cnt = _case(256, "mixed", 7)
    x, z = x * 0.2, z * 0.2
    jz, jcf, jcnt = (jnp.asarray(a.numpy()) for a in (z, cf, cnt))
    for half in (x[:, :128], x[:, 128:]):
        y, z, cf, cnt = t_f.biquad_interp(half.contiguous(), z, cf, tgt,
                                               cnt)
        jy, jz, jcf, jcnt = jax.jit(j_f.biquad_dual_interp_chunked)(
            jnp.asarray(half.numpy()), jz, jcf, jnp.asarray(tgt.numpy()),
            jcnt)
        assert float(np.abs(y.numpy() - np.asarray(jy)).max()) <= CHUNKED_TOL
    assert float(np.abs(z.numpy() - np.asarray(jz)).max()) <= CHUNKED_TOL
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(jcnt))


def test_host_mirror_follows_the_schedule():
    """The host's interpolation mirror (filters.host_advance_interp) lands
    where the device's schedule does, so a re-upload continues it."""
    x, z, cf, tgt, cnt = _case(128, "mixed", 3)
    _, _, cf2, cnt2 = t_f.biquad_interp(x, z, cf, tgt, cnt)
    hcf, hcnt = t_f.host_advance_interp(cf.numpy(), tgt.numpy(), cnt.numpy(),
                                        128)
    np.testing.assert_array_equal(hcf, cf2.numpy())
    np.testing.assert_array_equal(hcnt, cnt2.numpy())


def test_wrapper_on_cpu_tensors_is_the_plain_version():
    args = _case(128, "mixed", 11)
    before = t_biq.biquad_dual.launches
    got = t_biq.biquad_dual(*args)
    want = t_biq.biquad_dual_ref(*args)
    assert t_biq.biquad_dual.launches == before
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("bad", ["x_f64", "cnt_i64", "T_odd", "z_shape",
                                 "x_strided", "x_unaligned"])
def test_wrapper_rejects_bad_inputs(bad):
    x, z, cf, tgt, cnt = _case(128, "0", 5)
    if bad == "x_f64":
        x = x.double()
    elif bad == "cnt_i64":
        cnt = cnt.long()
    elif bad == "T_odd":
        x = x[:, :100].contiguous()
    elif bad == "z_shape":
        z = z[:, 0]
    elif bad == "x_strided":
        x = torch.cat([x, x], 1)[:, ::2]
    else:                                    # contiguous, one float in
        x = torch.cat([x.new_zeros(1), x.reshape(-1)])[1:].view(x.shape)
    with pytest.raises((TypeError, ValueError)):
        t_biq.biquad_dual(x, z, cf, tgt, cnt)


# --- the multi-path, masked and four-section forms (biquad_paths, S = 4) ---


def _send_paths(V: int, T: int, P: int, seed: int):
    """x and P filter paths laid out as the device holds its aux sends:
    state [V, P, ...] with each path a strided view; masks mixed, path 1
    without one (all active)."""
    rng = np.random.default_rng(seed)
    x = chip_smoke.biquad_case(rng, V, T, "mixed", "cpu")[0]
    parts = [chip_smoke.biquad_case(rng, V, T, "mixed", "cpu")[1:]
             for _ in range(P)]
    z, cf, tgt, cnt = (torch.stack([p[i] for p in parts], 1)
                       for i in range(4))
    fa = torch.tensor(rng.random((V, P)) < 0.7)
    return x, (z, cf, tgt, cnt, fa)


def _as_paths(st):
    z, cf, tgt, cnt, fa = st
    return [t_biq.FilterPath(z[:, p], cf[:, p], tgt[:, p], cnt[:, p],
                             None if p == 1 else fa[:, p])
            for p in range(z.shape[1])]


def _clone(st):
    return tuple(t.clone() for t in st)


@pytest.mark.parametrize("counters", ["0", "mixed"])
def test_four_sections_are_two_dual_biquads_in_a_row(counters):
    rng = np.random.default_rng(9)
    lo = chip_smoke.biquad_case(rng, V, 256, counters, "cpu")
    hi = chip_smoke.biquad_case(rng, V, 256, counters, "cpu")
    x, cnt = lo[0], lo[4]
    z, cf, tgt = (torch.cat([lo[i], hi[i]], 1) for i in (1, 2, 3))
    y4, z4, cf4, cnt4 = t_biq.biquad_dual(x, z, cf, tgt, cnt)
    y, za, cfa, cnta = t_f.biquad_interp(x, lo[1], lo[2], lo[3], cnt)
    y, zb, cfb, cntb = t_f.biquad_interp(y, hi[1], hi[2], hi[3], cnt)
    assert torch.equal(y4, y)
    assert torch.equal(z4, torch.cat([za, zb], 1))
    assert torch.equal(cf4, torch.cat([cfa, cfb], 1))
    assert torch.equal(cnt4, cnta) and torch.equal(cnta, cntb)


@pytest.mark.parametrize("P", [1, 2, 3])
def test_paths_are_the_per_path_calls_and_selects(P):
    """One biquad_paths call (the plain version on the CPU) over two blocks
    equals, path by path, the dual biquad and the selects it replaces in
    the device (the filtered line where active, x elsewhere; state cleared,
    coefficients on target, counter 0 where inactive)."""
    x, st = _send_paths(V, 128, P, P)
    want = _clone(st)
    got = _clone(st)
    before = t_biq.biquad_dual.launches
    for xin in (x, x.flip(1).contiguous()):
        y = t_biq.biquad_paths(xin, _as_paths(got))
        assert y.shape == (P, V, 128)
        for p, path in enumerate(_as_paths(want)):
            y2, z2, cf2, cnt2 = t_f.biquad_interp(
                xin, path.z.contiguous(), path.coeffs.contiguous(),
                path.target.contiguous(), path.counter.contiguous())
            fa = (torch.ones(V, dtype=torch.bool) if path.active is None
                  else path.active)
            path.z.copy_(torch.where(fa[:, None, None], z2, 0.0))
            path.coeffs.copy_(torch.where(fa[:, None, None], cf2,
                                          path.target))
            path.counter.copy_(torch.where(fa, cnt2, 0))
            assert torch.equal(y[p], torch.where(fa[:, None], y2, xin))
        for a, b in zip(got, want):
            assert torch.equal(a, b)
    assert t_biq.biquad_dual.launches == before          # plain on the CPU
    assert not st[4].all() and st[4].any()


def test_paths_and_four_sections_match_jax():
    """The multi-path and four-section forms against the JAX package's
    biquad (its sequential scan) on the same inputs, at SEQ_TOL."""
    x, st = _send_paths(V, 256, 2, 21)
    paths = _as_paths(_clone(st))
    y = t_biq.biquad_paths(x, paths)
    for p in range(2):
        args = (x, st[0][:, p].contiguous(), st[1][:, p].contiguous(),
                st[2][:, p].contiguous(), st[3][:, p].contiguous())
        jy, jz, _, _ = _jax(j_f.biquad_dual_interp, args)
        fa = st[4][:, p].numpy()[:, None] if p != 1 else True
        assert float(np.abs(y[p].numpy() - np.where(fa, jy, x.numpy()))
                     .max()) <= SEQ_TOL
        jz = np.where(np.reshape(fa, (-1, 1, 1)), jz, 0.0)
        assert float(np.abs(paths[p].z.numpy() - jz).max()) <= SEQ_TOL
    rng = np.random.default_rng(22)
    lo = chip_smoke.biquad_case(rng, V, 256, "mixed", "cpu")
    hi = chip_smoke.biquad_case(rng, V, 256, "mixed", "cpu")
    z, cf, tgt = (torch.cat([lo[i], hi[i]], 1) for i in (1, 2, 3))
    y4 = t_biq.biquad_dual(lo[0], z, cf, tgt, lo[4])[0].numpy()
    jy = _jax(j_f.biquad_dual_interp, lo)[0]
    jy = _jax(j_f.biquad_dual_interp, (torch.tensor(jy), *hi[1:4], lo[4]))[0]
    assert float(np.abs(y4 - jy).max()) <= SEQ_TOL
    assert np.abs(y4).max() > 0.1


@pytest.mark.parametrize("bad", ["sections_3", "no_paths", "nine_paths",
                                 "V_mismatch", "inner_strided",
                                 "lines_overlap", "active_int", "z_f64",
                                 "x_unaligned", "mixed_sections"])
def test_paths_wrapper_rejects_bad_inputs(bad):
    x, st = _send_paths(8, 64, 2, 3)
    paths = _as_paths(st)
    p0 = paths[0]
    if bad == "sections_3":
        paths[0] = p0._replace(z=torch.zeros(8, 3, 2),
                               coeffs=torch.zeros(8, 3, 5),
                               target=torch.zeros(8, 3, 5))
    elif bad == "no_paths":
        paths = []
    elif bad == "nine_paths":
        paths = [p0] * 9
    elif bad == "V_mismatch":
        paths[0] = p0._replace(counter=p0.counter[:7])
    elif bad == "inner_strided":
        paths[0] = p0._replace(coeffs=p0.coeffs.transpose(1, 2)
                               .contiguous().transpose(1, 2))
    elif bad == "lines_overlap":
        paths[0] = p0._replace(z=p0.z[:1].expand(8, 2, 2))
    elif bad == "active_int":
        paths[0] = p0._replace(active=p0.active.int())
    elif bad == "z_f64":
        paths[0] = p0._replace(z=p0.z.double())
    elif bad == "x_unaligned":
        x = torch.cat([x.new_zeros(1), x.reshape(-1)])[1:].view(x.shape)
    else:                                    # 2 and 4 sections in one call
        paths[1] = paths[1]._replace(z=torch.zeros(8, 4, 2),
                                     coeffs=torch.zeros(8, 4, 5),
                                     target=torch.zeros(8, 4, 5))
    with pytest.raises((TypeError, ValueError)):
        t_biq.biquad_paths(x, paths)


if __name__ == "__main__":
    for T in (128, 1024):
        for counters in ("0", "256", "mixed"):
            print(f"T={T} counters={counters}: port-JAX %.3e, port-f64 "
                  "%.3e, JAX-f64 %.3e" % _seq_errors(T, counters))
