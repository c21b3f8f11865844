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
    got = t_f.biquad_dual_interp(*args)[0].numpy()
    want = _jax(j_f.biquad_dual_interp, args)[0]
    ref = _dual_f64(*(a.numpy() for a in args))
    return (float(np.abs(got - want).max()), float(np.abs(got - ref).max()),
            float(np.abs(want - ref).max()))


@pytest.mark.parametrize("counters", ["0", "256", "mixed"])
@pytest.mark.parametrize("T", [128, 1024])
def test_plain_biquad_matches_jax_scan(T, counters):
    args = _case(T, counters, T + len(counters))
    got = [o.numpy() for o in t_f.biquad_dual_interp(*args)]
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
        y, z, cf, cnt = t_f.biquad_dual_interp(half.contiguous(), z, cf, tgt,
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
    _, _, cf2, cnt2 = t_f.biquad_dual_interp(x, z, cf, tgt, cnt)
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


if __name__ == "__main__":
    for T in (128, 1024):
        for counters in ("0", "256", "mixed"):
            print(f"T={T} counters={counters}: port-JAX %.3e, port-f64 "
                  "%.3e, JAX-f64 %.3e" % _seq_errors(T, counters))
