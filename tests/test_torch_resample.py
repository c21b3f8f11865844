"""The port's resamplers against the JAX package's on the same numpy inputs.

Bit-equality with JAX on the CPU is not reachable: XLA:CPU contracts each
`a + b*c` of the weight and tap arithmetic into a fused multiply-add (one
rounding), while torch rounds the product and the sum separately.  The
measured gap is 4.8e-7 max abs for unit-scale samples (V=32, n=256, every
tier); the bound held here is 2e-6, a few float32 ulps of the tap sums.
Within the port, the unit-increment plain version equals the general
resampler at unit increment bit for bit (the claim the kernel relies on).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from openal_soft_tpu.constants import MIXER_FRAC_ONE, Resampler
from openal_soft_tpu.ops import resample as j_rs
from openal_soft_tpu.ops import tables
from openal_soft_tpu.ops.pallas import resample_unit as j_unit
from openal_soft_tpu_torch.ops import resample as t_rs
from openal_soft_tpu_torch.ops.kernels import resample_gen as t_gen
from openal_soft_tpu_torch.ops.kernels import resample_span as t_span
from openal_soft_tpu_torch.ops.kernels import resample_unit as t_unit
from openal_soft_tpu_torch.ops.kernels import resample_voice as t_voice

FMA_BOUND = 2e-6
V, N = 32, 256
TIERS = [Resampler.POINT, Resampler.LINEAR, Resampler.SPLINE,
         Resampler.GAUSSIAN, Resampler.BSINC12, Resampler.FAST_BSINC24,
         Resampler.BSINC24, Resampler.BSINC48]
BANK = tables.weight_bank()


def _voices(seed: int, resampler: Resampler, unit: bool):
    """V voices over a random pool: loop seams inside the window, wrapped
    (backward) history, non-looping end clamps, pre-start silence and
    empty sources, at mixed pitch up to 10x (or unit increment)."""
    rng = np.random.default_rng(seed)
    P = 40000
    pool = rng.standard_normal(P).astype(np.float32)
    src_len = rng.integers(300, 3000, V).astype(np.int32)
    src_len[:2] = 0
    src_off = rng.integers(8, P - 3000, V).astype(np.int32)
    loop_start = rng.integers(0, 200, V).astype(np.int32)
    loop_end = (loop_start + rng.integers(1, 2500, V)).astype(np.int32)
    has_loop = np.arange(V) % 3 != 0
    has_wrapped = has_loop & (np.arange(V) % 2 == 0)
    pos_int = rng.integers(-200, 2500, V).astype(np.int32)
    pos_int[2:6] = loop_end[2:6] - 40          # seam inside the window
    pos_int[6:8] = loop_start[6:8]             # history wraps backward
    pos_frac = rng.integers(0, MIXER_FRAC_ONE, V).astype(np.int32)
    if unit:
        inc = np.full(V, MIXER_FRAC_ONE, np.int32)
    else:
        inc = rng.integers(MIXER_FRAC_ONE // 4, 10 * MIXER_FRAC_ONE,
                           V).astype(np.int32)
    rows_sf = [tables.prepare_voice_resampler(resampler, int(i), int(f))
               for i, f in zip(inc, pos_frac)]
    bank_row = np.array([r for r, _ in rows_sf], np.int32)
    sf = np.array([s for _, s in rows_sf], np.float32)
    return (pool, src_off, src_len, loop_start, loop_end, has_loop,
            has_wrapped, pos_int, pos_frac, inc, bank_row, sf)


def _jax_resample(args, taps: int, n: int = N) -> np.ndarray:
    """The JAX package's render of the same voices.  Its valid mask
    silences every negative frame, also those of a looping voice that has
    wrapped, where the port reads the loop's last frames: such a voice
    whose window reaches below frame 0 reads the same frames from a
    position whole loops later, where no frame is negative, so the JAX
    package is handed that one.  Every other voice keeps its position, so
    the backward wrap above frame 0 is compared on the same inputs."""
    (pool, src_off, src_len, ls, le, hl, hw, pos_int, *rest) = args
    loop_len = np.maximum(le - ls, 1)
    lift = -(-(taps + 256) // loop_len) * loop_len
    below_0 = hl & hw & (pos_int - taps < 0)
    pos_int = np.where(below_0, pos_int + lift, pos_int).astype(np.int32)
    args = (pool, src_off, src_len, ls, le, hl, hw, pos_int, *rest)
    fn = jax.jit(lambda *a: j_rs.resample_voices(*a, BANK, n, taps))
    return np.asarray(fn(*[jnp.asarray(a) for a in args]))


def _torch_args(args):
    return [torch.tensor(a) for a in args]


def _torch_bank():
    return {k: torch.tensor(v) for k, v in BANK.items()}


@pytest.mark.parametrize("resampler", TIERS, ids=lambda r: r.name)
def test_resample_voices_matches_jax(resampler):
    taps = tables.resampler_max_taps(resampler)
    args = _voices(1, resampler, unit=False)
    want = _jax_resample(args, taps)
    got = t_rs.resample_voices(*_torch_args(args), _torch_bank(), N,
                               taps).numpy()
    assert got.shape == want.shape == (V, N)
    assert np.isfinite(got).all()
    assert np.abs(got - want).max() <= FMA_BOUND


@pytest.mark.parametrize("taps", [4, 24, 48])
def test_unit_ref_equals_general_resampler_bitwise(taps):
    """At increment 1<<16 the unit plain version and the port's general
    resampler do the same f32 operations in the same order."""
    resampler = {4: Resampler.SPLINE, 24: Resampler.BSINC24,
                 48: Resampler.BSINC48}[taps]
    args = _voices(2, resampler, unit=True)
    (pool, src_off, src_len, ls, le, hl, hw, pos_int, pos_frac, inc,
     bank_row, sf) = args
    general = t_rs.resample_voices(*_torch_args(args), _torch_bank(), N,
                                   taps)
    w = t_unit.unit_weights_np(BANK, bank_row, sf, pos_frac, taps)
    t = _torch_args((pool, src_off, src_len, ls, le, hl, hw, pos_int))
    unit = t_unit.resample_unit_ref(*t, torch.tensor(w), N)
    np.testing.assert_array_equal(unit.numpy(), general.numpy())
    # The wrapper takes a CPU tensor to the plain version, not the kernel.
    launches = t_unit.resample_unit.launches
    wrapped = t_unit.resample_unit(*t, torch.tensor(w), N)
    np.testing.assert_array_equal(wrapped.numpy(), unit.numpy())
    assert t_unit.resample_unit.launches == launches


@pytest.mark.parametrize("taps", [4, 24])
def test_unit_ref_matches_jax_at_unit_increment(taps):
    resampler = {4: Resampler.SPLINE, 24: Resampler.BSINC24}[taps]
    args = _voices(3, resampler, unit=True)
    want = _jax_resample(args, taps)
    (pool, src_off, src_len, ls, le, hl, hw, pos_int, pos_frac, _inc,
     bank_row, sf) = args
    w = t_unit.unit_weights_np(BANK, bank_row, sf, pos_frac, taps)
    got = t_unit.resample_unit_ref(
        *_torch_args((pool, src_off, src_len, ls, le, hl, hw, pos_int)),
        torch.tensor(w), N).numpy()
    assert np.abs(got - want).max() <= FMA_BOUND


@pytest.mark.parametrize("taps", [4, 12, 48])
def test_unit_weights_match_reference(taps):
    rng = np.random.default_rng(4)
    bank_row = rng.integers(0, BANK["fil"].shape[0], 64).astype(np.int32)
    sf = rng.random(64).astype(np.float32)
    pos_frac = rng.integers(0, MIXER_FRAC_ONE, 64).astype(np.int32)
    np.testing.assert_array_equal(
        t_unit.unit_weights_np(BANK, bank_row, sf, pos_frac, taps),
        j_unit.unit_weights_np(BANK, bank_row, sf, pos_frac, taps))


def test_positions_and_advance_match_jax():
    rng = np.random.default_rng(5)
    pos_int = rng.integers(-1000, 100000, V).astype(np.int32)
    pos_frac = rng.integers(0, MIXER_FRAC_ONE, V).astype(np.int32)
    inc = rng.integers(1, 10 * MIXER_FRAC_ONE, V).astype(np.int32)
    jp, jf = j_rs.positions(jnp.asarray(pos_frac), jnp.asarray(inc), 1024)
    tp, tf = t_rs.positions(torch.tensor(pos_frac), torch.tensor(inc), 1024)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    ji, jfr = j_rs.advance_positions(jnp.asarray(pos_int),
                                     jnp.asarray(pos_frac), jnp.asarray(inc),
                                     jnp.int32(1024))
    ti, tfr = t_rs.advance_positions(torch.tensor(pos_int),
                                     torch.tensor(pos_frac),
                                     torch.tensor(inc), 1024)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tfr.numpy(), np.asarray(jfr))


def test_resolve_source_index_matches_jax():
    rng = np.random.default_rng(6)
    s = rng.integers(-3000, 6000, (V, 64)).astype(np.int32)
    ls = rng.integers(0, 500, V).astype(np.int32)
    le = (ls + rng.integers(1, 1000, V)).astype(np.int32)
    hl = rng.random(V) < 0.5
    hw = rng.random(V) < 0.5
    ln = rng.integers(0, 2000, V).astype(np.int32)
    ji, jv = j_rs.resolve_source_index(*[jnp.asarray(a) for a in
                                         (s, ls, le, hl, hw, ln)])
    ti, tv = t_rs.resolve_source_index(*[torch.tensor(a) for a in
                                         (s, ls, le, hl, hw, ln)])
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    # A looping voice that has wrapped reads its negative frames from the
    # loop's end, where the JAX package silences them.
    wrapped_below_0 = (hl & hw & (ln > 0))[:, None] & (s < 0)
    assert wrapped_below_0.any()
    np.testing.assert_array_equal(tv.numpy(),
                                  np.asarray(jv) | wrapped_below_0)


@pytest.mark.parametrize("resampler", TIERS, ids=lambda r: r.name)
def test_general_kernel_wrapper_on_the_cpu_matches_jax(resampler):
    """The K3 wrapper takes CPU tensors to its plain version (no launch):
    every tier at mixed pitch up to 10x, against the JAX package."""
    from openal_soft_tpu_torch.ops.kernels import resample_gen as t_gen

    taps = tables.resampler_max_taps(resampler)
    args = _voices(2, resampler, unit=False)
    want = _jax_resample(args, taps)
    before = t_gen.resample_gen.launches
    got = t_gen.resample_gen(*_torch_args(args), _torch_bank(), N,
                             taps).numpy()
    assert t_gen.resample_gen.launches == before
    assert np.abs(got - want).max() <= FMA_BOUND


@pytest.mark.parametrize("taps", [1, 2, 4, 24, 48])
def test_sliced_bank_holds_the_plain_weights(taps):
    """The kernel's bank slice [4, 52, 32, taps] is fil, phd, scd, spd at
    the columns the plain version reads."""
    from openal_soft_tpu_torch.ops.kernels import resample_gen as t_gen

    bank = _torch_bank()
    sl = t_gen.slice_bank(bank, taps)
    lo = 24 - taps // 2
    assert sl.shape == (4, 52, 32, taps) and sl.is_contiguous()
    for i, k in enumerate(("fil", "phd", "scd", "spd")):
        assert torch.equal(sl[i], bank[k][:, :, lo:lo + taps])


def _case(seed: int, V: int, W: int, taps: int, max_inc: int):
    import chip_smoke

    return chip_smoke.gen_case(np.random.default_rng(seed), V, W, taps,
                               max_inc, "cpu")


@pytest.mark.parametrize("taps", [1, 4, 24])
def test_span_and_voice_wrappers_are_the_plain_version_on_the_cpu(taps):
    """K4's and K5's wrappers take CPU tensors to resample_voices (no
    launch), at a UHJ-padded width whose last tile is partial."""
    W = 1152
    args = _case(taps, 16, W, taps, 2 << 16)
    want = t_rs.resample_voices(*args, W, taps)
    before = (t_span.resample_span.launches, t_voice.resample_voice.launches)
    assert torch.equal(t_span.resample_span(*args, W, taps), want)
    assert torch.equal(t_voice.resample_voice(*args, W, taps), want)
    assert (t_span.resample_span.launches,
            t_voice.resample_voice.launches) == before


def test_voice_wrapper_raises_past_its_largest_window():
    """((max_inc * n) >> 16) + 64 above 11264 frames raises, on the CPU
    too (the TPU kernel returned zeros there)."""
    assert t_voice.span_for_increment(10 << 16, 1024) == 11264
    assert t_voice.span_for_increment(1 << 16, 1024) == 2048
    args = _case(0, 4, 16384, 4, 1 << 16)
    with pytest.raises(ValueError, match="largest bucket"):
        t_voice.resample_voice(*args, 16384, 4)
    with pytest.raises(ValueError, match="largest bucket"):
        t_voice.span_for_increment(1 << 16, 11201)


def test_span_window_bound():
    """window_frames bounds every tile's source span: the last tap of the
    tile's last output minus the first tap of its first, plus one."""
    rng = np.random.default_rng(9)
    for _ in range(200):
        inc = int(rng.integers(1, 10 << 16))
        frac = int(rng.integers(0, 1 << 16))
        t0 = int(rng.integers(0, 1 << 20))
        taps = int(rng.choice([1, 2, 4, 24, 48]))
        p0 = (frac + t0 * inc) >> 16
        p1 = (frac + (t0 + t_span.TILE - 1) * inc) >> 16
        assert p1 - p0 + taps <= t_span.window_frames(inc, taps)
    assert t_span.window_frames(10 << 16, 48) * 4 <= 48 * 1024


@pytest.mark.parametrize("resampler", [Resampler.LINEAR, Resampler.BSINC24],
                         ids=lambda r: r.name)
def test_span_kernel_wrapper_on_the_cpu_matches_jax(resampler):
    """K4's wrapper against the JAX package's resample_voices, as K3's."""
    taps = tables.resampler_max_taps(resampler)
    args = _voices(4, resampler, unit=False)
    want = _jax_resample(args, taps)
    got = t_span.resample_span(*_torch_args(args), _torch_bank(), N,
                               taps).numpy()
    assert np.abs(got - want).max() <= FMA_BOUND


def test_positions_are_exact_past_int32():
    """A 16-block window with the UHJ look-ahead at 2x pitch passes 2**31
    in i*increment: positions and the end-of-window advance stay exact
    (the JAX package's int32 form would wrap)."""
    n, inc, frac = 16 * 1024 + 128, np.int32(2 * MIXER_FRAC_ONE - 1), 65535
    pos, fr = t_rs.positions(torch.tensor([frac], dtype=torch.int32),
                             torch.tensor([inc]), n)
    total = frac + np.arange(n, dtype=np.int64) * int(inc)
    assert total[-1] >= 1 << 31
    np.testing.assert_array_equal(pos[0].numpy(), total >> 16)
    np.testing.assert_array_equal(fr[0].numpy(), total & 0xFFFF)
    pi, pf = t_rs.advance_positions(torch.tensor([7], dtype=torch.int32),
                                    torch.tensor([frac], dtype=torch.int32),
                                    torch.tensor([inc]), n)
    end = frac + n * int(inc)
    assert (int(pi[0]), int(pf[0])) == (7 + (end >> 16), end & 0xFFFF)
    assert pi.dtype == pf.dtype == torch.int32


def _staged_frames(pool, off: int, length: int, ls: int, le: int,
                   loop: bool, wrapped: bool, s0: int,
                   span: int) -> tuple[torch.Tensor, int]:
    """What csrc/resample_window.cuh stage_window writes for the frames
    s0 .. s0 + span - 1 of one voice: run A from a = resolve(s0) (up to
    loop_end, or the last frame), then the loop's frames one by one
    (d - n1) mod loop_len or the end clamp, silence staged as 0 (before
    frame 0, unless the voice loops and has wrapped).  Returns
    the window and its pool address g = off + a, whose alignment g & 3 is
    where frame 0 sits in the buffer."""
    P = pool.numel()
    L = max(le - ls, 1)
    last = max(length - 1, 0)
    a = s0
    if loop:
        if s0 >= le or (wrapped and s0 < ls):
            a = (s0 - ls) % L + ls
        n1 = le - a
    else:
        n1 = last - s0 + 1
    n1 = min(max(n1, 0), span)
    d = torch.arange(span)
    tail = ls + (d - n1) % L if loop else torch.full_like(d, last)
    idx = torch.where(d < n1, a + d, tail)
    valid = ((s0 + d >= 0) | (loop and wrapped)) & (length > 0)
    return torch.where(valid, pool[(off + idx).clamp(0, P - 1)], 0.0), off + a


def _staged_window_model(args, n: int, taps: int, cap: int,
                         tile: int) -> torch.Tensor:
    """Plain torch model of what the staged-window kernels (K3, K4,
    csrc/resample_window.cuh) stage and read, block by block: per voice
    the weight tables W0/WD [taps][32]; per tile of ``tile`` outputs,
    windows of equal length, each the most outputs whose frames fit
    ``cap``; per window its bounds (p0 = pos(t), s0 = p0 - center, span),
    run A from resolve(s0) (up to loop_end, or the last frame), then the
    loop's frames one by one (d - n1) mod loop_len or the end clamp,
    silence staged as 0; each output gathers its taps from the window and
    the tables in the plain version's order."""
    (pool, off, lens, ls, le, loop, wrapped, pos_int, frac, inc, row, sf,
     bank) = args
    lo = 24 - taps // 2
    center = taps // 2 - 1
    out = torch.empty((off.shape[0], n), dtype=torch.float32)
    for v in range(off.shape[0]):
        sel = {k: bank[k][int(row[v]), :, lo:lo + taps] for k in bank}
        w0 = (sel["fil"] + sf[v] * sel["scd"]).T.contiguous()    # [taps, 32]
        wd = (sel["phd"] + sf[v] * sel["spd"]).T.contiguous()
        voice = (int(off[v]), int(lens[v]), int(ls[v]), int(le[v]),
                 bool(loop[v]), bool(wrapped[v]))
        f0, dinc = int(frac[v]), int(inc[v])
        for t0 in range(0, n, tile):
            n_tile = min(tile, n - t0)
            fit = ((cap - taps - 1) << 16) // dinc + 1 if dinc > 0 else n_tile
            nwin = -(-n_tile // fit)
            n_w = -(-n_tile // nwin)
            for i in range(nwin):
                t = t0 + i * n_w
                m = min(n_w, n_tile - i * n_w)
                base = (f0 + t * dinc) >> 16
                span = ((f0 + (t + m - 1) * dinc) >> 16) - base + taps
                s0 = int(pos_int[v]) + base - center
                win, g = _staged_frames(pool, *voice, s0, span)
                assert (g & 3) + span <= (cap + 6) & ~3   # the buffer
                total = f0 + torch.arange(t, t + m, dtype=torch.int64) * dinc
                rel = (total >> 16) - base
                fr = total & 0xFFFF
                ph = fr >> 11
                pf = (fr & 2047).to(torch.float32) * (1.0 / 2048)
                acc = torch.zeros(m, dtype=torch.float32)
                for j in range(taps):
                    w = w0[j, ph] + pf * wd[j, ph]
                    acc = acc + w * win[rel + j]
                out[v, t:t + m] = acc
    return out


@pytest.mark.parametrize("kind", ["branches", "short_loops", "zero_start"])
@pytest.mark.parametrize("taps", [1, 4, 48])
def test_staged_window_model_equals_plain_version(kind, taps):
    """What the staged-window kernels stage (window bounds per tile, run
    or frame-by-frame fill, end clamp, weight tables) gives
    resample_voices bit for bit, over chip_smoke's branch cases (loop
    seams, short loops, backward wraps, end clamps, pre-start silence,
    empty sources, buffers at the pool's end) loops of 1-3 frames and loops from frame 0,
    at 0.25x-10x; with the window sized for the largest increment, and
    for a smaller one (more, shorter windows per tile)."""
    import chip_smoke

    make = chip_smoke.CASE_KINDS[kind]
    rng = np.random.default_rng(21 + taps)
    for V, W in ((64, 100), (16, 2048)):
        args = make(rng, V, W, taps, (MIXER_FRAC_ONE // 4,
                                      10 * MIXER_FRAC_ONE), "cpu")
        want = t_rs.resample_voices(*args, W, taps)
        top = int(args[9].max())
        for max_inc, tile in ((top, 1024), (top, -(-W // 256) * 256),
                              (MIXER_FRAC_ONE, 256)):
            cap = t_gen.window_cap(max_inc, taps)
            got = _staged_window_model(args, W, taps, cap, tile)
            assert torch.equal(got, want), (V, W, max_inc, tile)


def test_staged_window_shared_memory_fits():
    """Every (taps, max_inc) the K3 and K4 wrappers accept sizes a block's
    shared memory (weight tables and the window buffer) within a Hopper
    block's limit; windows are sized for MAX_INC at most."""
    for taps in range(1, 49):
        for max_inc in (None, 0, 1, MIXER_FRAC_ONE, 2 * MIXER_FRAC_ONE,
                        10 * MIXER_FRAC_ONE, 10 * MIXER_FRAC_ONE + 1,
                        2**31 - 1):
            cap = t_gen.window_cap(max_inc, taps)
            assert cap >= taps + 1
            assert cap <= t_gen.window_frames(t_gen.MAX_INC, taps)
            assert t_gen.smem_bytes(cap, taps) <= t_gen.SMEM_LIMIT
    assert t_gen.smem_bytes(t_gen.window_cap(None, 48), 48) == 4 * (
        2 * 32 * 48 + 10284)


def _unit_window_model(args, n: int, tile: int, window: int) -> torch.Tensor:
    """Plain torch model of the unit kernel (K1, csrc/resample_unit.cu),
    block by block: per tile of ``tile`` outputs, windows of equal length,
    at most ``window`` outputs each; per window the frames pos_int + t -
    center .. + m + taps - 2 staged as stage_window stages them (the plan
    at increment 1<<16 and phase 0); each output t + k sums w[j] *
    win[k + j] over j = 0..taps-1 from 0.0, the weights (in the kernel's
    registers) constant per voice."""
    pool, off, lens, ls, le, loop, wrapped, pos_int, weights = args
    taps = weights.shape[1]
    center = taps // 2 - 1
    out = torch.empty((off.shape[0], n), dtype=torch.float32)
    for v in range(off.shape[0]):
        voice = (int(off[v]), int(lens[v]), int(ls[v]), int(le[v]),
                 bool(loop[v]), bool(wrapped[v]))
        for t0 in range(0, n, tile):
            n_tile = min(tile, n - t0)
            nwin = -(-n_tile // window)
            n_w = -(-n_tile // nwin)
            for i in range(nwin):
                t = t0 + i * n_w
                m = min(n_w, n_tile - i * n_w)
                win, g = _staged_frames(pool, *voice,
                                        int(pos_int[v]) + t - center,
                                        m + taps - 1)
                # the buffer: WINDOW + taps - 1 frames and 3 of slack
                assert (g & 3) + m + taps - 1 <= (window + taps + 5) & ~3
                acc = torch.zeros(m, dtype=torch.float32)
                for j in range(taps):
                    acc = acc + weights[v, j] * win[j:j + m]
                out[v, t:t + m] = acc
    return out


def _tile_for(W: int) -> int:
    """csrc/resample_window.cuh tile_for: a row's tiles of equal length,
    at most 8192 outputs, in multiples of 256."""
    tiles = -(-W // 8192)
    return -(-(-(-W // tiles)) // 256) * 256


@pytest.mark.parametrize("kind", ["branches", "short_loops", "zero_start"])
@pytest.mark.parametrize("taps", [1, 4, 48])
def test_unit_window_model_equals_plain_versions(kind, taps):
    """What the unit kernel stages and computes (tiles, windows of equal
    length, resolved frames, register weights in the kernel's order)
    gives resample_unit_ref, and resample_voices at unit increment, bit
    for bit: over chip_smoke's branch cases (loop seams, short loops,
    backward wraps, end clamps, pre-start silence, empty sources, buffers
    at the pool's end) loops of 1-3 frames or loops from frame 0, at ragged widths; with the
    kernel's window and tile, and with short ones (several windows and
    tiles per row)."""
    import chip_smoke

    rng = np.random.default_rng(31 + taps)
    for V, W in ((64, 1), (64, 100), (32, 1023), (16, 2048)):
        gen = chip_smoke.CASE_KINDS[kind](rng, V, W, taps,
                                          (MIXER_FRAC_ONE, MIXER_FRAC_ONE),
                                          "cpu")
        args = (*gen[:8], chip_smoke.unit_weights(gen, taps))
        want = t_unit.resample_unit_ref(*args, W)
        assert torch.equal(want, t_rs.resample_voices(*gen, W, taps))
        for tile, window in ((_tile_for(W), t_unit.WINDOW), (256, 100)):
            got = _unit_window_model(args, W, tile, window)
            assert torch.equal(got, want), (V, W, tile, window)


@pytest.mark.parametrize("kind", ["branches", "short_loops", "zero_start"])
@pytest.mark.parametrize("taps", [1, 4, 48])
def test_voice_schedule_model_equals_plain_version(kind, taps):
    """K5's schedule (one tile per row, whatever its length, cut into
    windows that fit the buffer sized for the call's largest increment)
    gives resample_voices bit for bit at ragged widths and 0.25x-10x,
    within the wrapper's largest bucket."""
    import chip_smoke

    make = chip_smoke.CASE_KINDS[kind]
    rng = np.random.default_rng(41 + taps)
    for V, W in ((64, 1), (64, 100), (16, 1023)):
        args = make(rng, V, W, taps, (MIXER_FRAC_ONE // 4,
                                      10 * MIXER_FRAC_ONE), "cpu")
        top = int(args[9].max())
        t_voice.span_for_increment(top, W)          # within the buckets
        want = t_voice.resample_voice(*args, W, taps)
        assert torch.equal(want, t_rs.resample_voices(*args, W, taps))
        cap = t_gen.window_cap(top, taps)
        assert torch.equal(_staged_window_model(args, W, taps, cap, W), want)


def test_unit_and_voice_shared_memory_fits():
    """K1's block (its window buffer, and the weight row for a tap count
    it does not unroll) needs no shared-memory opt-in at any tap count,
    and eight blocks fit an SM's 228 KB (1 KB of each block reserved) for
    the tap counts it runs eight blocks of; K5's largest window (taps 48
    at the largest increment) fits a block, and at its timing shape
    (taps 4, pitch 2**-0.6) eight blocks fit an SM."""
    sm = 228 * 1024
    for taps in range(1, 49):
        assert t_unit.smem_bytes(taps) <= 48 * 1024
        if taps <= 12:
            assert 8 * (t_unit.smem_bytes(taps) + 1024) <= sm
    assert t_unit.smem_bytes(4) == 4 * (4096 + 3 + 5)
    top = t_gen.window_cap(None, 48)
    for n in (1, 1024):
        t_voice.span_for_increment(t_gen.MAX_INC, n)
    assert t_gen.smem_bytes(top, 48) <= t_gen.SMEM_LIMIT
    inc = int(2 ** -0.6 * MIXER_FRAC_ONE)
    assert 8 * (t_gen.smem_bytes(t_gen.window_cap(inc, 4), 4) + 1024) <= sm
