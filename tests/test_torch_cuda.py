"""Port tests that need the card (marker ``cuda``); they skip without one.

Run them on a machine with an NVIDIA GPU, from the repository root:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py -q

(``--noconftest``: tests/conftest.py configures JAX, which a machine set
up for the port need not have.)
"""

import numpy as np
import pytest
import torch

import chip_smoke
from openal_soft_tpu_torch.ops.kernels import biquad as t_biq
from openal_soft_tpu_torch.ops.kernels import effect_scan as t_es
from openal_soft_tpu_torch.ops.kernels import resample_gen as t_gen
from openal_soft_tpu_torch.ops.kernels import resample_span as t_span
from openal_soft_tpu_torch.ops.kernels import resample_unit as t_unit
from openal_soft_tpu_torch.ops.kernels import resample_voice as t_voice
from openal_soft_tpu_torch.ops.kernels import reverb as t_rev

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernel has no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.parametrize(
    "W,taps,kind",
    [(W, taps, "unit_case") for taps in (4, 24, 48) for W in (128, 1024, 16384)]
    + list(chip_smoke.UNIT_CASES))
def test_unit_kernel_equals_plain_version(cuda, W, taps, kind):
    """K1 on unit_case's branch cases (random weights), then at ragged
    widths with buffers at the pool's end and over loops of 1-3 frames
    (the bank's weights)."""
    rng = np.random.default_rng(taps * W)
    if kind == "unit_case":
        args = chip_smoke.unit_case(rng, 256, W, taps, cuda)
    else:
        args = chip_smoke.unit_window_case(rng, 256, W, taps, kind, cuda)
    before = t_unit.resample_unit.launches
    got = t_unit.resample_unit(*args, W)
    torch.cuda.synchronize()
    assert t_unit.resample_unit.launches == before + 1
    assert torch.equal(got, t_unit.resample_unit_ref(*args, W))


@pytest.mark.parametrize("W", [1023, 16385])
def test_unit_kernel_equals_general_kernel_at_unit_increment(cuda, W):
    """K1 and K3 compute the same function at increment 1<<16 with the
    unit weights: their outputs are equal bit for bit."""
    gen = chip_smoke.span_case(np.random.default_rng(W), 256, W, 4,
                               (ONE, ONE), cuda)
    unit = t_unit.resample_unit(*gen[:8], chip_smoke.unit_weights(gen, 4), W)
    assert torch.equal(unit, t_gen.resample_gen(*gen, W, 4))


def test_wrapper_rejects_bad_inputs(cuda):
    args = list(chip_smoke.unit_case(np.random.default_rng(0), 8, 128, 4,
                                     cuda))
    args[-1] = args[-1].double()                   # weights must be f32
    with pytest.raises(TypeError):
        t_unit.resample_unit(*args, 128)


def test_port_on_the_card_matches_the_cpu(cuda):
    g = chip_smoke.bench_scene(64, 64, "cuda")
    c = chip_smoke.bench_scene(64, 64, "cpu")
    before = t_unit.resample_unit.launches
    for n in (8192, 4096, 100):
        assert np.abs(g.render_samples(n) - c.render_samples(n)).max() \
            <= chip_smoke.PARITY_TOL
    assert t_unit.resample_unit.launches > before


ONE = 1 << 16
# chip_smoke.WINDOW_CASES as (W, taps, increments, kind): ragged widths,
# taps 48 at 10x, loops of 1-3 frames.
WINDOW_CASES = [c[1:] for c in chip_smoke.WINDOW_CASES]


def _window_case(W, taps, incs, kind, cuda):
    make = (chip_smoke.short_loop_case if kind == "short_loops"
            else chip_smoke.span_case)
    return make(np.random.default_rng(taps + W), 256, W, taps, incs, cuda)


@pytest.mark.parametrize(
    "W,taps,incs,kind",
    [(W, taps, None, "gen_case") for W in (128, 16384)
     for taps in (1, 2, 4, 24, 48)] + WINDOW_CASES)
def test_general_kernel_equals_plain_version(cuda, W, taps, incs, kind):
    if kind == "gen_case":
        args = chip_smoke.gen_case(np.random.default_rng(taps + W), 256, W,
                                   taps, 10 << 16, cuda)
    else:
        args = _window_case(W, taps, incs, kind, cuda)
    before = t_gen.resample_gen.launches
    got = t_gen.resample_gen(*args, W, taps)
    torch.cuda.synchronize()
    assert t_gen.resample_gen.launches == before + 1
    assert torch.equal(got, t_gen.resample_gen_ref(*args, W, taps))


@pytest.mark.parametrize("rate", [48000, 96000])
@pytest.mark.parametrize("crossfade", [False, True])
def test_reverb_kernel_within_bound_of_plain_version(cuda, rate, crossfade):
    eff, prm, st = chip_smoke.reverb_case(rate, crossfade, "cuda")
    st_plain = {k: (v.clone() if isinstance(v, torch.Tensor) else
                    {n: t.clone() for n, t in v.items()})
                for k, v in st.items()}
    windows = chip_smoke.reverb_windows(np.random.default_rng(rate), 1024,
                                        eff.chunk, cuda)
    got = chip_smoke.run_reverb_windows(eff, prm, st, windows, "kernel")
    want = chip_smoke.run_reverb_windows(eff, prm, st_plain, windows,
                                         "plain")
    torch.cuda.synchronize()
    assert max(float((a - b).abs().max()) for a, b in zip(got, want)) \
        <= chip_smoke.REVERB_TOL


@pytest.mark.parametrize("schedule", ["kernel", "in_order"])
@pytest.mark.parametrize("delay", [0.0, 0.1])
@pytest.mark.parametrize("rate", [44100, 48000, 96000])
def test_reverb_kernel_equals_plain_version_in_both_schedules(
        cuda, rate, delay, schedule):
    """Bit-equal over >= 64 chunks with the crossfade in flight: chunk k+1's
    early half beside chunk k's late half (the effect's late-tap bound
    allows it), and the in-order schedule the wrapper takes without one."""
    eff, prm, st = chip_smoke.reverb_case(rate, True, "cuda",
                                          late_reverb_delay=delay)
    st_plain = {k: (v.clone() if isinstance(v, torch.Tensor) else
                    {n: t.clone() for n, t in v.items()})
                for k, v in st.items()}
    windows = chip_smoke.reverb_windows(np.random.default_rng(rate), 1024,
                                        eff.chunk, cuda, min_chunks=64)
    before = t_rev.reverb_pipeline.launches
    got = chip_smoke.run_reverb_windows(eff, prm, st, windows, schedule)
    want = chip_smoke.run_reverb_windows(eff, prm, st_plain, windows,
                                         "plain")
    torch.cuda.synchronize()
    assert t_rev.reverb_pipeline.launches == before + 2 * len(windows)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    for name in ("A", "B"):
        for k, v in st[name].items():
            assert torch.equal(v, st_plain[name][k]), (name, k)


def test_loaded_scene_on_the_card_matches_the_cpu(cuda):
    g = chip_smoke.bench_scene(64, 64, "cuda", loaded=True)
    c = chip_smoke.bench_scene(64, 64, "cpu", loaded=True)
    before = (t_gen.resample_gen.launches, t_rev.reverb_pipeline.launches)
    for n in (8192, 4096, 100):
        assert np.abs(g.render_samples(n) - c.render_samples(n)).max() \
            <= chip_smoke.LOADED_TOL
    assert t_gen.resample_gen.launches > before[0]
    assert t_rev.reverb_pipeline.launches > before[1]


@pytest.mark.parametrize("counters", ["0", "256", "mixed"])
@pytest.mark.parametrize("V,T", [(100, 128), (256, 1024), (64, 16384)])
def test_biquad_kernel_equals_plain_version(cuda, V, T, counters):
    args = chip_smoke.biquad_case(np.random.default_rng(V + T), V, T,
                                  counters, cuda)
    before = t_biq.biquad_dual.launches
    got = t_biq.biquad_dual(*args)
    torch.cuda.synchronize()
    assert t_biq.biquad_dual.launches == before + 1
    for a, b in zip(got, t_biq.biquad_dual_ref(*args)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("P", [1, 2, 3])
@pytest.mark.parametrize("V,T", [(100, 32), (4097, 1024), (64, 16384)])
def test_biquad_paths_kernel_equals_plain_version(cuda, V, T, P):
    """P paths over one x with mixed active masks, state in place, over two
    calls; V not a multiple of the kernel's 16-line group."""
    rng = np.random.default_rng(V + T + P)
    x, st = chip_smoke.paths_case(rng, V, T, P, cuda)
    mine = tuple(t.clone() for t in st)
    before = t_biq.biquad_dual.launches
    for xin in (x, x.flip(1).contiguous()):
        got = t_biq.biquad_paths(xin, chip_smoke.as_paths(mine))
        want = t_biq.biquad_paths_ref(xin, chip_smoke.as_paths(st))
        torch.cuda.synchronize()
        assert torch.equal(got, want)
    assert t_biq.biquad_dual.launches == before + 2
    for a, b in zip(mine, st):
        assert torch.equal(a, b)


@pytest.mark.parametrize("T", [32, 1024])
@pytest.mark.parametrize("B", [3, 48])
def test_biquad_four_section_cascade_equals_plain_version(cuda, B, T):
    args = chip_smoke.allpass_case(np.random.default_rng(B + T), B, T, cuda)
    before = t_biq.biquad_dual.launches
    got = t_biq.biquad_dual(*args)
    torch.cuda.synchronize()
    assert t_biq.biquad_dual.launches == before + 1
    for a, b in zip(got, t_biq.biquad_dual_ref(*args)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("scene", list(chip_smoke.SPEAKER_SCENES))
def test_filtered_scene_on_the_card_matches_the_cpu(cuda, scene):
    g = chip_smoke.speaker_scene(scene, 64, "cuda")
    c = chip_smoke.speaker_scene(scene, 64, "cpu")
    before = t_biq.biquad_dual.launches
    for n in (8192, 4096, 100):
        assert np.abs(g.render_samples(n) - c.render_samples(n)).max() \
            <= chip_smoke.SPEAKERS_TOL
    assert t_biq.biquad_dual.launches > before


@pytest.mark.parametrize(
    "W,taps,incs,kind",
    [(W, taps, (ONE // 4, 10 * ONE), "span_case") for W in (128, 1152, 16512)
     for taps in (1, 4, 48)] + WINDOW_CASES)
def test_span_kernel_equals_plain_version(cuda, W, taps, incs, kind):
    """K4 at 0.25x-10x, with the branch cases and windows at the pool's
    end, including a partial last tile; then ragged widths, the largest
    window and loops of 1-3 frames."""
    if kind == "span_case":
        args = chip_smoke.span_case(np.random.default_rng(taps * W), 256, W,
                                    taps, incs, cuda)
    else:
        args = _window_case(W, taps, incs, kind, cuda)
    before = t_span.resample_span.launches
    got = t_span.resample_span(*args, W, taps)
    torch.cuda.synchronize()
    assert t_span.resample_span.launches == before + 1
    assert torch.equal(got, t_span.resample_span_ref(*args, W, taps))


@pytest.mark.parametrize(
    "W,taps,incs,kind",
    [(W, taps, (ONE // 4, top), "branches") for taps in (1, 4, 48)
     for W, top in ((1024, 10 * ONE), (16512, 42000))]
    + [c[1:] for c in chip_smoke.VOICE_CASES])
def test_voice_kernel_equals_plain_version(cuda, W, taps, incs, kind):
    """K5 up to its largest bucket (one block per voice through a row of
    16512 outputs), ragged widths, taps 48 at 10x and loops of 1-3
    frames."""
    args = _window_case(W, taps, incs, kind, cuda)
    before = t_voice.resample_voice.launches
    got = t_voice.resample_voice(*args, W, taps)
    torch.cuda.synchronize()
    assert t_voice.resample_voice.launches == before + 1
    assert torch.equal(got, t_voice.resample_voice_ref(*args, W, taps))


def test_voice_kernel_raises_past_its_window(cuda):
    args = chip_smoke.span_case(np.random.default_rng(0), 8, 16512, 4,
                                (ONE, 2 * ONE), cuda)
    with pytest.raises(ValueError, match="largest bucket"):
        t_voice.resample_voice(*args, 16512, 4)


@pytest.mark.parametrize("scene", list(chip_smoke.UHJ_PARITY))
def test_uhj_scene_on_the_card_matches_the_cpu(cuda, scene):
    kw = chip_smoke.UHJ_PARITY[scene]
    g, _ = chip_smoke.uhj_pool_scene("cuda", 64, **kw)
    c, _ = chip_smoke.uhj_pool_scene("cpu", 64, **kw)
    span = (t_span.resample_span.launches, t_gen.resample_gen.launches)
    for n in (8192, 4096, 100):
        assert np.abs(g.render_samples(n) - c.render_samples(n)).max() \
            <= chip_smoke.UHJ_TOL
    if scene == "uhj_pool98":
        assert t_span.resample_span.launches > span[0]
        assert t_gen.resample_gen.launches == span[1]
    else:
        assert t_gen.resample_gen.launches > span[1]


@pytest.mark.parametrize("T", [128, 1024, 16384])
@pytest.mark.parametrize("B", [1, 4, 9])
def test_effect_scan_equals_plain_version(cuda, B, T):
    """Each effect_scan entry bit-equal to its plain version, with state
    carried over two calls; the compressor on and off, the autowah's
    attack above and below its release, swept coefficients at the clamp
    of w0."""
    rng = np.random.default_rng(B * T)
    xs = [chip_smoke.scan_inputs(rng, B, T, cuda) for _ in range(2)]
    before = t_es.launches()
    cases = [("compressor_env", [x.abs().clamp(0.5, 2.0) for x in xs],
              torch.ones(B, device=cuda),
              torch.tensor([1.0003, 0.9998], device=cuda)),
             ("compressor_env", [torch.ones_like(x) for x in xs],
              torch.full((B,), 1.5, device=cuda),
              torch.tensor([1.0003, 0.9998], device=cuda))]
    for att, rel in ((0.9995, 0.995), (0.995, 0.9995)):
        cases.append(("autowah_env", xs, torch.zeros(B, device=cuda),
                      torch.tensor([1.3, att, rel], device=cuda)))
    for entry, ins, env, prm in cases:
        got = want = (None, env)
        for x in ins:
            got = getattr(t_es, entry)(x, got[1], prm)
            want = getattr(t_es, entry + "_ref")(x, want[1], prm)
            assert torch.equal(got[0], want[0]), entry
        assert torch.equal(got[1], want[1]), entry
    got = want = (None, torch.zeros((B, 2), device=cuda))
    for x in xs:
        env = t_es.autowah_env_ref(x[:1], torch.zeros(1, device=cuda),
                                   cases[-1][3])[0][0]
        cf = chip_smoke.swept_coeffs(env)
        got = t_es.swept_tdf2(x, cf, got[1])
        want = t_es.swept_tdf2_ref(x, cf, want[1])
        assert torch.equal(got[0], want[0])
    assert torch.equal(got[1], want[1])
    torch.cuda.synchronize()
    assert t_es.launches() == before + 2 * len(cases) + 2


def test_biquad_kernel_in_the_effects_shapes(cuda):
    """K7 as the equalizer (four constant sections) and as a one-section
    effect (an identity section beside it) calls it: bit-equal."""
    assert chip_smoke.check_biquad_effect_shapes(cuda) == 0.0


@pytest.mark.parametrize("engine", list(chip_smoke.FX_ENGINES))
def test_effect_engine_on_the_card_matches_the_cpu(cuda, engine):
    """An fx_rack of 64 voices with one engine's slot, card against CPU."""
    g = chip_smoke.fx_rack_scene(64, "cuda", 0, engines=(engine,),
                                 reverb=False, channels="stereo")
    c = chip_smoke.fx_rack_scene(64, "cpu", 0, engines=(engine,),
                                 reverb=False, channels="stereo")
    tol = (chip_smoke.FX_PSHIFT_TOL if engine == "pitch_shifter"
           else chip_smoke.FX_TOL)
    for n in (8192, 4096):
        assert np.abs(g.render_samples(n) - c.render_samples(n)).max() \
            <= tol
